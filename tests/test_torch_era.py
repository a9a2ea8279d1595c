"""The port's offline ERA5 tools (``sup3r_tpu_torch.utilities.
era_downloader``) against the JAX package's on the cases of
tests/utilities/test_era_processing.py: request building, variable
classification, ``write_nc4`` / ``process_file`` / ``make_yearly_file``,
the monthly and yearly routines through an injected fake CDS client, and
``run_qa``. Both packages make the same requests and write files with
equal datasets; each file reads back through the port's ``LoaderNC``
as the JAX package's does through its own. ``cdsapi`` is never
imported: without an injected client the downloader refuses."""

import hashlib
import json
import os
import threading

import h5py
import numpy as np
import pytest

import sup3r_tpu.utilities.era_downloader as jax_era
import sup3r_tpu_torch.utilities.era_downloader as port_era
from sup3r_tpu.preprocessing.loaders import LoaderNC as JaxLoaderNC
from sup3r_tpu.utilities.test_helpers import make_fake_nc4_file
from sup3r_tpu.utilities.utilities import RANDOM_GENERATOR
from sup3r_tpu_torch.preprocessing.loaders import LoaderNC
from tests.utilities.test_era_processing import FakeClient as _FakeClient

PACKAGES = (('port', port_era), ('jax', jax_era))
AREA = [40, -106, 39, -104]
_LOCK = threading.Lock()


class FakeClient(_FakeClient):
    """The JAX tests' fake CDS client, with the data of each file drawn
    from a seed that the request sets: the same request gives the same
    file in either package, whatever the order of the requests."""

    def retrieve(self, dataset, entry, out_file):
        blob = json.dumps([dataset, entry], sort_keys=True).encode()
        seed = int(hashlib.md5(blob).hexdigest()[:8], 16)
        with _LOCK:
            RANDOM_GENERATOR.bit_generator.state = np.random.default_rng(
                seed).bit_generator.state
            super().retrieve(dataset, entry, out_file)


def _assert_nc4_equal(got, want):
    """Equal datasets; each package's loader reads the same data."""
    with h5py.File(got, 'r') as fg, h5py.File(want, 'r') as fw:
        assert set(fg) == set(fw)
        for k in fw:
            np.testing.assert_array_equal(fg[k][:], fw[k][:], err_msg=k)
            for a in ('units', 'calendar'):
                if a in fw[k].attrs:
                    assert fg[k].attrs[a] == fw[k].attrs[a]
    port, jax = LoaderNC(got).data, JaxLoaderNC(want).data
    assert sorted(port.data_vars) == sorted(jax.data_vars)
    np.testing.assert_array_equal(port.lat_lon, jax.lat_lon)
    np.testing.assert_array_equal(np.asarray(port.time_index.values),
                                  np.asarray(jax.time_index.values))
    for name in jax.data_vars:
        np.testing.assert_array_equal(port[name], jax[name])


def test_geopotential_to_height():
    zg = np.array([9.80665e3, 0.0, 123.4])
    np.testing.assert_array_equal(port_era.geopotential_to_height(zg),
                                  jax_era.geopotential_to_height(zg))
    assert port_era.G0 == jax_era.G0


@pytest.mark.parametrize('args,kwargs', [
    ((['100m_u_component_of_wind'], 2023, 2, AREA),
     {'days': [1, 2, 3], 'product_type': 'reanalysis'}),
    ((['u_component_of_wind'], 2023, 2, AREA),
     {'levels': [900, 1000], 'level_type': 'pressure',
      'product_type': 'monthly_averaged_reanalysis'}),
    ((['2m_temperature'], 2024, 2, AREA), {}),
    ((['2m_temperature'], 2023, 7, AREA),
     {'product_type': 'ensemble_mean', 'hours': ['06:00']}),
])
def test_build_cds_request_matches_jax(args, kwargs):
    assert (port_era.build_cds_request(*args, **kwargs)
            == jax_era.build_cds_request(*args, **kwargs))


@pytest.mark.parametrize('product', [
    'reanalysis', 'monthly_averaged_reanalysis',
    'monthly_averaged_ensemble_members',
    'monthly_averaged_reanalysis_by_hour_of_day', 'ensemble_mean'])
def test_default_hours_matches_jax(product):
    assert port_era.default_hours(product) == jax_era.default_hours(product)


@pytest.mark.parametrize('variables,levels', [
    (['u', 'orog', 'zg'], [1000]), (['u_100m', 'temperature'], [900]),
    (['v', 'pressure_0m'], None), (['not_a_var'], None)])
def test_variable_split_matches_jax(variables, levels):
    dls = []
    for _, mod in PACKAGES:
        with pytest.warns() if 'not_a_var' in variables else (
                _no_warning()):
            dls.append(mod.EraDownloader(2023, 1, AREA,
                                         variables=variables,
                                         levels=levels))
    port, jax = dls
    assert port.sfc_file_variables == jax.sfc_file_variables
    assert port.level_file_variables == jax.level_file_variables


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_write_nc4_roundtrip_matches_jax(tmp_path):
    src = make_fake_nc4_file(str(tmp_path / 'src.nc'), (6, 5, 8),
                             ['u100', 'v100'], levels=None)
    outs = {}
    for name, mod in PACKAGES:
        loader = LoaderNC if name == 'port' else JaxLoaderNC
        outs[name] = str(tmp_path / f'{name}.nc')
        mod.write_nc4(outs[name], loader(src).data)
    _assert_nc4_equal(outs['port'], outs['jax'])


def test_write_nc4_with_levels(tmp_path):
    src = make_fake_nc4_file(str(tmp_path / 'lev.nc'), (4, 5, 3),
                             ['u', 'z'], levels=[900.0, 1000.0])
    outs = {}
    for name, mod in PACKAGES:
        loader = LoaderNC if name == 'port' else JaxLoaderNC
        outs[name] = str(tmp_path / f'{name}.nc')
        mod.write_nc4(outs[name], loader(src).data)
    _assert_nc4_equal(outs['port'], outs['jax'])


def test_process_file_matches_jax(tmp_path):
    src = make_fake_nc4_file(str(tmp_path / 'z.nc'), (5, 5, 4), ['z'])
    outs = {name: mod.EraDownloader.process_file(
        src, str(tmp_path / f'{name}.nc')) for name, mod in PACKAGES}
    _assert_nc4_equal(outs['port'], outs['jax'])
    proc = LoaderNC(outs['port']).data
    assert 'zg' in proc.data_vars and 'z' not in proc.data_vars
    np.testing.assert_allclose(proc['zg'], LoaderNC(src).data['z']
                               / port_era.G0, rtol=1e-6)


def test_make_yearly_file_matches_jax(tmp_path):
    p1 = make_fake_nc4_file(str(tmp_path / 'm01.nc'), (6, 5, 10),
                            ['u100'], start='2023-01-01')
    p2 = make_fake_nc4_file(str(tmp_path / 'm02.nc'), (6, 5, 10),
                            ['u100'], start='2023-01-01 10:00')
    outs = {name: mod.EraDownloader.make_yearly_file(
        [p1, p2], str(tmp_path / f'{name}.nc')) for name, mod in PACKAGES}
    _assert_nc4_equal(outs['port'], outs['jax'])
    assert LoaderNC(outs['port']).data.shape[2] == 20


def test_downloader_gated_without_client(tmp_path):
    dl = port_era.EraDownloader(2023, 1, AREA,
                                variables=['100m_u_component_of_wind'])
    with pytest.raises(ImportError, match='cdsapi'):
        dl.download_file('100m_u_component_of_wind',
                         str(tmp_path / 'nope.nc'))


def _monthly_both(tmp_path, **kwargs):
    """``get_monthly_file`` through each package with its own fake
    client; returns (files, clients)."""
    files, clients = {}, {}
    for name, mod in PACKAGES:
        d = tmp_path / name
        d.mkdir()
        clients[name] = FakeClient()
        dl = mod.EraDownloader(
            2023, 1, AREA, monthly_file_pattern=str(
                d / 'era5_{year}_{month}_{var}.nc'),
            client=clients[name], **kwargs)
        files[name] = dl.get_monthly_file()
        assert not os.path.exists(dl.surface_file)
        assert not os.path.exists(dl.level_file)
        dl.get_monthly_file()  # skips: no new request
    strip = [[(r[0], r[1]) for r in c.requests] for c in clients.values()]
    assert strip[0] == strip[1]
    _assert_nc4_equal(files['port'], files['jax'])
    return files, clients


def test_monthly_download_process_combine(tmp_path):
    files, clients = _monthly_both(
        tmp_path, days=[1, 2], levels=[900, 1000],
        variables=['u_100m', 'zg', 'orog'])
    assert len(clients['port'].requests) == 2
    dset = LoaderNC(files['port']).data
    assert {'u_100m', 'zg', 'topography'} <= set(dset.data_vars)


def test_monthly_means_product(tmp_path):
    files, _ = _monthly_both(
        tmp_path, levels=[900, 1000], variables=['u', 'zg'],
        product_type='monthly_averaged_reanalysis')
    dset = LoaderNC(files['port']).data
    assert len(dset.time_index) == 1
    assert {'u_10m', 'u_100m', 'zg'} <= set(dset.data_vars)


def test_corrupt_download_retried(tmp_path):
    client = FakeClient()
    dl = port_era.EraDownloader(
        2023, 1, AREA, days=[1], variables=['u_100m'],
        monthly_file_pattern=str(tmp_path / 'era5_{year}_{month}_{var}.nc'),
        client=client)
    with open(dl.surface_file, 'wb') as f:
        f.write(b'CORRUPT')
    dl.get_monthly_file()
    assert len(client.requests) == 1
    assert 'u_100m' in LoaderNC(dl.monthly_file).data.data_vars


def test_run_for_var_and_run_match_jax(tmp_path):
    outs = {}
    for name, mod in PACKAGES:
        d = tmp_path / name
        d.mkdir()
        client = FakeClient()
        kw = dict(monthly_file_pattern=str(
            d / 'era5_{year}_{month}_{var}.nc'),
            yearly_file_pattern=str(d / 'era5_{year}_{var}.nc'),
            days=[[1]] * 12, client=client)
        yearly = mod.EraDownloader.run_for_var(
            2023, AREA, variable='u_100m', max_workers=2, **kw)
        assert len(client.requests) == 12
        mod.EraDownloader.run_for_var(2023, AREA, variable='u_100m', **kw)
        assert len(client.requests) == 12
        outs[name] = (yearly, mod.EraDownloader.run(
            2023, AREA, variables=['u_100m', 'v_100m'],
            combine_all_files=True, **kw))
    for port_fp, jax_fp in zip(outs['port'], outs['jax']):
        _assert_nc4_equal(port_fp, jax_fp)
    ti = LoaderNC(outs['port'][0]).data.time_index
    assert len(ti) == 12 * 24
    assert sorted(set(ti.month)) == list(range(1, 13))
    assert {'u_100m', 'v_100m'} <= set(
        LoaderNC(outs['port'][1]).data.data_vars)


def test_run_qa_matches_jax(tmp_path):
    fp = make_fake_nc4_file(str(tmp_path / 'qa.nc'), (4, 5, 6), ['u100'])
    got = port_era.EraDownloader.run_qa(fp)
    want = jax_era.EraDownloader.run_qa(fp)
    assert got == want


def test_add_pressure_matches_jax(tmp_path):
    """A pressure-level file gains a 'pressure' variable (Pa) broadcast
    from its levels over the 4D variables' shape."""
    src = make_fake_nc4_file(str(tmp_path / 'lev.nc'), (4, 5, 3), ['u'],
                             levels=[900.0, 1000.0])
    port = port_era.EraDownloader._add_pressure(LoaderNC(src).data)
    jax = jax_era.EraDownloader._add_pressure(JaxLoaderNC(src).data)
    np.testing.assert_array_equal(port.data_vars['pressure'],
                                  jax.data_vars['pressure'])
    assert port.var_dims['pressure'] == tuple(jax.var_dims['pressure'])
    assert sorted(np.unique(port.data_vars['pressure'])) == [9e4, 1e5]
