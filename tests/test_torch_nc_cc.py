"""The GCM input handlers (``DataHandlerNCforCC`` and
``DataHandlerNCforCCwithPowerLaw``) in the port against the JAX
package's, eager and lazy, on the fixtures of
tests/forward_pass/test_fwp_input_handlers.py and
tests/data_handlers/test_lazy_cc.py: NSRDB clearsky regridded onto the
GCM grid (KDTree aggregation, daily means, the per-pixel rsds scale or a
given ``clearsky_scale`` raster / ``.npy`` path), the ``'%m.%d'`` day
mapping across leap years, the power-law hub-height wind and the Kelvin
features. Arrays are bit-equal to the JAX package's, lazy to eager; the
forward pass through ``input_handler_name='DataHandlerNCforCC'`` agrees
within 1e-4 of its largest magnitude."""

import warnings

import numpy as np
import pytest
import torch

from sup3r_tpu.pipeline import ForwardPass as JaxForwardPass
from sup3r_tpu.pipeline import ForwardPassStrategy as JaxStrategy
from sup3r_tpu.preprocessing import data_handlers as jdh
from sup3r_tpu.utilities.test_helpers import make_fake_nc_file
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from sup3r_tpu_torch.preprocessing import data_handlers as pdh
from sup3r_tpu_torch.preprocessing import (
    DataHandlerNCforCC,
    DataHandlerNCforCCwithPowerLaw,
    get_input_handler_class,
)
from sup3r_tpu_torch.utilities.times import date_range
from tests.forward_pass.test_fwp_input_handlers import _csr_model
from tests.solar_qa.test_solar_qa import _make_fake_nsrdb

torch.set_num_threads(1)

CS_FEATS = ['clearsky_ratio', 'clearsky_ghi', 'rsds']


@pytest.fixture
def gcm_and_nsrdb(tmp_path):
    gcm_fp = make_fake_nc_file(str(tmp_path / 'gcm.nc'), (6, 6, 4),
                               ['rsds', 'uas'], freq='D')
    nsrdb_fp = _make_fake_nsrdb(str(tmp_path / 'nsrdb.h5'), (10, 10, 48))
    return gcm_fp, nsrdb_fp


def _both(gcm_fp, cls=DataHandlerNCforCC, jax_cls=jdh.DataHandlerNCforCC,
          **kwargs):
    return cls(gcm_fp, **kwargs), jax_cls(gcm_fp, **kwargs)


def _full(h, feats):
    return h.data.sample((slice(None), slice(None), slice(None), feats))


@pytest.mark.parametrize('kwargs', [
    dict(nsrdb_agg=1), dict(nsrdb_agg=2), dict(nsrdb_agg=2,
                                               nsrdb_smoothing=1.0)])
def test_ncforcc_eager_matches_jax(gcm_and_nsrdb, kwargs):
    """The eager injection: regrid, per-pixel rsds scale, optional
    gaussian smoothing; and the derived clearsky_ratio."""
    gcm_fp, nsrdb_fp = gcm_and_nsrdb
    port, jax = _both(gcm_fp, features=CS_FEATS, nsrdb_source_fp=nsrdb_fp,
                      **kwargs)
    assert port.features == jax.features == CS_FEATS
    np.testing.assert_array_equal(_full(port, CS_FEATS),
                                  _full(jax, CS_FEATS))
    np.testing.assert_array_equal(port.get_clearsky_ghi(),
                                  jax.get_clearsky_ghi())


def test_ncforcc_lazy_clearsky_bit_parity(gcm_and_nsrdb):
    """Lazy: the per-pixel daily table and full-extent scale raster give
    the eager injection's windows and the JAX package's."""
    gcm_fp, nsrdb_fp = gcm_and_nsrdb
    kwargs = dict(features=CS_FEATS, nsrdb_source_fp=nsrdb_fp, nsrdb_agg=2)
    eager = DataHandlerNCforCC(gcm_fp, **kwargs)
    lazy, jax = _both(gcm_fp, mode='lazy', **kwargs)
    assert lazy.data.shape == eager.data.shape
    for idx in [
            (slice(0, 6), slice(0, 6), slice(0, 4), CS_FEATS),
            (slice(1, 4), slice(3, 6), slice(1, 3), ['clearsky_ratio']),
            (slice(4, 6), slice(0, 2), slice(0, 1), ['clearsky_ghi'])]:
        got = lazy.data.sample(idx)
        np.testing.assert_array_equal(got, eager.data.sample(idx))
        np.testing.assert_array_equal(got, jax.data.sample(idx))


def test_ncforcc_lazy_window_reads_no_regrid(gcm_and_nsrdb, monkeypatch):
    """Window reads index the precomputed table: neither the NSRDB loader
    nor the regrid runs per sampled window."""
    gcm_fp, nsrdb_fp = gcm_and_nsrdb
    lazy = DataHandlerNCforCC(gcm_fp, mode='lazy',
                              features=['clearsky_ratio'],
                              nsrdb_source_fp=nsrdb_fp, nsrdb_agg=2)

    def _boom(*a, **k):
        raise AssertionError('window read re-opened the NSRDB source')

    monkeypatch.setattr(pdh, 'LoaderH5', _boom)
    monkeypatch.setattr(pdh.DataHandlerNCforCC, '_regrid_clearsky',
                        staticmethod(_boom))
    out = lazy.data.sample(
        (slice(1, 4), slice(2, 5), slice(0, 2), ['clearsky_ratio']))
    assert np.isfinite(out).any()


@pytest.mark.parametrize('mode', ['eager', 'lazy'])
def test_ncforcc_scale_override(gcm_and_nsrdb, tmp_path, mode):
    """A precomputed clearsky_scale raster as an .npy path (the
    chunked_io artifact) or an array; a wrong-shaped raster fails."""
    gcm_fp, nsrdb_fp = gcm_and_nsrdb
    scale = np.linspace(0.5, 1.5, 36, dtype=np.float32).reshape(6, 6)
    fp = str(tmp_path / 'scale.npy')
    np.save(fp, scale)
    kwargs = dict(features=['clearsky_ghi'], nsrdb_source_fp=nsrdb_fp,
                  nsrdb_agg=1, mode=mode)
    idx = (slice(0, 6), slice(0, 6), slice(0, 4), ['clearsky_ghi'])
    port, jax = _both(gcm_fp, clearsky_scale=fp, **kwargs)
    got = port.data.sample(idx)
    np.testing.assert_array_equal(got, jax.data.sample(idx))
    np.testing.assert_array_equal(
        got, DataHandlerNCforCC(gcm_fp, clearsky_scale=scale,
                                **kwargs).data.sample(idx))
    bad = str(tmp_path / 'bad.npy')
    np.save(bad, np.ones((3, 3), np.float32))
    with pytest.raises(ValueError, match='clearsky_scale raster'):
        DataHandlerNCforCC(gcm_fp, clearsky_scale=bad, **kwargs)


@pytest.mark.parametrize('mode,scale', [('lazy', None), ('eager', 1.5)])
def test_ncforcc_refuses_smoothing_when_windowed(gcm_and_nsrdb, mode,
                                                 scale):
    """nsrdb_smoothing diverges at window borders: refused lazy, and
    eager with a chunked_io clearsky_scale, in both packages."""
    gcm_fp, nsrdb_fp = gcm_and_nsrdb
    for cls in (DataHandlerNCforCC, jdh.DataHandlerNCforCC):
        with pytest.raises(NotImplementedError, match='nsrdb_smoothing'):
            cls(gcm_fp, features=['clearsky_ratio'],
                nsrdb_source_fp=nsrdb_fp, nsrdb_smoothing=1.0,
                clearsky_scale=scale, mode=mode)


@pytest.mark.parametrize('nsrdb_year,gcm_start', [
    (2019, '2020-02-26'), (2020, '2019-02-26'), (2020, '2020-02-26'),
    (2019, '2019-12-29'), (2021, '2024-02-27')])
def test_gcm_day_rows_across_leap_years(nsrdb_year, gcm_start):
    """'%m.%d' keys: a GCM leap day against a non-leap NSRDB year takes
    the nearest calendar day, and days after February keep their
    calendar date whichever year is the leap year."""
    days = date_range(f'{nsrdb_year}-01-01', f'{nsrdb_year}-12-31',
                      np.timedelta64(1, 'D'))
    start = np.datetime64(gcm_start)
    gcm = date_range(start, start + np.timedelta64(7, 'D'),
                     np.timedelta64(6, 'h'))
    days_d = np.asarray(days).astype('datetime64[D]')
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        got = DataHandlerNCforCC._gcm_day_rows(days_d, gcm)
        want = jdh.DataHandlerNCforCC._gcm_day_rows(
            days_d, np.asarray(gcm).astype('datetime64[ns]'))
    np.testing.assert_array_equal(got, want)
    gcm_md = [str(t)[5:10] for t in np.asarray(gcm)]
    nsrdb_md = [str(d)[5:10] for d in days_d[got]]
    same = [g == n for g, n in zip(gcm_md, nsrdb_md)]
    assert all(s or g == '02-29' for s, g in zip(same, gcm_md))


@pytest.mark.parametrize('mode', ['eager', 'lazy'])
def test_power_law_and_kelvin_features(tmp_path, mode):
    """Hub-height u / v from uas / vas by the power law, and the
    temperatures the registry converts from Kelvin (tas, tasmax,
    ta_100m)."""
    gcm_fp = make_fake_nc_file(
        str(tmp_path / 'gcm.nc'), (6, 6, 8),
        ['uas', 'vas', 'tas', 'tasmax', 'ta_100m', 'hurs'])
    feats = ['u_100m', 'v_100m', 'u_200m', 'temperature_2m',
             'temperature_max_2m', 'temperature_100m',
             'relativehumidity_2m']
    port, jax = _both(gcm_fp, DataHandlerNCforCCwithPowerLaw,
                      jdh.DataHandlerNCforCCwithPowerLaw, features=feats,
                      mode=mode)
    np.testing.assert_array_equal(_full(port, feats), _full(jax, feats))
    eager = DataHandlerNCforCCwithPowerLaw(gcm_fp, features=feats)
    np.testing.assert_array_equal(_full(port, feats), _full(eager, feats))
    uas = _full(port, ['u_100m'])
    ref = DataHandlerNCforCC(gcm_fp, features=['uas'])
    np.testing.assert_allclose(uas, _full(ref, ['uas']) * 10 ** 0.2,
                               rtol=1e-6)


def test_get_input_handler_class_names_the_gcm_handlers():
    for name in ('DataHandlerNCforCC', 'DataHandlerNCforCCwithPowerLaw'):
        assert get_input_handler_class(name).__name__ == name
        assert get_input_handler_class(name).FEATURE_REGISTRY.keys() == \
            getattr(jdh, name).FEATURE_REGISTRY.keys()


@pytest.mark.parametrize('chunked_io', [False, True])
def test_fwp_nc_cc_input_handler(tmp_path, chunked_io):
    """The Sup3rCC GCM input path inside the strategy: GCM rsds and
    NSRDB clearsky regridded by input_handler_name='DataHandlerNCforCC',
    eager and chunked_io, against the JAX package's pass."""
    gcm_fp = make_fake_nc_file(str(tmp_path / 'gcm.nc'), (8, 8, 4),
                               ['rsds'], freq='D')
    nsrdb_fp = _make_fake_nsrdb(str(tmp_path / 'nsrdb.h5'), (12, 12, 96),
                                start='2023-01-01')
    mdir = _csr_model(tmp_path)
    kwargs = dict(file_paths=gcm_fp, model_class='Sup3rGan',
                  input_handler_name='DataHandlerNCforCC',
                  input_handler_kwargs={'nsrdb_source_fp': nsrdb_fp},
                  fwp_chunk_shape=(8, 8, 4), spatial_pad=0, temporal_pad=0,
                  chunked_io=chunked_io, out_pattern=None)
    port = ForwardPassStrategy(model_kwargs={'model_dir': mdir,
                                             'device': 'cpu'}, **kwargs)
    jax = JaxStrategy(model_kwargs={'model_dir': mdir}, **kwargs)
    if not chunked_io:
        assert 'clearsky_ratio' in port.input_handler.data.features
    got = next(iter(ForwardPass.run(port, 0).values()))
    want = next(iter(JaxForwardPass.run(jax, 0).values()))
    assert got.shape == (16, 16, 4, 1) and np.isfinite(got).all()
    tol = 1e-4 * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol
