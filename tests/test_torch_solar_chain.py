"""The slice as a whole: the port's Sup3rCC solar chain against the JAX
package's on the same inputs and weights.

- ``SolarMultiStepGan.generate``: a spatial clearsky-ratio group, a
  spatial wind group with topography (input channel and ``Sup3rConcat``
  layer) and a temporal ``SolarCC`` with its ``t_enhance`` overridden to
  24, all saved by the JAX package and loaded by the port; two and three
  days of input, so the reflect pad of the 8x output is as wide as its
  axis. Tolerance rtol 1e-4 of the output's largest magnitude.
- tests/forward_pass/test_sup3rcc_chain.py's fixture through both
  packages' ``ForwardPass`` to H5 chunk files (within one storage quantum
  of clearsky_ratio, 1e-4), then both packages' ``Solar.run_temporal_
  chunks`` on the same chunk files and fake NSRDB file (``ghi`` / ``dni``
  / ``dhi`` within one storage quantum, 1 W/m2).
- The preflight refuses a solar member with topography in both packages.
"""

import os
import shutil
import warnings

import h5py
import jax
import numpy as np
import pytest
import torch

from sup3r_tpu.configs import generator_cc_spatial, generator_cc_temporal
from sup3r_tpu.models import MultiStepGan as JaxChain
from sup3r_tpu.models import SolarCC as JaxSolarCC
from sup3r_tpu.models import SolarMultiStepGan as JaxSolarChain
from sup3r_tpu.models import Sup3rGan as JaxGan
from sup3r_tpu.pipeline import ForwardPass as JaxForwardPass
from sup3r_tpu.pipeline import ForwardPassStrategy as JaxStrategy
from sup3r_tpu.solar import Solar as JaxSolar
from sup3r_tpu.utilities.test_helpers import make_fake_nc_file
from sup3r_tpu_torch.models import (
    MultiStepGan,
    SolarCC,
    SolarMultiStepGan,
    chain_params_from_jax,
)
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from sup3r_tpu_torch.pipeline.memory import estimate_activation_bytes
from sup3r_tpu_torch.solar import Solar
from tests.forward_pass import test_sup3rcc_chain as cc_chain
from tests.solar_qa.test_solar_qa import _make_fake_nsrdb
from tests.test_torch_forward_pass import _compare_h5

torch.set_num_threads(1)

RTOL = 1e-4
WIND = ['u_10m', 'v_10m', 'u_100m', 'v_100m', 'temperature_2m',
        'relativehumidity_2m']
T_FEATURES = ['clearsky_ratio', 'u_100m', 'v_100m']
DISC = [{'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]


def _close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = RTOL * float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol, (err, tol)


def _stats(features, rng):
    return ({f: float(rng.normal()) for f in features},
            {f: float(0.5 + rng.random()) for f in features})


def _groups(root, solar_topography=False):
    """The three groups at 8 filters and 1 residual block, saved by the
    JAX package: {group: [directory]}."""
    rng = np.random.default_rng(0)
    res = {'spatial': '100km', 'temporal': '1440min'}
    s_feats = ['clearsky_ratio'] + (['topography'] if solar_topography
                                    else [])
    means, stds = _stats(s_feats, rng)
    solar = JaxGan(generator_cc_spatial(1, 5, filters=8, n_resblocks=1,
                                        with_topography=solar_topography),
                   DISC, meta={'lr_features': s_feats,
                               'hr_out_features': ['clearsky_ratio'],
                               's_enhance': 5, 't_enhance': 1,
                               'input_resolution': res},
                   means=means, stdevs=stds)
    solar.init_weights((1, 4, 4, len(s_feats)), (1, 20, 20, 1))
    means, stds = _stats([*WIND, 'topography'], rng)
    wind = JaxGan(generator_cc_spatial(6, 5, filters=8, n_resblocks=1),
                  DISC, meta={'lr_features': [*WIND, 'topography'],
                              'hr_out_features': list(WIND),
                              's_enhance': 5, 't_enhance': 1,
                              'input_resolution': res},
                  means=means, stdevs=stds)
    wind.init_weights((1, 4, 4, 7), (1, 20, 20, 6))
    means, stds = _stats(T_FEATURES, rng)
    temporal = JaxSolarCC(
        generator_cc_temporal(1, 8, 4, filters=8, n_resblocks=1,
                              chan_per_step=8),
        DISC, meta={'lr_features': list(T_FEATURES),
                    'hr_out_features': ['clearsky_ratio'],
                    's_enhance': 1, 't_enhance': 8, 'input_resolution': res},
        means=means, stdevs=stds)
    temporal.init_weights((1, 4, 4, 3, 3), (1, 4, 4, 24, 1))
    dirs = {}
    for name, model in (('solar', solar), ('wind', wind),
                        ('temporal', temporal)):
        dirs[name] = [str(root / name)]
        model.save(dirs[name][0])
    return dirs


def _inputs(t_lr):
    rng = np.random.default_rng(1)
    lr = np.concatenate([rng.random((t_lr, 4, 4, 1)),
                         rng.standard_normal((t_lr, 4, 4, 6))],
                        axis=-1).astype(np.float32)
    topo_lr = (rng.random((t_lr, 4, 4, 1)) * 1000).astype(np.float32)
    topo_hr = (rng.random((t_lr, 20, 20, 1)) * 1000).astype(np.float32)
    exo = {'topography': {'steps': [
        {'model': 0, 'combine_type': 'input', 'data': topo_lr},
        {'model': 0, 'combine_type': 'layer', 'data': topo_hr}]}}
    return lr, exo


@pytest.fixture(scope='module')
def groups(tmp_path_factory):
    return _groups(tmp_path_factory.mktemp('solar_chain'))


def _load_both(dirs, **kwargs):
    kw = dict(spatial_solar_model_dirs=dirs['solar'],
              spatial_wind_model_dirs=dirs['wind'],
              temporal_solar_model_dirs=dirs['temporal'], t_enhance=24)
    return (JaxSolarChain.load(**kw),
            SolarMultiStepGan.load(**kw, device='cpu', **kwargs))


@pytest.mark.parametrize('t_lr', [2, 3])
def test_solar_chain_generate_matches_jax(groups, t_lr):
    """The 8x temporal output (16 and 24 hours) reflected by 16 and 24
    hours a side to 24 a day: a pad as wide as the axis."""
    jchain, chain = _load_both(groups)
    assert [type(m).__name__ for m in chain.models] == ['Sup3rGan',
                                                        'SolarCC']
    assert chain.t_enhance == 24 and chain.s_enhance == 5
    assert chain.lr_features == ['clearsky_ratio', *WIND, 'topography']
    assert chain.idf_wind.tolist() == list(range(1, 7))
    assert chain.idf_solar.tolist() == [0]
    assert chain.idf_wind_out.tolist() == [2, 3]
    assert chain.idf_wind_out.tolist() == jchain.idf_wind_out.tolist()
    lr, exo = _inputs(t_lr)
    want = np.asarray(jchain.generate(lr, exogenous_data=exo))
    got = chain.generate(lr, exogenous_data=_inputs(t_lr)[1])
    assert isinstance(got, np.ndarray)
    assert got.shape == (1, 20, 20, 24 * t_lr, 1)
    _close(got, want)


def test_solar_chain_params_from_jax(groups):
    """Fresh port members take the JAX groups' weights group by group."""
    jchain, chain = _load_both(groups)
    for member in chain.models + chain.spatial_solar_models.models:
        for p in member.generator.parameters():
            torch.nn.init.zeros_(p)
    chain_params_from_jax(chain, [
        [jax.tree.map(np.asarray, m.gen_params) for m in g.models]
        for g in (jchain.spatial_solar_models, jchain.spatial_wind_models,
                  jchain.temporal_solar_models)])
    lr, exo = _inputs(2)
    _close(chain.generate(lr, exogenous_data=exo),
           np.asarray(jchain.generate(lr, exogenous_data=_inputs(2)[1])))
    with pytest.raises(ValueError, match='groups'):
        chain_params_from_jax(chain, [[None]])


def test_solar_chain_inference_mode_reaches_every_group(groups):
    _, chain = _load_both(groups)
    chain.inference_mode = 'fast'
    assert chain.spatial_solar_models.models[0].inference_mode == 'fast'
    assert chain.inference_mode == 'fast'
    chain.spatial_solar_models.models[0].inference_mode = 'exact'
    assert chain.inference_mode == 'custom'


def test_solar_chain_footprint_counts_every_group(groups):
    """The planner's estimate covers the solar group, which the chain's
    ``models`` leave out, and the intermediates beside the temporal
    group."""
    _, chain = _load_both(groups)
    shape = (6, 6, 2, 7)
    total = estimate_activation_bytes(chain, shape)
    wind_alone = estimate_activation_bytes(
        MultiStepGan(chain.spatial_wind_models.models), (6, 6, 2, 6))
    temporal = estimate_activation_bytes(
        chain.temporal_solar_models, (30, 30, 2, 3))
    resident = 4 * 30 * 30 * 2 * (6 + 1 + 3)
    assert total >= temporal + resident > wind_alone


def test_preflight_refuses_solar_member_with_topography(tmp_path):
    """The solar group takes clearsky_ratio alone (it gets no exo), so
    the JAX package's own gen_solar_5x_1x_1f, with topography through a
    Sup3rConcat, cannot be its member; the port refuses it too."""
    dirs = _groups(tmp_path, solar_topography=True)
    kw = dict(spatial_solar_model_dirs=dirs['solar'],
              spatial_wind_model_dirs=dirs['wind'],
              temporal_solar_model_dirs=dirs['temporal'])
    with pytest.raises(AssertionError, match='only clearsky_ratio'):
        JaxSolarChain.load(**kw)
    with pytest.raises(AssertionError, match='only clearsky_ratio'):
        SolarMultiStepGan.load(**kw, device='cpu')


@pytest.fixture(scope='module')
def cc_files(tmp_path_factory):
    """tests/forward_pass/test_sup3rcc_chain.py's fixture through both
    packages' ForwardPass: (root, port chunk dir, JAX chunk dir)."""
    root = tmp_path_factory.mktemp('sup3rcc')
    input_file = make_fake_nc_file(
        str(root / 'gcm.nc'), (8, 8, 2),
        ['clearsky_ratio', 'u_200m', 'v_200m'], freq='D',
        start='2050-06-01')
    kwargs = {
        'spatial_solar_model_dirs': cc_chain._spatial_gan(
            root, 'ssm', ['clearsky_ratio'], 1),
        'spatial_wind_model_dirs': cc_chain._spatial_gan(
            root, 'swm', ['u_200m', 'v_200m'], 2),
        'temporal_solar_model_dirs': cc_chain._temporal_solar_gan(root)}
    for name, Strategy, Fwp, extra in (
            ('port', ForwardPassStrategy, ForwardPass, {'device': 'cpu'}),
            ('jax', JaxStrategy, JaxForwardPass, {})):
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            strategy = Strategy(
                file_paths=input_file, model_class='SolarMultiStepGan',
                model_kwargs={**kwargs, **extra}, fwp_chunk_shape=(8, 8, 1),
                spatial_pad=0, temporal_pad=0,
                out_pattern=str(root / name / 'sup3r_chunk_{file_id}.h5'))
            assert strategy.s_enhance == 2 and strategy.t_enhance == 24
            assert strategy.fwp_slicer.n_chunks == 2
            Fwp.run(strategy, 0)
    return root, root / 'port', root / 'jax'


def test_sup3rcc_chain_forward_pass_matches_jax(cc_files):
    _, port_dir, jax_dir = cc_files
    assert sorted(os.listdir(port_dir)) == [
        'sup3r_chunk_000000_000000.h5', 'sup3r_chunk_000001_000000.h5']
    with h5py.File(port_dir / 'sup3r_chunk_000000_000000.h5') as f:
        assert f['clearsky_ratio'].shape == (24, 256)
    _compare_h5(port_dir, jax_dir)


def test_sup3rcc_solar_module_matches_jax(cc_files):
    """Both packages' Solar on the JAX package's chunk files."""
    root, _, jax_dir = cc_files
    nsrdb_fp = _make_fake_nsrdb(str(root / 'nsrdb.h5'), (20, 20, 96),
                                start='2050-06-01')
    written = {}
    for name, cls in (('port', Solar), ('jax', JaxSolar)):
        out_dir = root / f'solar_{name}'
        shutil.copytree(jax_dir, out_dir)
        written[name] = cls.run_temporal_chunks(
            str(out_dir / 'sup3r_chunk_*.h5'), nsrdb_fp, tz=-6)
    assert [os.path.basename(f) for f in written['port']] == [
        os.path.basename(f) for f in written['jax']]
    assert len(written['port']) == 2
    for fp_port, fp_jax in zip(written['port'], written['jax']):
        with h5py.File(fp_port) as fp, h5py.File(fp_jax) as fj:
            assert set(fp) == set(fj) == {'meta', 'time_index', 'ghi',
                                          'dni', 'dhi'}
            np.testing.assert_array_equal(fp['meta'][:], fj['meta'][:])
            np.testing.assert_array_equal(fp['time_index'][:],
                                          fj['time_index'][:])
            for var in ('ghi', 'dni', 'dhi'):
                got, want = fp[var][:], fj[var][:]
                assert got.dtype == want.dtype and got.shape == (24, 256)
                diff = got.astype(np.int64) - want.astype(np.int64)
                assert np.abs(diff).max() <= 1, var
                np.testing.assert_equal(dict(fp[var].attrs),
                                        dict(fj[var].attrs))
            assert fp['ghi'][:].max() > 0


def test_solar_cc_member_of_port_chain_loads_as_solar_cc(groups, tmp_path):
    """The port's MultiStepGan.load dispatches on meta['class'] to
    SolarCC, and a port save reloads in the JAX package as SolarCC."""
    chain = MultiStepGan.load(groups['temporal'], device='cpu')
    assert type(chain.models[0]) is SolarCC
    chain.models[0].save(str(tmp_path / 'tsm'))
    assert type(JaxChain.load([str(tmp_path / 'tsm')]).models[0]) is \
        JaxSolarCC
