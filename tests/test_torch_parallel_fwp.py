"""Serving over a mesh of ranks: spatially sharded ``generate`` and the
chunked ForwardPass with ``use_mesh=True`` (chunk fan-out) and
``use_mesh='spatial'`` (each chunk's s1 rows split over the ranks, halo
exchanges in every conv), on four spawned ranks of one gloo group
(``spawn_ranks``). The port of tests/forward_pass/test_spatial_sharded.py
(less its HLO parser test: the port counts its own exchanges), the mesh
cases of test_batched_fwp.py (:32, :119) and the spatial fallback of
tests/pipeline/test_auto_batch.py; the models are the JAX fixtures',
saved here and loaded by the ranks.

Bars: sharded ``generate`` (2 and 4 ranks) against the unsharded one and
the JAX package's at rtol 1e-5, atol 1e-5; the passes against the serial
pass (and the JAX package's) at atol 1e-4; fast mode at 2e-2 of the
largest magnitude; packed H5 files within 2 storage quanta of the host
files ('spatial'; 1 for the fan-out, as the JAX tests hold them); the
ranks' halo bytes against ``estimate_halo_bytes`` within the JAX test's
factor of 5.

Run as a script (``python tests/test_torch_parallel_fwp.py out_dir rank
world store``) this file is one rank: it imports torch and the port
only."""

import functools
import glob
import os
import sys

import numpy as np
import pytest
import torch

from sup3r_tpu_torch.configs import get_config
from sup3r_tpu_torch.models import Sup3rGan
from sup3r_tpu_torch.parallel import (
    get_mesh,
    halo_bytes_from_compiled,
    shard_spatial,
)
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from sup3r_tpu_torch.pipeline import memory
from sup3r_tpu_torch.utilities.test_helpers import (
    rank_results,
    run_rank_scenarios,
    spawn_ranks,
)

torch.set_num_threads(1)

WORLD = 4
FEATURES = ['u_100m', 'v_100m']
#: the sharded generate's chunk and the halo test's flagship input
CHUNK = np.random.default_rng(0).random((1, 16, 16, 4, 2)).astype(
    np.float32)
FLAGSHIP_LR = (1, 16, 8, 4, 2)


def _strategy(out, name, **kwargs):
    """A strategy over the input ``name`` with the port's model of the
    JAX fixture (the ranks' and the parent's passes share it)."""
    kw = dict(file_paths=os.path.join(out, f'{name}.nc'),
              model_kwargs={'model_dir': os.path.join(out, kwargs.pop(
                  'model', 'st')), 'device': 'cpu'},
              out_pattern=None)
    return ForwardPassStrategy(**{**kw, **kwargs})


#: the passes: (input, kwargs); the 'spatial' ones over 16-row chunks
PASSES = {
    'spatial': ('in16', dict(fwp_chunk_shape=(16, 16, 4), spatial_pad=0,
                             temporal_pad=0, device_batch_size=2,
                             use_mesh='spatial')),
    'spatial_fast': ('in16', dict(fwp_chunk_shape=(16, 16, 4),
                                  spatial_pad=0, temporal_pad=0,
                                  device_batch_size=2, use_mesh='spatial',
                                  inference_mode='fast')),
    'fanout': ('in12', dict(fwp_chunk_shape=(6, 6, 4), spatial_pad=1,
                            temporal_pad=1, device_batch_size=16,
                            use_mesh=True)),
    'auto': ('auto', dict(fwp_chunk_shape=(6, 6, 4), spatial_pad=1,
                          temporal_pad=1, device_batch_size='auto',
                          model='flagship')),
}
#: the packed-drain passes: (input, kwargs of the meshed pass, kwargs of
#: the host pass it is held to)
PACKED = {
    'spatial': ('in16', dict(fwp_chunk_shape=(16, 16, 4), spatial_pad=0,
                             temporal_pad=0),
                dict(device_batch_size=2, use_mesh='spatial'), {}),
    'fanout': ('in12', dict(fwp_chunk_shape=(6, 6, 4), spatial_pad=1,
                            temporal_pad=1),
               dict(device_batch_size=16, use_mesh=True),
               dict(device_batch_size=4)),
}


# ----------------------------------------------------------------------
# the rank scenarios
def _generate(rank, world, out):
    """Each rank's output block of the sharded chunk over 2 and 4 ranks:
    the reference-style ST model (fused reflect convs, expansions) and a
    model with 'same' convs and a topography ``Sup3rConcat`` (zero halo
    rows at the global edges, the raster's rows at its layer)."""
    res = {}
    for name in ('sp', 'exo'):
        model = Sup3rGan.load(os.path.join(out, name), device='cpu')
        exo = ({'topography': np.load(os.path.join(out, 'topo.npy'))}
               if name == 'exo' else None)
        for width in (2, 4):
            mesh = get_mesh(width, devices='cpu')
            if mesh is not None:
                res[(name, width)] = model.generate(
                    shard_spatial(mesh, CHUNK, dim=1), mesh=mesh,
                    exogenous_data=exo)
    mesh = get_mesh(devices='cpu')
    try:
        shard_spatial(mesh, np.zeros((1, 10, 16, 4, 2), np.float32), dim=1)
    except ValueError as e:
        res['divisible'] = str(e)
    return res


def _halo(rank, world, out):
    """The flagship's sharded generate over 4 ranks: this rank's halo
    bytes and exchanges."""
    model = Sup3rGan(get_config('spatiotemporal/gen_3x_4x_2f'),
                     get_config('spatiotemporal/disc_test'), device='cpu')
    model.init_weights(FLAGSHIP_LR, (1, 48, 24, 16, 2), seed=0)
    mesh = get_mesh(devices='cpu')
    block = shard_spatial(mesh, np.zeros(FLAGSHIP_LR, np.float32), dim=1)
    mesh.reset_counters()
    model.generate(block, norm_in=False, un_norm_out=False, mesh=mesh)
    return halo_bytes_from_compiled(mesh)


def _passes(rank, world, out):
    """The meshed passes to arrays: every rank returns every chunk. The
    'auto' pass runs with a 16 MB memory budget, so its padded chunk does
    not fit and it falls back to use_mesh='spatial'."""
    res = {}
    tiny = functools.partial(memory.resolve_device_batch_size,
                             hbm_bytes=16 * 2 ** 20)
    for name, (inp, kw) in PASSES.items():
        if name == 'auto':
            memory.resolve_device_batch_size, real = tiny, (
                memory.resolve_device_batch_size)
        try:
            strategy = _strategy(out, inp, **kw)
            res[name] = ForwardPass.run(strategy, 0)
        finally:
            if name == 'auto':
                memory.resolve_device_batch_size = real
        res[f'{name}_plan'] = (strategy.device_batch_size,
                               strategy.use_mesh)
    return res


def _packed(rank, world, out):
    """The meshed passes to H5 chunk files (the device-packed drain), each
    chunk written by its share's rank."""
    for name, (inp, common, meshed, _) in PACKED.items():
        ForwardPass.run(_strategy(
            out, inp, **common, **meshed, pack_output_on_device=True,
            out_pattern=os.path.join(out, f'{name}_mesh',
                                     'chunk_{file_id}.h5')), 0)
    return True


SCENARIOS = {'generate': _generate, 'halo': _halo, 'passes': _passes,
             'packed': _packed}


# ----------------------------------------------------------------------
# the JAX package's side, and the spawned ranks
@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """Save the JAX fixtures' models and inputs, run the ranks, and run
    the references: the port's and the JAX package's unsharded generate
    and serial passes."""
    from sup3r_tpu.configs import get_config as jax_config
    from sup3r_tpu.models import Sup3rGan as JaxGan
    from sup3r_tpu.pipeline import ForwardPass as JaxForwardPass
    from sup3r_tpu.pipeline import ForwardPassStrategy as JaxStrategy
    from sup3r_tpu.utilities.test_helpers import make_fake_nc_file
    from tests.forward_pass.test_batched_fwp import (
        _save_model,
        _st_gen_config,
    )
    from tests.forward_pass.test_spatial_sharded import _st_model

    out = tmp_path_factory.mktemp('fwp_ranks')
    for name, shape in (('in16', (16, 16, 8)), ('in12', (12, 12, 12)),
                        ('auto', (12, 12, 8))):
        make_fake_nc_file(str(out / f'{name}.nc'), shape, ['u100', 'v100'])
    os.rename(_save_model(str(out), _st_gen_config(), 3, 4)[0],
              str(out / 'st'))
    sp = _st_model()
    sp.save(str(out / 'sp'))
    exo = JaxGan(
        [{'class': 'Conv3D', 'filters': 8, 'kernel_size': 3, 'strides': 1,
          'padding': 'same'},
         {'class': 'SpatioTemporalExpansion', 'spatial_mult': 2},
         {'class': 'Sup3rConcat', 'name': 'topography'},
         {'class': 'Conv3D', 'filters': 2, 'kernel_size': 3, 'strides': 1,
          'padding': 'same'}],
        [{'class': 'Conv3D', 'filters': 4, 'kernel_size': 3, 'strides': 2,
          'padding': 'same'}, {'class': 'Flatten'},
         {'class': 'Dense', 'units': 1}])
    exo.meta.update(lr_features=FEATURES, hr_out_features=FEATURES,
                    hr_exo_features=['topography'])
    exo.set_norm_stats({f: 0.1 for f in FEATURES},
                       {f: 0.9 for f in FEATURES})
    exo.init_weights((1, 16, 16, 4, 2), (1, 32, 32, 4, 3))
    exo.save(str(out / 'exo'))
    topo = np.random.default_rng(5).random((1, 32, 32, 4, 1)).astype(
        np.float32)
    np.save(str(out / 'topo.npy'), topo)
    flag = JaxGan(jax_config('spatiotemporal/gen_3x_4x_2f'),
                  jax_config('spatiotemporal/disc_test'))
    flag.init_weights((1, 12, 12, 12, 2), (1, 36, 36, 48, 2))
    flag.meta.update(lr_features=FEATURES, hr_out_features=FEATURES,
                     input_resolution={'spatial': '12km',
                                       'temporal': '60min'})
    flag.set_norm_stats({f: 0.0 for f in FEATURES},
                        {f: 1.0 for f in FEATURES})
    flag.save(str(out / 'flagship'))

    spawn_ranks([sys.executable, os.path.abspath(__file__), str(out)],
                WORLD, str(out), timeout=300)

    refs = {}
    for name, jmodel in (('sp', sp), ('exo', exo)):
        kw = ({'exogenous_data': {'topography': topo}} if name == 'exo'
              else {})
        refs[('generate', name)] = (
            Sup3rGan.load(str(out / name), device='cpu').generate(CHUNK,
                                                                  **kw),
            np.asarray(jmodel.generate(CHUNK, **kw)))
    port = Sup3rGan(get_config('spatiotemporal/gen_3x_4x_2f'),
                    get_config('spatiotemporal/disc_test'), device='cpu')
    port.init_weights(FLAGSHIP_LR, (1, 48, 24, 16, 2), seed=0)
    refs['halo_estimate'] = memory.estimate_halo_bytes(
        port, FLAGSHIP_LR[1:], WORLD)
    jflag = JaxGan(jax_config('spatiotemporal/gen_3x_4x_2f'),
                   jax_config('spatiotemporal/disc_test'))
    jflag.init_weights(FLAGSHIP_LR, (1, 48, 24, 16, 2))
    from sup3r_tpu.pipeline.memory import estimate_halo_bytes

    refs['jax_halo_estimate'] = estimate_halo_bytes(jflag, FLAGSHIP_LR[1:],
                                                    WORLD)
    for name, (inp, kw) in PASSES.items():
        serial = {k: v for k, v in kw.items()
                  if k not in ('use_mesh', 'device_batch_size')}
        model = serial.pop('model', 'st')
        refs[('serial', name)] = ForwardPass.run(
            _strategy(out, inp, model=model, **serial), 0)
        jkw = dict(serial, file_paths=str(out / f'{inp}.nc'),
                   model_kwargs={'model_dir': str(out / model)},
                   out_pattern=None)
        refs[('jax', name)] = JaxForwardPass.run(JaxStrategy(**jkw), 0)
    for name, (inp, common, _, host) in PACKED.items():
        ForwardPass.run(_strategy(
            out, inp, **common, **host, pack_output_on_device=False,
            out_pattern=str(out / f'{name}_host' / 'chunk_{file_id}.h5')),
            0)
    return rank_results(str(out), WORLD), refs, out


def _result(ranks, name, rank):
    res = ranks[rank][name]
    assert not (isinstance(res, dict) and 'error' in res), res['error']
    return res


@pytest.mark.parametrize('width', [2, 4])
@pytest.mark.parametrize('name', ['sp', 'exo'])
def test_spatially_sharded_generate_matches(run, name, width):
    """One (1, 16, 16, 4, 2) chunk split along s1 over ``width`` ranks:
    the output blocks, stacked, equal the unsharded output (the port's
    and the JAX package's)."""
    ranks, refs, _ = run
    out = np.concatenate([_result(ranks, 'generate', r)[(name, width)]
                          for r in range(width)], axis=1)
    port, jax_out = refs[('generate', name)]
    assert out.shape == port.shape
    np.testing.assert_allclose(out, port, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, jax_out, rtol=1e-5, atol=1e-5)


def test_shard_spatial_divisibility_guard(run):
    ranks, _, _ = run
    for r in range(WORLD):
        assert 'not divisible' in _result(ranks, 'generate', r)['divisible']


def test_sp_halo_collectives_measured(run):
    """The flagship's sharded generate exchanges halo rows at every conv
    (each rank counts what it sends), and their bytes summed over the
    ranks are within the JAX test's factor of 5 of the estimate, which
    is the JAX package's."""
    ranks, refs, _ = run
    sent = [_result(ranks, 'halo', r) for r in range(WORLD)]
    assert all(ops > 0 for _, ops in sent)
    # the edge ranks exchange one way, the inner ones both
    assert sent[0][1] * 2 == sent[1][1] == sent[2][1]
    assert refs['halo_estimate'] == refs['jax_halo_estimate'] > 0
    ratio = sum(b for b, _ in sent) / refs['halo_estimate']
    assert 0.2 < ratio < 5, ratio


def _check_pass(ranks, refs, name, **tol):
    for r in range(WORLD):
        got = _result(ranks, 'passes', r)[name]
        for ref in (refs[('serial', name)], refs[('jax', name)]):
            assert sorted(got) == sorted(ref) and got
            for idx in ref:
                np.testing.assert_allclose(got[idx], ref[idx], **tol)


def test_fwp_use_mesh_spatial_matches_serial(run):
    ranks, refs, _ = run
    assert _result(ranks, 'passes', 0)['spatial_plan'] == (2, 'spatial')
    _check_pass(ranks, refs, 'spatial', rtol=0, atol=1e-4)


def test_fwp_use_mesh_spatial_fast_mode_matches_serial_fast(run):
    """Fast mode (the subpixel tail exchanges its pre-expansion cells;
    a bf16 body) over the ranks against the serial fast pass."""
    ranks, refs, _ = run
    serial = refs[('serial', 'spatial_fast')]
    for r in range(WORLD):
        got = _result(ranks, 'passes', r)['spatial_fast']
        assert sorted(got) == sorted(serial)
        for idx in serial:
            scale = np.abs(serial[idx]).max()
            np.testing.assert_allclose(got[idx], serial[idx],
                                       atol=2e-2 * scale)


def test_mesh_sharded_chunk_batch(run):
    """use_mesh=True over the 4 ranks (each its own chunks, in batches of
    16 / 4) matches the serial pass."""
    ranks, refs, _ = run
    assert _result(ranks, 'passes', 0)['fanout_plan'] == (16, True)
    _check_pass(ranks, refs, 'fanout', rtol=0, atol=1e-4)


def test_auto_tiny_budget_switches_to_spatial(run):
    """A budget too small for one padded chunk flips 'auto' to batch 1
    and use_mesh='spatial' over the ranks, with the serial pass's
    outputs."""
    ranks, refs, _ = run
    assert _result(ranks, 'passes', 0)['auto_plan'] == (1, 'spatial')
    _check_pass(ranks, refs, 'auto', rtol=1e-4, atol=1e-4)


def test_auto_tiny_budget_world_of_one_switches_to_spatial(run, monkeypatch,
                                                          caplog):
    """In a world of one rank the same budget plans (1, 'spatial'), as
    the JAX package switches over its one device
    (tests/pipeline/test_auto_batch.py:136), logs the switch, and gives
    the serial pass's outputs within 1e-4."""
    _, refs, out = run
    monkeypatch.setattr(memory, 'resolve_device_batch_size',
                        functools.partial(memory.resolve_device_batch_size,
                                          hbm_bytes=16 * 2 ** 20))
    inp, kw = PASSES['auto']
    strategy = _strategy(out, inp, **kw)
    with caplog.at_level('INFO', logger='sup3r_tpu_torch'):
        got = ForwardPass.run(strategy, 0)
    assert (strategy.device_batch_size, strategy.use_mesh) == (1, 'spatial')
    assert 'use_mesh="spatial" over 1 rank' in caplog.text
    for ref in (refs[('serial', 'auto')], refs[('jax', 'auto')]):
        assert sorted(got) == sorted(ref) and got
        for idx in ref:
            np.testing.assert_allclose(got[idx], ref[idx], rtol=1e-4,
                                       atol=1e-4)


def test_truthy_use_mesh_runs_as_true(run):
    """Any truthy ``use_mesh`` other than 'spatial' runs as True, as in
    the JAX package (sup3r_tpu/pipeline/forward_pass.py:513): a world of
    one's pass with ``use_mesh=1`` equals its ``True`` pass."""
    _, _, out = run
    inp, kw = PASSES['fanout']
    passes = {}
    for use_mesh in (True, 1):
        strategy = _strategy(out, inp, **dict(kw, use_mesh=use_mesh))
        fwp = ForwardPass(strategy, 0)
        assert fwp.mesh is not None and fwp.mesh.size == 1
        passes[use_mesh] = ForwardPass.run(strategy, 0)
    assert sorted(passes[1]) == sorted(passes[True]) and passes[True]
    for idx, want in passes[True].items():
        np.testing.assert_array_equal(passes[1][idx], want)


@pytest.mark.parametrize('name,quanta', [('spatial', 2), ('fanout', 1)])
def test_mesh_packed_drain_files(run, name, quanta):
    """The meshed passes' device-packed H5 files (each written by one
    rank) against the host-transform files of a single-process pass."""
    import h5py

    ranks, _, out = run
    for r in range(WORLD):
        assert _result(ranks, 'packed', r) is True
    host = sorted(glob.glob(str(out / f'{name}_host' / 'chunk_*.h5')))
    mesh = sorted(glob.glob(str(out / f'{name}_mesh' / 'chunk_*.h5')))
    assert len(host) == len(mesh) > 0
    for hf, mf in zip(host, mesh):
        assert os.path.basename(hf) == os.path.basename(mf)
        with h5py.File(hf) as fh, h5py.File(mf) as fm:
            assert set(fh) == set(fm)
            for k in fh:
                if k in ('meta', 'time_index'):
                    continue
                diff = np.abs(fh[k][:].astype(np.int64)
                              - fm[k][:].astype(np.int64))
                assert diff.max() <= quanta, (k, diff.max())


def test_layer_without_sharded_form_raises():
    """Under a spatial mesh a layer with no sharded form (here a
    transposed conv, and a reflect pad that is not fused with a conv)
    raises a ValueError naming itself and saying why."""
    mesh = get_mesh(devices='cpu')
    for gen, why in (
            ([{'class': 'Conv2DTranspose', 'filters': 2, 'kernel_size': 3,
               'strides': 2, 'padding': 'same'}], 'transposed conv'),
            ([{'class': 'FlexiblePadding',
               'paddings': [[0, 0], [1, 1], [1, 1], [0, 0]],
               'mode': 'REFLECT'}], 'pad of s1')):
        model = Sup3rGan(gen, [{'class': 'Flatten'},
                               {'class': 'Dense', 'units': 1}],
                         device='cpu')
        with pytest.raises(ValueError, match=why) as err:
            model.generate(np.zeros((1, 4, 4, 2), np.float32), mesh=mesh)
        assert gen[0]['class'] in str(err.value)


if __name__ == '__main__':
    run_rank_scenarios(SCENARIOS, *sys.argv[1:])
