"""Spatially sharded serving takes the small kernel's route the JAX
package takes: below the shard-aligned gate (a spatial mesh under 4
ranks wide, ``ops.conv_ad.shard_aligned_worthwhile``) each fused block
the ``small_reflect_conv`` kernel takes gathers its input over the ranks
(``SpatialShard.gather``) and runs the kernel's wrapper on the whole
tensor, as XLA gathers a ``pallas_call``'s operands; with
``inference_shard_aligned`` set (the ForwardPass sets it on meshes 4 or
more wide, the strategy resets it) every block exchanges halo rows, as
the JAX package's shard-aligned route bypasses Pallas.

Two groups of spawned gloo ranks (2 and 4, ``spawn_ranks``) run
``generate(mesh=)`` and the chunked ForwardPass with
``use_mesh='spatial'``, counting the gathers and the wrapper's calls
with hooks. The model is the JAX forward-pass fixture's spatiotemporal
generator (its 2 -> 8 head and 8 -> 2 tail are small-kernel blocks).

Bars: ``generate`` against the unsharded port and JAX outputs at rtol
1e-5, atol 1e-5 (tests/test_torch_parallel_fwp.py's); the passes against
the serial pass and the JAX package's spatially sharded pass (8 forced
CPU devices, in process) at atol 1e-4.

Run as a script (``python tests/test_torch_sharded_serving.py out_dir
rank world store``) this file is one rank: it imports torch and the port
only."""

import os
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from sup3r_tpu_torch.models import Sup3rGan
from sup3r_tpu_torch.models import fuse as fuse_mod
from sup3r_tpu_torch.models import gan as gan_mod
from sup3r_tpu_torch.models.fuse import FusedReflectConv
from sup3r_tpu_torch.parallel import get_mesh, shard_spatial
from sup3r_tpu_torch.parallel.mesh import SpatialShard
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from sup3r_tpu_torch.utilities.test_helpers import (
    rank_results,
    run_rank_scenarios,
    spawn_ranks,
)

torch.set_num_threads(1)

WORLDS = (2, 4)
CHUNK = np.random.default_rng(0).random((1, 16, 16, 4, 2)).astype(
    np.float32)
#: the pass: one (16, 16, 8) NetCDF input in two chunks, one dispatch
PASS_KW = dict(fwp_chunk_shape=(16, 16, 4), spatial_pad=0, temporal_pad=0,
               device_batch_size=2)


def _strategy(out, **kwargs):
    return ForwardPassStrategy(
        file_paths=os.path.join(out, 'in16.nc'),
        model_kwargs={'model_dir': os.path.join(out, 'st'), 'device': 'cpu'},
        out_pattern=None, **PASS_KW, **kwargs)


class _Hooks:
    """Count ``SpatialShard.gather`` calls and the small kernel's wrapper
    calls (as ``models.fuse`` makes them) while installed."""

    def __init__(self):
        self.counts = Counter()
        self._saved = (SpatialShard.gather, fuse_mod.small_reflect_conv_cf)

    def __enter__(self):
        gather, small = self._saved
        counts = self.counts

        def counted_gather(shard, *args, **kwargs):
            counts['gather'] += 1
            return gather(shard, *args, **kwargs)

        def counted_small(*args, **kwargs):
            counts['small'] += 1
            return small(*args, **kwargs)

        SpatialShard.gather = counted_gather
        fuse_mod.small_reflect_conv_cf = counted_small
        return self

    def __exit__(self, *exc):
        SpatialShard.gather, fuse_mod.small_reflect_conv_cf = self._saved


class _NoGatherShard(SpatialShard):
    """A copy of the serving shard that ignores ``gather_small``: what
    ``generate`` built before the small kernel's route was restored."""

    def __init__(self, mesh, axis=None, gather_small=False):
        super().__init__(mesh, axis)


# ----------------------------------------------------------------------
# the rank scenarios
def _generate(rank, world, out):
    """Each rank's output block of the sharded chunk over each width the
    world holds, with ``inference_shard_aligned`` off and on, and once
    (width 2, off) through a ``generate`` whose shard ignores
    ``gather_small``; with the hooks' counts."""
    model = Sup3rGan.load(os.path.join(out, 'st'), device='cpu')
    res = {}
    for width in (w for w in WORLDS if w <= world):
        mesh = get_mesh(width, devices='cpu')
        cases = [(False, False), (True, False)]
        if width == 2:
            cases.append((False, True))
        for aligned, mutant in cases:
            if mesh is None:
                continue
            model.inference_shard_aligned = aligned
            saved = gan_mod.SpatialShard
            if mutant:
                gan_mod.SpatialShard = _NoGatherShard
            try:
                with _Hooks() as hooks:
                    block = model.generate(shard_spatial(mesh, CHUNK, dim=1),
                                           mesh=mesh)
            finally:
                gan_mod.SpatialShard = saved
            res[(width, aligned, mutant)] = (block, dict(hooks.counts))
    return res


class _FlagPass(ForwardPass):
    """A ForwardPass that keeps the flag its spatial dispatch left on the
    model (the strategy resets it when it hands the model out again)."""

    aligned = None

    def _generate_spatial(self, *args, **kwargs):
        out = super()._generate_spatial(*args, **kwargs)
        _FlagPass.aligned = self.model.inference_shard_aligned
        return out


def _pass(rank, world, out):
    """The spatial pass over the whole world: every chunk's output, the
    hooks' counts and the model's flag after the dispatch."""
    with _Hooks() as hooks:
        outputs = _FlagPass.run(_strategy(out, use_mesh='spatial'), 0)
    return {'outputs': outputs, 'counts': dict(hooks.counts),
            'aligned': _FlagPass.aligned}


SCENARIOS = {'generate': _generate, 'pass': _pass}


# ----------------------------------------------------------------------
# the JAX package's side, and the spawned ranks
@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """Save the JAX fixture's model and input, run both rank groups, and
    the references: the port's and the JAX package's unsharded generate,
    the port's serial pass and the JAX package's spatially sharded pass
    over its 8 CPU devices."""
    from sup3r_tpu.pipeline import ForwardPass as JaxForwardPass
    from sup3r_tpu.pipeline import ForwardPassStrategy as JaxStrategy
    from sup3r_tpu.utilities.test_helpers import make_fake_nc_file
    from tests.forward_pass.test_forward_pass import (
        _save_model,
        _st_gen_config,
    )

    out = tmp_path_factory.mktemp('sharded_serving')
    make_fake_nc_file(str(out / 'in16.nc'), (16, 16, 8), ['u100', 'v100'])
    model_dir, jmodel = _save_model(str(out), _st_gen_config(), 3, 4)
    os.rename(model_dir, str(out / 'st'))
    ranks = {}
    for world in WORLDS:
        d = out / f'world{world}'
        d.mkdir()
        os.symlink(str(out / 'st'), str(d / 'st'))
        os.symlink(str(out / 'in16.nc'), str(d / 'in16.nc'))
        spawn_ranks([sys.executable, os.path.abspath(__file__), str(d)],
                    world, str(d), timeout=300)
        ranks[world] = rank_results(str(d), world)
    port = Sup3rGan.load(str(out / 'st'), device='cpu')
    refs = {
        'generate': (port.generate(CHUNK), np.asarray(jmodel.generate(CHUNK))),
        'serial': ForwardPass.run(_strategy(str(out)), 0),
        'jax_spatial': JaxForwardPass.run(JaxStrategy(
            file_paths=str(out / 'in16.nc'),
            model_kwargs={'model_dir': str(out / 'st')}, out_pattern=None,
            use_mesh='spatial', **PASS_KW), 0),
        'n_small': sum(
            isinstance(lyr, FusedReflectConv)
            and lyr.route(torch.zeros(1, lyr.weight.shape[1], 2, 2, 2),
                          {}) == 'small'
            for lyr in port._get_fused_apply().layers),
    }
    return ranks, refs, out


def _result(ranks, world, name, rank):
    res = ranks[world][rank][name]
    assert not (isinstance(res, dict) and 'error' in res), res['error']
    return res


def _gathered_route(counts, n_small):
    """Whether one sharded ``generate`` took the JAX package's route below
    the gate: every small-kernel block gathered, then the wrapper."""
    return counts == {'gather': n_small, 'small': n_small}


def test_fixture_has_small_kernel_blocks(run):
    _, refs, _ = run
    assert refs['n_small'] == 2


@pytest.mark.parametrize('world', WORLDS)
def test_below_gate_tail_gathers_to_the_kernel(run, world):
    """At sp 2 (in a world of 2 and of 4) every rank of the mesh gathers
    each small-kernel block's input and calls the kernel's wrapper on it,
    once a block; its output block equals the unsharded generate."""
    ranks, refs, _ = run
    blocks = []
    for r in range(2):
        block, counts = _result(ranks, world, 'generate', r)[(2, False,
                                                              False)]
        assert _gathered_route(counts, refs['n_small']), counts
        blocks.append(block)
    out = np.concatenate(blocks, axis=1)
    for ref in refs['generate']:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_generate_without_gather_small_fails_the_route_test(run):
    """The route test catches a ``generate`` whose shard ignores
    ``gather_small``: its blocks exchange halo rows, no gather runs and
    the wrapper is never called (the output still agrees)."""
    ranks, refs, _ = run
    for r in range(2):
        block, counts = _result(ranks, 2, 'generate', r)[(2, False, True)]
        assert not _gathered_route(counts, refs['n_small'])
        assert counts.get('gather', 0) == counts.get('small', 0) == 0


@pytest.mark.parametrize('width,aligned', [(2, True), (4, True)])
def test_shard_aligned_flag_keeps_every_block_on_halos(run, width, aligned):
    """With ``inference_shard_aligned`` set no block gathers, at sp 2 and
    sp 4, and the output still equals the unsharded generate."""
    ranks, refs, _ = run
    blocks = []
    for r in range(width):
        block, counts = _result(ranks, 4, 'generate', r)[(width, aligned,
                                                          False)]
        assert counts.get('gather', 0) == counts.get('small', 0) == 0
        blocks.append(block)
    out = np.concatenate(blocks, axis=1)
    np.testing.assert_allclose(out, refs['generate'][0], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('world', WORLDS)
def test_spatial_pass_route_and_flag(run, world):
    """The ForwardPass sets ``inference_shard_aligned`` on a mesh of 4
    ranks and not of 2; below the gate each rank gathers each small
    block's input once per dispatch (one dispatch here), at the gate
    none."""
    ranks, refs, _ = run
    n = refs['n_small']
    for r in range(world):
        res = _result(ranks, world, 'pass', r)
        assert res['aligned'] is (world >= 4)
        want = {'gather': n, 'small': n} if world < 4 else {}
        assert res['counts'] == want, res['counts']


@pytest.mark.parametrize('world', WORLDS)
def test_spatial_pass_matches_serial_and_jax(run, world):
    """Every rank's collected outputs against the serial pass and the JAX
    package's spatially sharded pass over 8 devices (atol 1e-4)."""
    ranks, refs, _ = run
    for r in range(world):
        got = _result(ranks, world, 'pass', r)['outputs']
        for ref in (refs['serial'], refs['jax_spatial']):
            assert sorted(got) == sorted(ref) and got
            for idx in ref:
                np.testing.assert_allclose(got[idx], ref[idx], rtol=0,
                                           atol=1e-4)


def test_strategy_resets_the_flag_on_a_cached_model(run):
    """The strategy hands out its cached model with the flag reset, as
    the JAX package's does after a spatial pass set it."""
    _, _, out = run
    strategy = _strategy(str(out))
    model = strategy.get_model()
    model.inference_shard_aligned = True
    again = _strategy(str(out)).get_model()
    assert again is model
    assert again.inference_shard_aligned is False


if __name__ == '__main__':
    run_rank_scenarios(SCENARIOS, *sys.argv[1:])
