"""dp x sp training of the port on a 2D mesh of ranks
(``Sup3rGan.attach_mesh(get_mesh_2d(dp, sp))``): each rank holds its
rows of the batch and its block of each sample's s1 rows, the networks
run on the block with differentiable halo exchanges and row
redistributions, and the step is the single-device step on the global
batch. Eight spawned ranks of one gloo group (``spawn_ranks``) run the
scenarios below; the tests hold them to the JAX package's single-device
step on the same numpy inputs and weights (saved here, loaded by the
ranks), or to the port's single-device step where torch draws the
random numbers. The port of tests/training/test_parallel_train.py:196
and :273, tests/forward_pass/test_shard_aligned_conv.py:155 (a halo
count: there is no compiled program to parse) and
tests/training/test_wide_mesh.py:164 at 8 ranks (dp 2 x sp 4; its 16-
and 32-rank widths are not ported: 16 or 32 rank processes on the test
machine's cores would take minutes).

The models are narrow copies of the flagship pair: the
``gen_3x_4x_2f`` layout at 8 filters and one residual block (fused
reflect blocks, temporal and spatial expansions, skips) and the
``disc_test`` pyramid (k3 'same' convs, strides 1 and 2, then Flatten
and a Dense head) at small widths. At HR s1 = 36 and sp 4 a rank holds 9
rows, which the first stride-2 conv halves into blocks of 5, 5, 4 and 4
rows, and the last into 1, 1, 1 and 0.

Beyond the flagship pair: a generator with a topography layer (its HR
block's raster rows), the 'valid' pyramid of ``spatiotemporal/disc``
(every conv redistributes rows), a pair with Dropout, and every shipped
network's sharded forms on a 1 x 1 mesh in this process.

The traps each test pins:

- gradient accounting: every reduced gradient held to the JAX package's
  single-device gradient (``jax.grad`` of its losses), and a step with
  the head's gradients summed over all ranks (a doubled reduction)
  shown to fail that bar;
- the halo exchange's transpose: every parameter's gradient, and the
  input gradients at the block-edge rows, against the JAX package's;
- the HR tail's route: below the shard-aligned gate it gathers its
  input and takes the small kernel's wrapper, at the gate it exchanges
  halo rows;
- uneven blocks after stride-2 convs, and a rank with no rows;
- reflect rows at the global edges only;
- one collective order on every rank, in the calling thread.

Bars: losses and updated params at rtol 2e-4, atol 1e-6 (the JAX test's
bar; Adam with epsilon 1, ROADMAP "Adam amplifies rounding"); reduced
gradients and input gradients within 1e-5 of each network's largest
gradient; the exchanged bytes equal to
``utilities.test_helpers.expected_exchange_bytes``.

Run as a script (``python tests/test_torch_parallel_2d.py out_dir rank
world store``) this file is one rank: it imports torch and the port
only."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from sup3r_tpu_torch.configs import generator_st
from sup3r_tpu_torch.models import Sup3rGan, Sup3rGanWithObs, fuse
from sup3r_tpu_torch.models.weights import params_to_jax
from sup3r_tpu_torch.ops import conv_ad
from sup3r_tpu_torch.parallel import (
    get_mesh,
    get_mesh_2d,
    shard_batch,
    shard_batch_spatial,
    shard_spatial,
)
from sup3r_tpu_torch.parallel import mesh as mesh_module
from sup3r_tpu_torch.preprocessing import BatchHandler
from sup3r_tpu_torch.utilities import RANDOM_GENERATOR, exact_fp32
from sup3r_tpu_torch.utilities.test_helpers import (
    expected_exchange_bytes,
    make_fake_dset,
    rank_results,
    run_rank_scenarios,
    spawn_ranks,
)

torch.set_num_threads(1)

WORLD = 8
OPT = {'name': 'Adam', 'learning_rate': 1e-3, 'epsilon': 1.0}
FEATURES = ['u_100m', 'v_100m']
RES = {'spatial': '30km', 'temporal': '60min'}
MESHES = [(2, 2), (1, 4)]
GATES = {'both': (True, True), 'gen': (True, False), 'disc': (False, True)}
#: the narrow flagship pair
GEN = generator_st(2, (3,), (2, 2), filters=8, n_resblocks=1)['hidden_layers']
DISC = []
for _f, _s in ((4, 1), (4, 2), (6, 1), (6, 2), (8, 1), (8, 2), (8, 1),
               (8, 2)):
    DISC += [{'class': 'Conv3D', 'filters': _f, 'kernel_size': 3,
              'strides': _s, 'padding': 'same'},
             {'class': 'LeakyReLU', 'alpha': 0.2}]
DISC += [{'class': 'Flatten'}, {'class': 'Dense', 'units': 16},
         {'class': 'LeakyReLU', 'alpha': 0.2}, {'class': 'Dense', 'units': 8},
         {'class': 'LeakyReLU', 'alpha': 0.2}, {'class': 'Dense', 'units': 1}]
#: the ``spatiotemporal/disc`` pyramid ('valid' convs) at small widths,
#: four layers deep, and a batch its valid convs fit
VALID_DISC = []
for _f, _s in ((4, 1), (4, 2), (8, 1), (8, 2)):
    VALID_DISC += [{'class': 'Conv3D', 'filters': _f, 'kernel_size': 3,
                    'strides': _s, 'padding': 'valid'},
                   {'class': 'LeakyReLU', 'alpha': 0.2}]
VALID_DISC += [{'class': 'Flatten'}, {'class': 'Dense', 'units': 8},
               {'class': 'LeakyReLU', 'alpha': 0.2},
               {'class': 'Dense', 'units': 1}]
_VRNG = np.random.default_rng(5)
VALID_LR = _VRNG.random((4, 12, 8, 4, 2)).astype(np.float32)
VALID_HR = _VRNG.random((4, 36, 24, 16, 2)).astype(np.float32)
#: the global batch (drawn as chip_smoke.train_batch draws it)
_RNG = np.random.default_rng(1)
LR = _RNG.random((4, 12, 4, 4, 2)).astype(np.float32)
HR = _RNG.random((4, 36, 12, 16, 2)).astype(np.float32)
#: cotangents of the input-gradient check
COT_GEN = np.random.default_rng(2).standard_normal(
    (4, 36, 12, 16, 2)).astype(np.float32)
COT_DISC = np.random.default_rng(3).standard_normal((4, 1)).astype(
    np.float32)
#: a pair with a Dropout layer in each network
DROPOUT_GEN = [{'class': 'Conv3D', 'filters': 18, 'kernel_size': 3,
                'strides': 1, 'padding': 'same'},
               {'class': 'Dropout', 'rate': 0.3},
               {'class': 'SpatioTemporalExpansion', 'spatial_mult': 3,
                'temporal_mult': 4, 'temporal_method': 'nearest'},
               {'class': 'Conv3D', 'filters': 2, 'kernel_size': 3,
                'strides': 1, 'padding': 'same'}]
DROPOUT_DISC = [{'class': 'Conv3D', 'filters': 4, 'kernel_size': 3,
                 'strides': 2, 'padding': 'same'},
                {'class': 'LeakyReLU', 'alpha': 0.2},
                {'class': 'Dropout', 'rate': 0.3},
                {'class': 'Flatten'}, {'class': 'Dense', 'units': 4},
                {'class': 'Dropout', 'rate': 0.3},
                {'class': 'Dense', 'units': 1}]
#: a spatial pair whose generator concatenates a topography raster
#: (the Sup3rCC spatial members' exo layer) with its HR batch
EXO_GEN = [{'class': 'Conv2D', 'filters': 16, 'kernel_size': 3,
            'strides': 1, 'padding': 'same'},
           {'class': 'SpatialExpansion', 'spatial_mult': 2},
           {'class': 'LeakyReLU', 'alpha': 0.2},
           {'class': 'Sup3rConcat', 'name': 'topography'},
           {'class': 'Conv2D', 'filters': 2, 'kernel_size': 3,
            'strides': 1, 'padding': 'same'}]
EXO_DISC = [{'class': 'Conv2D', 'filters': 4, 'kernel_size': 3,
             'strides': 2, 'padding': 'same'},
            {'class': 'LeakyReLU', 'alpha': 0.2},
            {'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]
_ERNG = np.random.default_rng(4)
EXO_LR = _ERNG.random((4, 8, 6, 2)).astype(np.float32)
EXO_HR = _ERNG.random((4, 16, 12, 3)).astype(np.float32)
#: the wide-mesh worker's pair (tests/training/test_wide_mesh.py)
_PAD = {'class': 'FlexiblePadding',
        'paddings': [[0, 0], [3, 3], [3, 3], [3, 3], [0, 0]],
        'mode': 'REFLECT'}


def _unit(filters):
    return [dict(_PAD),
            {'class': 'Conv3D', 'filters': filters, 'kernel_size': 3,
             'strides': 1},
            {'class': 'Cropping3D', 'cropping': 2},
            {'class': 'LeakyReLU', 'alpha': 0.2}]


WIDE_GEN = (_unit(8) + [{'class': 'SpatioTemporalExpansion',
                         'spatial_mult': 2, 'temporal_mult': 2,
                         'temporal_method': 'nearest'}] + _unit(2))
WIDE_DISC = [{'class': 'Conv3D', 'filters': 4, 'kernel_size': 3,
              'strides': 2, 'padding': 'same'},
             {'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]
_WRNG = np.random.default_rng(0)
WIDE_LR = _WRNG.random((8, 4, 4, 2, 2)).astype(np.float32)
WIDE_HR = _WRNG.random((8, 8, 8, 4, 2)).astype(np.float32)
WIDE_LR2 = _WRNG.random((2, 8, 4, 2, 2)).astype(np.float32)
WIDE_HR2 = _WRNG.random((2, 16, 8, 4, 2)).astype(np.float32)
WIDE_ONE = _WRNG.random((1, 16, 8, 2, 2)).astype(np.float32)


def _params(model):
    return [params_to_jax(model.generator),
            params_to_jax(model.discriminator)]


def _record_grads(model):
    """{network: reduced gradients} of the model's next steps."""
    rec = {}
    reduce = model._reduce_grads

    def wrapped(grads, network=None):
        out = reduce(grads, network)
        key = 'gen' if network is model.generator else 'disc'
        rec[key] = [g.detach().clone().numpy() for g in out]
        return out

    model._reduce_grads = wrapped
    return rec


class _Log:
    """Records, while active, the exchanges (kind and calling thread) in
    the order this rank issues them, each fused block's halo rows (rows
    above, rows below) and the input shape of each call of the small
    kernel's wrapper."""

    def __init__(self):
        self.exchanges, self.halos, self.small = [], [], []

    def __enter__(self):
        self._exchange = mesh_module._exchange
        self._apply = conv_ad.ReflectConvHalo.apply
        self._small = fuse.small_reflect_conv_cf
        log = self

        def small(x, *args):
            log.small.append(tuple(x.shape))
            return log._small(x, *args)

        def exchange(mesh, group, sends, recvs, like, kind):
            log.exchanges.append((kind, threading.get_ident()))
            return log._exchange(mesh, group, sends, recvs, like, kind)

        def apply(x, top, bottom, *args):
            log.halos.append((top.shape[2], bottom.shape[2]))
            return log._apply(x, top, bottom, *args)

        mesh_module._exchange = exchange
        conv_ad.ReflectConvHalo.apply = apply
        fuse.small_reflect_conv_cf = small
        return self

    def __exit__(self, *exc):
        mesh_module._exchange = self._exchange
        conv_ad.ReflectConvHalo.apply = self._apply
        fuse.small_reflect_conv_cf = self._small


def _block_rows(model):
    """Hooks recording the s1 rows of each discriminator conv's output on
    this rank (calls in order)."""
    rows = []
    for lyr in model.discriminator.layers:
        if type(lyr).__name__ == 'Conv3D':
            lyr.register_forward_hook(
                lambda m, i, o: rows.append(int(o.shape[2])))
    return rows


# ----------------------------------------------------------------------
# the rank scenarios
def _steps(rank, world, out):
    """Per mesh: one gated step of each kind ('both', then 'gen', then
    'disc') on the rank's block, with its losses, reduced gradients,
    params, exchanged bytes, halo rows, exchange order and the
    discriminator's block rows."""
    res = {}
    for dp, sp in MESHES:
        mesh = get_mesh_2d(dp, sp, devices='cpu')
        if mesh is None:
            continue
        model = Sup3rGan.load(os.path.join(out, 'st'), device='cpu')
        model.attach_mesh(mesh)
        grads = _record_grads(model)
        rows = _block_rows(model)
        lr, hr = shard_batch_spatial(mesh, LR, HR)
        for gate, (do_gen, do_disc) in GATES.items():
            mesh.reset_counters()
            with _Log() as log:
                details = model.run_gradient_descent(
                    lr, hr, train_gen=do_gen, train_disc=do_disc)
            res[(dp, sp, gate)] = {
                'details': details, 'params': _params(model),
                'grads': dict(grads), 'counters': dict(mesh.counters),
                'halos': log.halos, 'exchanges': log.exchanges,
                'small': log.small,
                'main': threading.get_ident(), 'rows': list(rows),
                'aligned': model._auto_shard_aligned(),
                'coords': mesh.coords}
            rows.clear()
            grads.clear()
    return res


def _doubled(rank, world, out):
    """The 2 x 2 step with the head's gradients summed over ALL ranks
    (the space group computes the head whole, so this doubles them)."""
    mesh = get_mesh_2d(2, 2, devices='cpu')
    if mesh is None:
        return {}
    model = Sup3rGan.load(os.path.join(out, 'st'), device='cpu')
    model.attach_mesh(mesh)
    model.discriminator.space_replicated_params = list
    grads = _record_grads(model)
    lr, hr = shard_batch_spatial(mesh, LR, HR)
    details = model.run_gradient_descent(lr, hr, train_gen=True,
                                         train_disc=True)
    return {'grads': dict(grads), 'details': details,
            'params': _params(model)}


def _input_grads(rank, world, out):
    """Per mesh: the gradients of sum(gen(lr) * COT_GEN) in the rank's
    LR block and of sum(disc(hr) * COT_DISC) in its HR block."""
    res = {}
    for dp, sp in MESHES:
        mesh = get_mesh_2d(dp, sp, devices='cpu')
        if mesh is None:
            continue
        model = Sup3rGan.load(os.path.join(out, 'st'), device='cpu')
        model.attach_mesh(mesh)
        shard = model._spatial_shard()
        lr, hr, cot = shard_batch_spatial(mesh, LR, HR, COT_GEN)
        lr.requires_grad_(True)
        hr.requires_grad_(True)
        with exact_fp32():
            gen = model._train_gen_net().apply(lr, spatial=shard)
            (gen * cot).sum().backward()
            d = model._gather(model.discriminator.apply(hr, spatial=shard))
            (d * torch.from_numpy(COT_DISC)).sum().backward()
        res[(dp, sp)] = {'coords': mesh.coords, 'lr': lr.grad.numpy(),
                         'hr': hr.grad.numpy()}
    return res


def _dropout(rank, world, out):
    """The 2 x 2 step of the pair with Dropout layers: each rank masks
    its batch rows and its s1 block of the global masks."""
    mesh = get_mesh_2d(2, 2, devices='cpu')
    if mesh is None:
        return {}
    model = Sup3rGan.load(os.path.join(out, 'dropout'), device='cpu')
    model.attach_mesh(mesh)
    lr, hr = shard_batch_spatial(mesh, LR, HR)
    details = model.run_gradient_descent(lr, hr, train_gen=True,
                                         train_disc=True)
    return {'details': details, 'params': _params(model)}


def _exo(rank, world, out):
    """The 2 x 2 step of the pair with a topography layer: the rank's HR
    block carries its rows of the raster, which the layer takes from the
    gathered raster."""
    mesh = get_mesh_2d(2, 2, devices='cpu')
    if mesh is None:
        return {}
    model = Sup3rGan.load(os.path.join(out, 'exo'), device='cpu')
    model.attach_mesh(mesh)
    details = model.run_gradient_descent(
        *shard_batch_spatial(mesh, EXO_LR, EXO_HR), train_gen=True,
        train_disc=True)
    return {'details': details, 'params': _params(model)}


def _valid(rank, world, out):
    """Per mesh: the step of the narrow flagship generator with the
    'valid' pyramid (every discriminator conv redistributes rows), with
    the bytes each rank sent."""
    res = {}
    for dp, sp in MESHES:
        mesh = get_mesh_2d(dp, sp, devices='cpu')
        if mesh is None:
            continue
        model = Sup3rGan.load(os.path.join(out, 'valid'), device='cpu')
        model.attach_mesh(mesh)
        mesh.reset_counters()
        details = model.run_gradient_descent(
            *shard_batch_spatial(mesh, VALID_LR, VALID_HR), train_gen=True,
            train_disc=True)
        res[(dp, sp)] = {'details': details, 'params': _params(model),
                         'counters': dict(mesh.counters),
                         'coords': mesh.coords}
    return res


def _loop(rank, world, out):
    """An epoch of ``train`` with validation on a 2 x 4 mesh: the ranks
    of a space group draw the same batches (their handlers seeded by
    their data index), each takes its block; a second call with
    handlers seeded per rank is refused."""
    mesh = get_mesh_2d(2, 4, devices='cpu')

    def handler(seed):
        RANDOM_GENERATOR.bit_generator.state = np.random.default_rng(
            seed).bit_generator.state
        return BatchHandler(
            [make_fake_dset((20, 20, 40), FEATURES)],
            [make_fake_dset((20, 20, 16), FEATURES)], batch_size=1,
            n_batches=2, s_enhance=2, t_enhance=2,
            sample_shape=(16, 8, 4))

    model = Sup3rGan.load(os.path.join(out, 'wide2'), device='cpu')
    model.attach_mesh(mesh)
    before = model.generator.layers[1].weight.detach().clone()
    out_dir = os.path.join(out, f'loop_rank{rank}_{{epoch}}')
    model.train(handler(100 + mesh.axis_index('data')), input_resolution=RES,
                n_epoch=1, out_dir=out_dir)
    res = {'before': before.numpy(),
           'after': model.generator.layers[1].weight.detach().numpy(),
           'history': {k: list(model.history[k])
                       for k in ('train_loss_gen', 'train_loss_disc',
                                 'val_loss_gen', 'val_loss_disc')},
           'params': _params(model),
           'wrote': os.path.exists(out_dir.format(epoch=0)),
           'aligned': model._auto_shard_aligned()}
    try:
        model.train(handler(200 + rank), input_resolution=RES, n_epoch=1,
                    out_dir=None)
        res['refused'] = None
    except ValueError as e:
        res['refused'] = str(e)
    return res


def _wide(rank, world, out):
    """tests/training/test_wide_mesh.py's worker at 8 ranks: the
    data-parallel step against one device, the spatially sharded
    forward against the unsharded one, the dp 2 x sp 4 step (the
    shard-aligned formulation engaged by the width gate) and the uneven
    splits' refusals."""
    res = {}
    mesh = get_mesh(8, devices='cpu')
    model = Sup3rGan.load(os.path.join(out, 'wide'), device='cpu')
    model.attach_mesh(mesh)
    mesh.reset_counters()
    res['sp'] = model.generate(shard_spatial(mesh, WIDE_ONE), norm_in=False,
                               un_norm_out=False, mesh=mesh)
    res['sp_halo'] = mesh.counters['halo_bytes']
    res['dp'] = model.run_gradient_descent(
        *shard_batch(mesh, WIDE_LR, WIDE_HR), train_gen=True,
        train_disc=True)
    mesh2 = get_mesh_2d(2, 4, devices='cpu')
    model = Sup3rGan.load(os.path.join(out, 'wide2'), device='cpu')
    model.attach_mesh(mesh2)
    res['axis'] = model._mesh_spatial_axis
    res['aligned'] = model._auto_shard_aligned()
    res['2d'] = model.run_gradient_descent(
        *shard_batch_spatial(mesh2, WIDE_LR2, WIDE_HR2), train_gen=True,
        train_disc=True)
    res['2d_params'] = _params(model)
    errors = []
    for bad in ((3, 8, 4, 2, 2), (2, 9, 4, 2, 2)):
        try:
            shard_batch_spatial(mesh2, np.zeros(bad, np.float32))
        except ValueError as e:
            errors.append(str(e))
    res['errors'] = errors
    return res


SCENARIOS = {'steps': _steps, 'doubled': _doubled,
             'input_grads': _input_grads, 'dropout': _dropout, 'exo': _exo,
             'valid': _valid,
             'loop': _loop, 'wide': _wide}


# ----------------------------------------------------------------------
# the JAX package's side, and the spawned ranks
@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """Save the models the ranks load, run the ranks, and compute the
    single-device references on the global batches: the JAX package's
    steps, gradients and input gradients, and the port's dropout step.
    Returns (rank results, references)."""
    import jax

    from sup3r_tpu.models import Sup3rGan as JaxGan

    out = tmp_path_factory.mktemp('ranks_2d')
    for name, gen, disc, lr, hr, seed in (
            ('st', GEN, DISC, LR, HR, 5),
            ('dropout', DROPOUT_GEN, DROPOUT_DISC, LR, HR, 6),
            ('wide', WIDE_GEN, WIDE_DISC, WIDE_LR, WIDE_HR, 11),
            ('wide2', WIDE_GEN, WIDE_DISC, WIDE_LR2, WIDE_HR2, 11),
            ('exo', EXO_GEN, EXO_DISC, EXO_LR, EXO_HR, 7),
            ('valid', GEN, VALID_DISC, VALID_LR, VALID_HR, 8)):
        model = JaxGan(gen, disc, optimizer=OPT)
        model.init_weights((1, *lr.shape[1:]), (1, *hr.shape[1:]),
                           seed=seed)
        model.save(str(out / name))

    spawn_ranks([sys.executable, os.path.abspath(__file__), str(out)],
                WORLD, str(out), timeout=300)

    def jax_step(name, lr, hr, **gate):
        model = JaxGan.load(str(out / name))
        details = model.run_gradient_descent(lr, hr, **gate)
        return details, [jax.tree.map(np.asarray, model.gen_params),
                         jax.tree.map(np.asarray, model.disc_params)]

    refs = {'st': jax_step('st', LR, HR, train_gen=True, train_disc=True),
            'wide': jax_step('wide', WIDE_LR, WIDE_HR, train_gen=True,
                             train_disc=True),
            'wide2': jax_step('wide2', WIDE_LR2, WIDE_HR2, train_gen=True,
                              train_disc=True),
            'exo': jax_step('exo', EXO_LR, EXO_HR, train_gen=True,
                            train_disc=True),
            'valid': jax_step('valid', VALID_LR, VALID_HR, train_gen=True,
                              train_disc=True)}
    refs['grads'], refs['input_grads'] = _jax_grads(out / 'st')
    model = Sup3rGan.load(str(out / 'dropout'), device='cpu')
    refs['dropout'] = (model.run_gradient_descent(
        LR, HR, train_gen=True, train_disc=True), _params(model))
    model = Sup3rGan.load(str(out / 'wide'), device='cpu')
    refs['wide_sp'] = model.generate(WIDE_ONE, norm_in=False,
                                     un_norm_out=False)
    return rank_results(str(out), WORLD), refs


def _jax_grads(model_dir):
    """The JAX package's single-device gradients on the global batch:
    ({'gen': [...], 'disc': [...]} of the step's losses, in the order
    and layout of the port's params; {'lr', 'hr'}: the input gradients
    of sum(gen(LR) * COT_GEN) and sum(disc(HR) * COT_DISC))."""
    import jax
    import jax.numpy as jnp

    from sup3r_tpu.models import Sup3rGan as JaxGan
    from sup3r_tpu_torch.models.weights import params_from_jax

    jmodel = JaxGan.load(str(model_dir))
    key = jax.random.PRNGKey(0)
    lr, hr = jnp.asarray(LR), jnp.asarray(HR)
    (_, aux), gen = jax.value_and_grad(
        jmodel._make_gen_loss_fn(), has_aux=True)(
            jmodel.gen_params, jmodel.disc_params, lr, hr,
            jnp.float32(0.001), key)
    disc = jax.grad(jmodel._make_disc_loss_fn())(
        jmodel.disc_params, hr, jax.lax.stop_gradient(aux['hi_res_gen']),
        key)
    # the params' layout change is linear, so it carries gradients too
    model = Sup3rGan.load(str(model_dir), device='cpu')
    grads = {}
    for name, net, tree in (('gen', model.generator, gen),
                            ('disc', model.discriminator, disc)):
        params_from_jax(net, jax.tree.map(np.asarray, tree))
        grads[name] = [p.detach().numpy().copy() for p in net.parameters()]
    inputs = {
        'lr': jax.grad(lambda x: jnp.sum(jmodel._gen.apply(
            jmodel.gen_params, x) * COT_GEN))(lr),
        'hr': jax.grad(lambda x: jnp.sum(jmodel._disc.apply(
            jmodel.disc_params, x) * COT_DISC))(hr)}
    return grads, {k: np.asarray(v) for k, v in inputs.items()}


def _result(ranks, name, rank):
    res = ranks[rank][name]
    assert 'error' not in res, res['error']
    return res


def _ranks_of(dp, sp):
    return range(dp * sp)


def _leaves(params):
    return [np.asarray(layer[k]) for net in params for layer in net
            for k in sorted(layer)]


def _check_step(got, want, rtol=2e-4, atol=1e-6):
    (details, params), (want_details, want_params) = got, want
    assert sorted(details) == sorted(want_details)
    for k in want_details:
        np.testing.assert_allclose(details[k], float(want_details[k]),
                                   rtol=rtol, atol=atol, err_msg=k)
    got_leaves, want_leaves = _leaves(params), _leaves(want_params)
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _check_grads(got, want):
    """Every reduced gradient within 1e-5 of its network's largest
    single-device gradient."""
    for net in ('gen', 'disc'):
        scale = max(float(np.abs(g).max()) for g in want[net])
        assert len(got[net]) == len(want[net])
        for i, (a, b) in enumerate(zip(got[net], want[net])):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale,
                                       err_msg=f'{net} param {i}')


def _same_on_every_rank(results):
    first = results[0]
    for other in results[1:]:
        assert other['details'] == first['details']
        for a, b in zip(_leaves(other['params']), _leaves(first['params'])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('dp,sp', MESHES)
def test_mesh_2d_dp_sp_step_matches_single_device(run, dp, sp):
    """The dp x sp step (2 x 2: sp below the shard-aligned gate; 1 x 4:
    engaged) against the JAX package's single-device step on the global
    batch, in the losses and every updated param; every rank the same."""
    ranks, refs = run
    got = [_result(ranks, 'steps', r)[(dp, sp, 'both')]
           for r in _ranks_of(dp, sp)]
    assert [g['aligned'] for g in got] == [sp >= 4] * (dp * sp)
    _same_on_every_rank(got)
    _check_step((got[0]['details'], got[0]['params']), refs['st'])


@pytest.mark.parametrize('dp,sp', MESHES)
def test_mesh_2d_reduced_gradients_match_single_device(run, dp, sp):
    """Gradient accounting and the halo transpose: every param's reduced
    gradient (the generator's, the pyramid's and the row-parallel
    Dense's summed over all ranks; the head's over ``data`` only) against
    the single-device gradient."""
    ranks, refs = run
    for r in _ranks_of(dp, sp):
        _check_grads(_result(ranks, 'steps', r)[(dp, sp, 'both')]['grads'],
                     refs['grads'])


def test_mesh_2d_doubled_reduction_fails_the_bar(run):
    """Summing the head's gradients over all ranks (its space group
    computes it whole) doubles them at sp 2: the gradient bar and the
    step bar both catch it, while the other params stay within it."""
    ranks, refs = run
    got = _result(ranks, 'doubled', 0)
    with pytest.raises(AssertionError, match='disc param'):
        _check_grads(got['grads'], refs['grads'])
    head = len(refs['grads']['disc']) - 5  # the first Dense's bias on
    for a, b in zip(got['grads']['disc'][head:], refs['grads']['disc'][
            head:]):
        if np.abs(b).max() > 1e-3 * max(np.abs(g).max()
                                         for g in refs['grads']['disc']):
            np.testing.assert_allclose(a, 2 * b, rtol=1e-3,
                                       atol=1e-5 * np.abs(b).max())
    for a, b in zip(got['grads']['disc'][:head], refs['grads']['disc'][
            :head]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * max(
            np.abs(g).max() for g in refs['grads']['disc']))
    with pytest.raises(AssertionError):
        _check_step((got['details'], got['params']), refs['st'])


def _assemble(results, key, dp, sp):
    """The global array from every rank's (data, space) block."""
    rows = []
    for i in range(dp):
        blocks = [res[key] for res in results if res['coords'][0] == i]
        rows.append(np.concatenate(blocks, axis=1))
    return np.concatenate(rows, axis=0)


@pytest.mark.parametrize('dp,sp', MESHES)
def test_halo_transpose_input_gradients_at_block_edges(run, dp, sp):
    """All ranks' input gradients, assembled, against the unsharded ones:
    the generator's LR input (fused blocks' halo exchanges) and the
    discriminator's HR input (halo exchanges and row redistributions),
    every row and on their own the 2 x (sp - 1) block-edge rows."""
    ranks, refs = run
    results = [_result(ranks, 'input_grads', r)[(dp, sp)]
               for r in _ranks_of(dp, sp)]
    for key in ('lr', 'hr'):
        got = _assemble(results, key, dp, sp)
        want = refs['input_grads'][key]
        scale = float(np.abs(want).max())
        block = want.shape[1] // sp
        edges = sorted({r for e in range(1, sp) for r in
                        (e * block - 1, e * block)})
        assert len(edges) == 2 * (sp - 1)
        np.testing.assert_allclose(got[:, edges], want[:, edges], rtol=0,
                                   atol=1e-5 * scale, err_msg=key)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                                   err_msg=key)


def test_uneven_blocks_after_stride_2(run):
    """At sp 4 the HR block of 9 rows is halved to blocks of 5, 5, 4 and
    4 rows, then 3, 2, 2, 2 and 2, 1, 1, 1, and the last stride-2 conv
    leaves the fourth rank no rows; the step still matches (above)."""
    ranks, _ = run
    per_rank = [_result(ranks, 'steps', r)[(1, 4, 'both')]['rows']
                for r in range(4)]
    # the first call of each conv is the discriminator on the true batch
    first = [rows[:8] for rows in per_rank]
    assert [f[0] for f in first] == [9, 9, 9, 9]
    assert [f[1] for f in first] == [5, 5, 4, 4]
    assert [f[3] for f in first] == [3, 2, 2, 2]
    assert [f[5] for f in first] == [2, 1, 1, 1]
    assert [f[7] for f in first] == [1, 1, 1, 0]
    assert sum(f[7] for f in first) == 3


@pytest.mark.parametrize('dp,sp', MESHES)
def test_reflect_rows_at_the_global_edges_only(run, dp, sp):
    """The fused blocks of the first rank of a space group take no rows
    from above (they reflect there), of the last none from below; an
    interior rank takes its neighbours' rows on both sides in every
    call."""
    ranks, _ = run
    for r in _ranks_of(dp, sp):
        res = _result(ranks, 'steps', r)[(dp, sp, 'both')]
        j = res['coords'][1]
        want = (int(j > 0), int(j < sp - 1))
        assert res['halos'] and set(res['halos']) == {want}


@pytest.mark.parametrize('dp,sp', MESHES)
def test_small_kernel_route_follows_the_gate(run, dp, sp):
    """Below the shard-aligned gate (2 x 2) the generator's blocks that
    the small kernel takes (the narrow pair's first 2 -> 8 block and its
    1 -> 2 HR tail: ci * co <= 32) go to the kernel's wrapper once a
    step each, on the rank's batch rows gathered to all the s1 rows (the
    JAX package's route, where XLA gathers a pallas_call's operands); at
    the gate (1 x 4) they exchange halo rows like every other fused
    block and the wrapper is not called."""
    ranks, _ = run
    n = LR.shape[0] // dp
    want = ([(n, 2, *LR.shape[1:4]), (n, 1, *HR.shape[1:4])] if sp < 4
            else [])
    for gate in GATES:
        for r in _ranks_of(dp, sp):
            assert _result(ranks, 'steps', r)[(dp, sp, gate)][
                'small'] == want


@pytest.mark.parametrize('dp,sp', MESHES)
def test_collectives_in_one_order_on_every_rank(run, dp, sp):
    """Every rank issues the same exchanges in the same order, all from
    the thread that called the step (the CPU's backward runs in it)."""
    ranks, _ = run
    for gate in GATES:
        logs = [_result(ranks, 'steps', r)[(dp, sp, gate)]
                for r in _ranks_of(dp, sp)]
        kinds = [[k for k, _ in res['exchanges']] for res in logs]
        assert kinds[0] and all(k == kinds[0] for k in kinds)
        assert {'halo', 'rows'} <= set(kinds[0])
        for res in logs:
            assert {t for _, t in res['exchanges']} == {res['main']}


@pytest.mark.parametrize('gate', list(GATES))
@pytest.mark.parametrize('dp,sp', MESHES)
def test_train_step_shard_aligned_on_spatial_mesh(run, dp, sp, gate):
    """The halo (one-row) and row-redistribution bytes each rank sends in
    a gated step, forward and backward, equal the analytic count from the
    layer configs and shapes; the shard-aligned formulation (engaged at
    sp 4) sends the same bytes as the reflect one would (the port's halo
    is one row either way)."""
    ranks, refs = run
    do_gen, do_disc = GATES[gate]
    for r in _ranks_of(dp, sp):
        res = _result(ranks, 'steps', r)[(dp, sp, gate)]
        want = expected_exchange_bytes(
            Sup3rGan(GEN, DISC, device='cpu'), LR.shape, HR.shape, dp, sp,
            res['coords'][1], do_gen, do_disc)
        assert res['counters'].get('halo_bytes', 0) == want['halo'] > 0
        assert res['counters'].get('rows_bytes', 0) == want['rows']
        assert np.isfinite(list(res['details'].values())).all()


def test_mesh_2d_dropout_step_matches_single_device(run):
    """Dropout under a 2 x 2 mesh: each rank's masks are its batch rows
    and its s1 block of the global masks, so the step is the port's
    single-device step (torch draws the masks, so JAX's differ)."""
    ranks, refs = run
    got = [_result(ranks, 'dropout', r) for r in range(4)]
    _same_on_every_rank(got)
    _check_step((got[0]['details'], got[0]['params']), refs['dropout'])


def test_mesh_2d_exo_layer_step_matches_single_device(run):
    """A generator with a ``Sup3rConcat`` topography layer on a 2 x 2
    mesh: the step matches the JAX package's single-device step."""
    ranks, refs = run
    got = [_result(ranks, 'exo', r) for r in range(4)]
    _same_on_every_rank(got)
    _check_step((got[0]['details'], got[0]['params']), refs['exo'])


@pytest.mark.parametrize('dp,sp', MESHES)
def test_mesh_2d_valid_convs_step_matches_single_device(run, dp, sp):
    """The 'valid' pyramid of ``spatiotemporal/disc`` (each rank owns the
    even split of every conv's output rows and receives the input rows
    they read): the step matches the JAX package's single-device step,
    and the rows each rank sent match the analytic count."""
    ranks, refs = run
    got = [_result(ranks, 'valid', r)[(dp, sp)] for r in _ranks_of(dp, sp)]
    _same_on_every_rank(got)
    _check_step((got[0]['details'], got[0]['params']), refs['valid'])
    for res in got:
        want = expected_exchange_bytes(
            Sup3rGan(GEN, VALID_DISC, device='cpu'), VALID_LR.shape,
            VALID_HR.shape, dp, sp, res['coords'][1])
        assert res['counters'].get('rows_bytes', 0) == want['rows'] > 0
        assert res['counters'].get('halo_bytes', 0) == want['halo']


SHIPPED = ['spatial/disc', 'spatial/disc_test', 'spatiotemporal/disc',
           'spatiotemporal/disc_test', 'spatiotemporal/gen_3x_4x_2f',
           'spatial/gen_2x_2f', 'sup3rcc/gen_wind_5x_1x_6f',
           'sup3rcc/gen_trh_1x_24x_2f']


@pytest.mark.parametrize('name', SHIPPED)
def test_shipped_configs_run_on_a_space_axis(name):
    """Shipped networks on a 1 x 1 mesh's space axis (one process: every
    sharded form runs, with no neighbours) give their unsharded output:
    the discriminators whole, the generators fused as ``train_fuse``
    runs them; unfused, a generator's first pad raises a ValueError that
    says why."""
    from sup3r_tpu_torch.configs import get_config
    from sup3r_tpu_torch.models.fuse import fuse_network
    from sup3r_tpu_torch.models.network import Network
    from sup3r_tpu_torch.parallel.mesh import SpatialShard

    shard = SpatialShard(get_mesh_2d(1, 1, devices='cpu'), 'space')
    net = Network(get_config(name)['hidden_layers'])
    if 'disc' in name:
        # 68 rows: the least that the 'valid' pyramids' eight convs fit
        shape = ((1, 68, 68, 2) if name.startswith('spatial/')
                 else (1, 68, 68, 68, 2))
        nets = [net]
    else:
        shape = {'spatiotemporal/gen_3x_4x_2f': (1, 4, 4, 3, 2),
                 'spatial/gen_2x_2f': (1, 6, 6, 2),
                 'sup3rcc/gen_wind_5x_1x_6f': (1, 4, 4, 6),
                 'sup3rcc/gen_trh_1x_24x_2f': (1, 4, 4, 2, 2)}[name]
        nets = [Network(fuse_network(list(net.layers)))]
    net.init(shape, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).random(shape).astype(
        np.float32))
    exo = {}
    if net.exo_features:
        out = Network(net.layers[:[type(lyr).__name__ for lyr in
                                   net.layers].index('Sup3rConcat')])
        exo = {'topography': torch.ones(out.out_shape(shape)[:-1] + (1,))}
    with torch.no_grad():
        for n in nets:
            torch.testing.assert_close(n.apply(x, exo, spatial=shard),
                                       n.apply(x, exo), rtol=1e-5,
                                       atol=1e-6)
        if 'gen' in name:
            with pytest.raises(ValueError, match='FlexiblePadding cannot'):
                net.apply(x, exo, spatial=shard)


def test_mesh_2d_full_training_loop(run):
    """An epoch of ``train`` on a 2 x 4 mesh changes the weights, gives
    every rank the same finite history and params, writes from the first
    rank only, engages the shard-aligned formulation, and refuses a
    space group whose ranks feed different samples."""
    ranks, _ = run
    res = [_result(ranks, 'loop', r) for r in range(WORLD)]
    assert not np.allclose(res[0]['before'], res[0]['after'])
    for r in res:
        assert r['history'] == res[0]['history']
        assert all(np.isfinite(v).all() for v in r['history'].values())
        for a, b in zip(_leaves(r['params']), _leaves(res[0]['params'])):
            np.testing.assert_array_equal(a, b)
        assert r['aligned'] is True
        assert 'fed different samples' in r['refused']
    assert [r['wrote'] for r in res] == [True] + [False] * (WORLD - 1)


def test_wide_mesh(run):
    """tests/training/test_wide_mesh.py at 8 ranks: the 8-rank
    data-parallel step and the dp 2 x sp 4 step (shard-aligned by the
    width gate) against the JAX package's single-device steps, the
    8-rank spatially sharded forward against the unsharded one (halo
    rows sent), and uneven splits refused on either axis."""
    ranks, refs = run
    want_sp = refs['wide_sp']
    rows = want_sp.shape[1] // WORLD
    for r in range(WORLD):
        res = _result(ranks, 'wide', r)
        for k, v in refs['wide'][0].items():
            np.testing.assert_allclose(res['dp'][k], v, rtol=2e-4,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_allclose(res['sp'],
                                   want_sp[:, rows * r:rows * (r + 1)],
                                   rtol=1e-5, atol=1e-5)
        assert res['sp_halo'] > 0
        assert res['axis'] == 'space' and res['aligned'] is True
        _check_step((res['2d'], res['2d_params']), refs['wide2'])
        assert len(res['errors']) == 2
        assert all('not divisible' in e for e in res['errors'])


def test_attach_mesh_2d_options():
    """In one process (a world of one): a 2D mesh finds its space axis;
    ``spatial_axis=False`` keeps it data-only; an axis the mesh lacks,
    and classes whose step has no sharded form, are refused with the
    reason; a layer without a sharded form (an unfused pad, with
    ``train_fuse`` off) raises a ValueError naming it; the 1 x 1 step
    equals the unmeshed one."""
    lr, hr = LR[:1, :, :, :, :], HR[:1]
    model = Sup3rGan(GEN, DISC, optimizer=OPT, device='cpu')
    model.init_weights((1, *LR.shape[1:]), (1, *HR.shape[1:]), seed=1)
    plain = Sup3rGan(GEN, DISC, optimizer=OPT, device='cpu')
    plain.init_weights((1, *LR.shape[1:]), (1, *HR.shape[1:]), seed=1)
    model.attach_mesh(get_mesh_2d(1, 1, devices='cpu'))
    assert model._mesh_spatial_axis == 'space'
    assert model._auto_shard_aligned() is False
    got = model.run_gradient_descent(lr, hr, train_gen=True, train_disc=True)
    want = plain.run_gradient_descent(lr, hr, train_gen=True,
                                      train_disc=True)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-7)
    model.attach_mesh(get_mesh_2d(1, 1, devices='cpu'), spatial_axis=False)
    assert model._mesh_spatial_axis is None
    with pytest.raises(ValueError, match='second axis'):
        model.attach_mesh(get_mesh(devices='cpu'), spatial_axis='space')
    model.attach_mesh(get_mesh_2d(1, 1, devices='cpu'))
    model.train_fuse = False
    model._train_net = None
    with pytest.raises(ValueError, match='FlexiblePadding cannot run'):
        model.run_gradient_descent(lr, hr)
    obs = Sup3rGanWithObs(GEN, DISC, device='cpu')
    with pytest.raises(ValueError, match='observation mask'):
        obs.attach_mesh(get_mesh_2d(1, 1, devices='cpu'))


if __name__ == '__main__':
    run_rank_scenarios(SCENARIOS, *sys.argv[1:])
