"""Data-parallel training of the port over a mesh of ranks
(``Sup3rGan.attach_mesh``; tests/training/test_parallel_train.py and
test_dcn_multiprocess.py of the JAX package): four spawned ranks of one
gloo group (``spawn_ranks``) run the scenarios below, each rank feeding
its own rows of the batch, and the tests hold them to the JAX package's
single-device step on the global batch (built and saved here, loaded by
the ranks):

- the step with the adversarial terms on (``train_disc=True``) over 2
  and 4 ranks, fp32 (rtol 2e-4, atol 1e-6: the JAX package's bar for its
  own mesh step) and bf16 (rtol 1e-2, atol 1e-4);
- the step with ``mmd_loss`` (it pairs every sample with every other,
  so it is computed on the gathered batch) over 4 ranks, fp32 bar;
- steps that draw random numbers per sample, over 2 and 4 ranks:
  networks with ``Dropout`` layers against the port's single-device step
  (each rank's masks are its rows of the global batch's; torch draws
  them, so the JAX package's differ), and ``Sup3rGanWithObs`` against
  the JAX package's step on a given observation mask and, with the masks
  its sampler draws, against the port's single-device step;
- ``SolarCC``: the generator's step at ``weight_gen_advers=0`` against
  the JAX package's (its windows do not enter), the full step against
  the port's own single-device step (torch draws the same windows);
- every rank reports the same finite losses (the DCN test, 2 and 4
  ranks), ends with the same params, and the training loop writes its
  checkpoints from the first rank only;
- ``attach_mesh`` broadcasts the first rank's params; the paired feed,
  the device transform and the dual-resolution pipeline from files train
  on a mesh; the 2D mesh layout of ``shard_batch_spatial``.

The steps run Adam with ``epsilon=1`` (as tests/test_torch_train_step.py
explains: with the default epsilon an Adam first step is sign(g), so a
gradient within rounding of zero in either package moves its weight by
+-lr).

Run as a script (``python tests/test_torch_parallel_train.py out_dir
rank world store``) this file is one rank: it imports torch and the port
only."""

import os
import sys

import numpy as np
import pytest
import torch

from sup3r_tpu_torch.models import (
    SolarCC,
    Sup3rGan,
    Sup3rGanDC,
    Sup3rGanWithObs,
)
from sup3r_tpu_torch.models.weights import params_to_jax
from sup3r_tpu_torch.parallel import (
    get_mesh,
    get_mesh_2d,
    shard_batch,
    shard_batch_spatial,
)
from sup3r_tpu_torch.preprocessing import (
    BatchHandler,
    BatchHandlerDC,
    DataHandler,
    DualBatchHandler,
    DualRasterizer,
)
from sup3r_tpu_torch.utilities import RANDOM_GENERATOR
from sup3r_tpu_torch.utilities.test_helpers import (
    make_fake_dset,
    rank_results,
    run_rank_scenarios,
    spawn_ranks,
)

torch.set_num_threads(1)

WORLD = 4
OPT = {'name': 'Adam', 'learning_rate': 1e-3, 'epsilon': 1.0}
FEATURES = ['u_100m', 'v_100m']
RES = {'spatial': '30km', 'temporal': '60min'}
#: the global batch of the step scenarios (the JAX test's)
_RNG = np.random.default_rng(0)
LR = _RNG.random((8, 4, 4, 2)).astype(np.float32)
HR = _RNG.random((8, 8, 8, 2)).astype(np.float32)
#: SolarCC's global batch: 4 samples, two days (tests/test_torch_solar_cc)
SOLAR_LR = np.random.default_rng(2).random((4, 4, 4, 6, 3)).astype(
    np.float32)
SOLAR_HR = np.random.default_rng(3).random((4, 4, 4, 48, 1)).astype(
    np.float32)
#: the small GAN of tests/training/test_model_family.py with a Dropout
#: layer in each network
DROPOUT_GEN = [{'class': 'Conv2D', 'filters': 32, 'kernel_size': 3,
                'strides': 1, 'padding': 'same'},
               {'class': 'SpatialExpansion', 'spatial_mult': 2},
               {'class': 'LeakyReLU', 'alpha': 0.2},
               {'class': 'Dropout', 'rate': 0.3},
               {'class': 'Conv2D', 'filters': 2, 'kernel_size': 3,
                'strides': 1, 'padding': 'same'}]
DROPOUT_DISC = [{'class': 'Conv2D', 'filters': 8, 'kernel_size': 3,
                 'strides': 2, 'padding': 'same'},
                {'class': 'LeakyReLU', 'alpha': 0.2},
                {'class': 'Dropout', 'rate': 0.3},
                {'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]
#: tests/test_torch_with_obs.py's WithObs generator
OBS_GEN = [{'class': 'Conv2D', 'filters': 16, 'kernel_size': 3,
            'strides': 1, 'padding': 'same'},
           {'class': 'SpatialExpansion', 'spatial_mult': 2},
           {'class': 'LeakyReLU', 'alpha': 0.2},
           {'class': 'Sup3rConcatObs', 'name': 'u_100m_obs'},
           {'class': 'Conv2D', 'filters': 2, 'kernel_size': 3,
            'strides': 1, 'padding': 'same'}]
#: a given not-observed mask of the global HR batch: one (s1, s2) mask
#: for every sample and channel, as the sampler draws them
NOT_OBS = np.broadcast_to(
    (np.random.default_rng(4).random((8, 8)) > 0.3)[None, ..., None],
    HR.shape).copy()


def _rows(arr, rank, width):
    n = len(arr) // width
    return arr[rank * n:(rank + 1) * n]


def _params(model):
    return [params_to_jax(model.generator),
            params_to_jax(model.discriminator)]


# ----------------------------------------------------------------------
# the rank scenarios
def _steps(rank, world, out):
    """One gated step (gen and disc) per (dtype, width): the model loaded
    from the JAX save, the rank's rows of the global batch."""
    res = {}
    for kind, name in (('fp32', 'small'), ('bf16', 'small'),
                       ('mmd', 'mmd')):
        for width in ((4,) if kind == 'mmd' else (2, 4)):
            mesh = get_mesh(width, devices='cpu')
            if mesh is None:
                continue
            model = Sup3rGan.load(os.path.join(out, name), device='cpu')
            if kind == 'bf16':
                model.train_dtype = 'bfloat16'
            model.attach_mesh(mesh)
            details = model.run_gradient_descent(
                _rows(LR, rank, width), _rows(HR, rank, width),
                train_gen=True, train_disc=True)
            res[(kind, width)] = (details, _params(model))
    return res


def _random_steps(rank, world, out):
    """One gated step per (model, width) of the networks with dropout and
    of WithObs on a given mask and on its sampler's masks."""
    res = {}
    for width in (2, 4):
        mesh = get_mesh(width, devices='cpu')
        if mesh is None:
            continue
        for kind in ('dropout', 'obs_given', 'obs_seeded'):
            if kind == 'dropout':
                model = Sup3rGan.load(os.path.join(out, 'dropout'),
                                      device='cpu')
            else:
                model = Sup3rGanWithObs.load(os.path.join(out, 'obs'),
                                             device='cpu')
            if kind == 'obs_given':
                model._sample_obs_mask = (
                    lambda shape, generator: torch.as_tensor(
                        NOT_OBS[:shape[0]]))
            model.attach_mesh(mesh)
            details = model.run_gradient_descent(
                _rows(LR, rank, width), _rows(HR, rank, width),
                train_gen=True, train_disc=True)
            res[(kind, width)] = (details, _params(model))
    return res


def _solar(rank, world, out):
    mesh = get_mesh(2, devices='cpu')
    if mesh is None:
        return {}
    res = {}
    for what, kw in (('gen', dict(weight_gen_advers=0.0, train_gen=True,
                                  train_disc=False)),
                     ('full', dict(weight_gen_advers=1e-3, train_gen=True,
                                   train_disc=True))):
        model = SolarCC.load(os.path.join(out, 'solar'), device='cpu')
        model.attach_mesh(mesh)
        details = model.run_gradient_descent(
            _rows(SOLAR_LR, rank, 2), _rows(SOLAR_HR, rank, 2), **kw)
        res[what] = (details, _params(model))
    return res


def _dcn(rank, world, out):
    """The JAX DCN worker's model and step: every rank feeds 2 rows of a
    global batch of 2 per rank."""
    gen = [{'class': 'Conv2D', 'filters': 8, 'kernel_size': 3,
            'strides': 1, 'padding': 'same'},
           {'class': 'SpatialExpansion', 'spatial_mult': 2},
           {'class': 'Conv2D', 'filters': 2, 'kernel_size': 3,
            'strides': 1, 'padding': 'same'}]
    disc = [{'class': 'Conv2D', 'filters': 4, 'kernel_size': 3,
             'strides': 2, 'padding': 'same'},
            {'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]
    res = {}
    for width in (2, 4):
        mesh = get_mesh(width, devices='cpu')
        if mesh is None:
            continue
        model = Sup3rGan(gen, disc, learning_rate=1e-3, device='cpu')
        model.init_weights((1, 4, 4, 2), (1, 8, 8, 2), seed=7)
        model.attach_mesh(mesh)
        rng = np.random.default_rng(0)
        lr_g = rng.random((2 * width, 4, 4, 2)).astype(np.float32)
        hr_g = rng.random((2 * width, 8, 8, 2)).astype(np.float32)
        details = model.run_gradient_descent(
            lr_g[2 * rank:2 * rank + 2], hr_g[2 * rank:2 * rank + 2],
            train_gen=True, train_disc=True)
        res[width] = ' '.join(f'{k}={v:.8f}'
                              for k, v in sorted(details.items()))
    return res


def _train_loop(rank, world, out):
    """One epoch over each rank's own BatchHandler (its own draws) with
    validation; checkpoints to a directory per rank."""
    mesh = get_mesh(devices='cpu')
    RANDOM_GENERATOR.bit_generator.state = np.random.default_rng(
        100 + rank).bit_generator.state
    handler = BatchHandler(
        [make_fake_dset((20, 20, 40), FEATURES)],
        [make_fake_dset((20, 20, 16), FEATURES)], batch_size=2,
        n_batches=2, s_enhance=2, t_enhance=1, sample_shape=(8, 8, 1))
    model = Sup3rGan.load(os.path.join(out, 'small'), device='cpu')
    model.attach_mesh(mesh)
    before = model.generator.layers[0].weight.detach().clone()
    out_dir = os.path.join(out, f'loop_rank{rank}_{{epoch}}')
    model.train(handler, input_resolution=RES, n_epoch=1, out_dir=out_dir)
    return {'before': before.numpy(),
            'after': model.generator.layers[0].weight.detach().numpy(),
            'history': {k: list(model.history[k])
                        for k in ('train_loss_gen', 'train_loss_disc',
                                  'val_loss_gen', 'val_loss_disc')},
            'params': _params(model),
            'wrote': os.path.exists(out_dir.format(epoch=0))}


def _dc(rank, world, out):
    """A Sup3rGanDC epoch on 2 ranks, each over its own BatchHandlerDC:
    the per-bin validation losses, and so the new bin weights, are the
    ranks' mean."""
    mesh = get_mesh(2, devices='cpu')
    if mesh is None:
        return {}
    RANDOM_GENERATOR.bit_generator.state = np.random.default_rng(
        200 + rank).bit_generator.state
    handler = BatchHandlerDC(
        [make_fake_dset((20, 20, 40), FEATURES)],
        [make_fake_dset((20, 20, 40), FEATURES)], batch_size=2,
        n_batches=2, s_enhance=2, t_enhance=1, sample_shape=(8, 8, 1),
        n_space_bins=2, n_time_bins=1)
    model = Sup3rGanDC.load(os.path.join(out, 'small'), device='cpu')
    model.attach_mesh(mesh)
    model.train(handler, input_resolution=RES, n_epoch=1, out_dir=None)
    return {'weights': (list(handler.spatial_weights),
                        list(handler.temporal_weights)),
            'history': {k: list(model.history[k]) for k in (
                'train_loss_gen', 'val_loss_gen')}}


def _replicated(rank, world, out):
    """Different seeds on every rank before ``attach_mesh``; the first
    rank's params (and optimizer state) on every rank after; a global
    batch of 8 gives each rank its 2 rows."""
    mesh = get_mesh(devices='cpu')
    model = Sup3rGan.load(os.path.join(out, 'small'), device='cpu')
    model.init_weights((1, 4, 4, 2), (1, 8, 8, 2), seed=rank)
    seeded = _params(model)
    model.attach_mesh(mesh)
    return {'seeded': seeded, 'params': _params(model),
            'mu': [m.numpy() for m in model._gen_opt_state['mu']],
            'batch': shard_batch(mesh, LR).numpy(),
            'broadcast': dict(mesh.counters)}


def _feeds(rank, world, out):
    """The paired feed, the device transform against the host transform
    and the dual-resolution pipeline from files, each on 2 ranks."""
    mesh = get_mesh(2, devices='cpu')
    if mesh is None:
        return {}

    def trained(handler, seed=None):
        model = Sup3rGan.load(os.path.join(out, 'small'), device='cpu')
        if seed is not None:
            model.init_weights((1, 4, 4, 2), (1, 8, 8, 2), seed=seed)
        model.attach_mesh(mesh)
        model.train(handler, input_resolution=RES, n_epoch=1, out_dir=None)
        return model

    RANDOM_GENERATOR.bit_generator.state = np.random.default_rng(
        7).bit_generator.state
    lr, hr = (make_fake_dset((12, 12, 30), FEATURES),
              make_fake_dset((24, 24, 30), FEATURES))
    dual = DualBatchHandler(
        [DualRasterizer((lr, hr), s_enhance=2, t_enhance=1)], batch_size=2,
        n_batches=2, s_enhance=2, t_enhance=1, sample_shape=(8, 8, 1))
    paired = trained(dual)

    data = make_fake_dset((20, 20, 40), FEATURES)
    losses = {}
    for device_transform in (False, True):
        RANDOM_GENERATOR.bit_generator.state = np.random.default_rng(
            0).bit_generator.state
        handler = BatchHandler(
            [data], batch_size=2, n_batches=2, s_enhance=2, t_enhance=1,
            sample_shape=(8, 8, 1), device_transform=device_transform)
        losses[device_transform] = trained(handler, seed=1).history[
            'train_loss_gen'][-1]

    lr_h = DataHandler(os.path.join(out, 'era.nc'), features=FEATURES)
    hr_h = DataHandler(os.path.join(out, 'wtk.h5'), features=FEATURES)
    files = DualBatchHandler(
        [DualRasterizer((lr_h.data, hr_h.data), s_enhance=2, t_enhance=1)],
        batch_size=2, n_batches=2, s_enhance=2, t_enhance=1,
        sample_shape=(8, 8, 1))
    from_files = trained(files)
    return {'paired_s_enhance': paired.meta['s_enhance'],
            'paired_loss': paired.history['train_loss_gen'][-1],
            'losses': losses,
            'files_loss': from_files.history['train_loss_gen'][-1]}


def _layout(rank, world, out):
    """shard_batch_spatial on a 2 x 2 mesh: dim 0 over 'data', dim 1 over
    'space'; uneven splits raise; a per-sample vector splits on the
    batch only; ``attach_mesh`` finds the 2D mesh's space axis
    (tests/test_torch_parallel_2d.py trains on it)."""
    mesh = get_mesh_2d(2, 2, devices='cpu')
    arr = np.arange(4 * 8 * 6 * 2, dtype=np.float32).reshape(4, 8, 6, 2)
    block = shard_batch_spatial(mesh, arr)
    errors = []
    for bad in ((3, 8, 6, 2), (4, 7, 6, 2)):
        try:
            shard_batch_spatial(mesh, np.zeros(bad, np.float32))
        except ValueError as e:
            errors.append(str(e))
    full, weights = shard_batch_spatial(mesh, arr,
                                        np.arange(4, dtype=np.float32))
    model = Sup3rGan.load(os.path.join(out, 'small'), device='cpu')
    model.attach_mesh(mesh)
    return {'coords': mesh.coords, 'block': block.numpy(),
            'full': full.numpy(), 'weights': weights.numpy(),
            'errors': errors, 'axis': model._mesh_spatial_axis}


SCENARIOS = {'steps': _steps, 'random': _random_steps, 'solar': _solar,
             'dcn': _dcn,
             'train_loop': _train_loop, 'dc': _dc,
             'replicated': _replicated,
             'feeds': _feeds, 'layout': _layout}


# ----------------------------------------------------------------------
# the JAX package's side, and the spawned ranks
@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """Save the JAX models and files the ranks read, run the ranks, and
    compute the JAX package's single-device steps on the global batches.
    Returns (rank results, references)."""
    import jax

    from sup3r_tpu.models import SolarCC as JaxSolarCC
    import jax.numpy as jnp

    from sup3r_tpu.models import Sup3rGan as JaxGan
    from sup3r_tpu.models import Sup3rGanWithObs as JaxObsGan
    from sup3r_tpu.utilities.test_helpers import (
        make_fake_h5_file,
        make_fake_nc_file,
    )
    from tests.test_torch_solar_cc import DISC, GEN, MEANS, META, STDS
    from tests.training.test_model_family import _small_disc, _small_gen_s

    out = tmp_path_factory.mktemp('train_ranks')
    for name, loss in (('small', 'MeanSquaredError'), ('mmd', 'MmdLoss')):
        model = JaxGan(_small_gen_s(), _small_disc(), optimizer=OPT,
                       loss=loss)
        model.init_weights((1, 4, 4, 2), (1, 8, 8, 2), seed=3)
        model.save(str(out / name))
    dropout = JaxGan(DROPOUT_GEN, DROPOUT_DISC, optimizer=OPT)
    dropout.init_weights((1, 4, 4, 2), (1, 8, 8, 2), seed=3)
    dropout.save(str(out / 'dropout'))
    obs = JaxObsGan(OBS_GEN, _small_disc(), optimizer=OPT,
                    onshore_obs_frac={'spatial_frac': [0.2, 0.4]},
                    loss_obs_weight=0.5,
                    meta={'hr_out_features': FEATURES,
                          'lr_features': FEATURES})
    obs.init_weights((1, 4, 4, 2), (1, 8, 8, 2), seed=3)
    obs.save(str(out / 'obs'))
    solar = JaxSolarCC(GEN, DISC, optimizer=OPT, meta=dict(META),
                       means=MEANS, stdevs=STDS)
    solar.init_weights((1, *SOLAR_LR.shape[1:]), (1, *SOLAR_HR.shape[1:]))
    solar.save(str(out / 'solar'))
    make_fake_nc_file(str(out / 'era.nc'), (10, 10, 20), ['u100', 'v100'])
    make_fake_h5_file(str(out / 'wtk.h5'), (20, 20, 20), FEATURES)

    spawn_ranks([sys.executable, os.path.abspath(__file__), str(out)],
                WORLD, str(out), timeout=240)

    def jax_params(model):
        return [jax.tree.map(np.asarray, model.gen_params),
                jax.tree.map(np.asarray, model.disc_params)]

    refs = {}
    for kind, name in (('fp32', 'small'), ('bf16', 'small'),
                       ('mmd', 'mmd')):
        model = JaxGan.load(str(out / name))
        if kind == 'bf16':
            model.train_dtype = 'bfloat16'
        details = model.run_gradient_descent(LR, HR, train_gen=True,
                                             train_disc=True)
        refs[kind] = (details, jax_params(model))
    step = dict(train_gen=True, train_disc=True)
    port = Sup3rGan.load(str(out / 'dropout'), device='cpu')
    refs['dropout'] = (port.run_gradient_descent(LR, HR, **step),
                       _params(port))
    model = JaxObsGan.load(str(out / 'obs'))
    model._sample_obs_mask = lambda key, shape: jnp.asarray(NOT_OBS)
    refs['obs_given'] = (model.run_gradient_descent(LR, HR, **step),
                         jax_params(model))
    port = Sup3rGanWithObs.load(str(out / 'obs'), device='cpu')
    refs['obs_seeded'] = (port.run_gradient_descent(LR, HR, **step),
                          _params(port))
    model = JaxSolarCC.load(str(out / 'solar'))
    refs['solar_gen'] = (model.run_gradient_descent(
        SOLAR_LR, SOLAR_HR, weight_gen_advers=0.0, train_gen=True,
        train_disc=False), jax_params(model))
    port = SolarCC.load(str(out / 'solar'), device='cpu')
    refs['solar_full'] = (port.run_gradient_descent(
        SOLAR_LR, SOLAR_HR, weight_gen_advers=1e-3, train_gen=True,
        train_disc=True), _params(port))
    return rank_results(str(out), WORLD), refs, out


def _result(ranks, name, rank):
    res = ranks[rank][name]
    assert 'error' not in res, res['error']
    return res


def _leaves(params):
    """Flat list of the arrays of [gen params, disc params] (lists of
    per-layer dicts)."""
    return [np.asarray(layer[k]) for net in params for layer in net
            for k in sorted(layer)]


def _check_step(got, want, rtol, atol, keys=None):
    (details, params), (want_details, want_params) = got, want
    assert sorted(details) == sorted(want_details)
    for k in keys or want_details:
        np.testing.assert_allclose(details[k], float(want_details[k]),
                                   rtol=rtol, atol=atol, err_msg=k)
    for a, b in zip(_leaves(params), _leaves(want_params)):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _same_on_every_rank(results):
    first = results[0]
    for other in results[1:]:
        assert other[0] == first[0]
        for a, b in zip(_leaves(other[1]), _leaves(first[1])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('width', [2, 4])
@pytest.mark.parametrize('kind,rtol,atol', [('fp32', 2e-4, 1e-6),
                                            ('bf16', 1e-2, 1e-4)])
def test_mesh_step_matches_single_device(run, kind, rtol, atol, width):
    """The data-parallel step (adversarial terms on) over ``width`` ranks
    against the JAX package's single-device step on the global batch;
    every rank reports the same losses and ends with the same params."""
    ranks, refs, _ = run
    got = [_result(ranks, 'steps', r)[(kind, width)] for r in range(width)]
    _same_on_every_rank(got)
    _check_step(got[0], refs[kind], rtol, atol)


def test_mesh_mmd_step_matches_single_device(run):
    """``mmd_loss`` compares every sample with every other: on 4 ranks it
    is computed on the gathered batch and equals the global step."""
    ranks, refs, _ = run
    got = [_result(ranks, 'steps', r)[('mmd', 4)] for r in range(WORLD)]
    _same_on_every_rank(got)
    _check_step(got[0], refs['mmd'], 2e-4, 1e-6)


@pytest.mark.parametrize('width', [2, 4])
@pytest.mark.parametrize('kind', ['dropout', 'obs_given', 'obs_seeded'])
def test_mesh_random_steps_match_single_device(run, kind, width):
    """Steps that draw random numbers per sample: with dropout in both
    networks (each rank masks its rows as one device masks the global
    batch) against the port's single-device step; WithObs on a given
    mask against the JAX package's step, and on its sampler's masks (one
    for the whole batch, drawn from the shared seed) against the port's
    single-device step. Every rank the same losses and params."""
    ranks, refs, _ = run
    got = [_result(ranks, 'random', r)[(kind, width)]
           for r in range(width)]
    _same_on_every_rank(got)
    _check_step(got[0], refs[kind], 2e-4, 1e-6)


def test_mesh_solar_cc_steps(run):
    """SolarCC on 2 ranks: the generator's step at ``weight_gen_advers=0``
    against the JAX package's (its losses that read the random windows,
    the adversarial and the discriminator's, are left out), the full step
    against the port's single-device step."""
    ranks, refs, _ = run
    for what, ref, keys in (
            ('gen', 'solar_gen', ('loss_gen', 'loss_gen_content')),
            ('full', 'solar_full', None)):
        got = [_result(ranks, 'solar', r)[what] for r in range(2)]
        _same_on_every_rank(got)
        _check_step(got[0], refs[ref], 2e-4, 1e-6, keys)


@pytest.mark.parametrize('width', [2, 4])
def test_dcn_train_step(run, width):
    """Every rank of the group prints the SAME finite global losses."""
    ranks, _, _ = run
    losses = [_result(ranks, 'dcn', r)[width] for r in range(width)]
    assert all(x == losses[0] for x in losses[1:])
    assert 'nan' not in losses[0].lower() and 'loss_gen=' in losses[0]


def test_mesh_data_parallel_training(run):
    """An epoch of ``train`` on 4 ranks changes the weights, gives every
    rank the same finite history (validation reduced too) and params, and
    only the first rank writes its checkpoint."""
    ranks, _, _ = run
    res = [_result(ranks, 'train_loop', r) for r in range(WORLD)]
    assert not np.allclose(res[0]['before'], res[0]['after'])
    for r in res:
        assert r['history'] == res[0]['history']
        assert all(np.isfinite(v).all() for v in r['history'].values())
        for a, b in zip(_leaves(r['params']), _leaves(res[0]['params'])):
            np.testing.assert_array_equal(a, b)
    assert [r['wrote'] for r in res] == [True, False, False, False]


def test_mesh_dc_training_shares_bin_weights(run):
    """Sup3rGanDC on 2 ranks: both ranks end the epoch with the same
    history and the same (rank-averaged) bin weights."""
    ranks, _, _ = run
    res = [_result(ranks, 'dc', r) for r in range(2)]
    assert res[0]['history'] == res[1]['history']
    assert all(np.isfinite(v).all() for v in res[0]['history'].values())
    np.testing.assert_allclose(res[0]['weights'][0], res[1]['weights'][0],
                               rtol=1e-6)
    assert res[0]['weights'][1] == res[1]['weights'][1]


def test_mesh_replicated_and_batch_sharded(run):
    ranks, _, _ = run
    res = [_result(ranks, 'replicated', r) for r in range(WORLD)]
    assert not all(np.array_equal(a, b) for a, b in zip(
        _leaves(res[1]['seeded']), _leaves(res[0]['seeded'])))
    for r, got in enumerate(res):
        for a, b in zip(_leaves(got['params']), _leaves(res[0]['seeded'])):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got['batch'], LR[2 * r:2 * r + 2])
        assert got['broadcast']['broadcast_ops'] > 0


def test_dual_batch_handler_training(run):
    ranks, _, _ = run
    for r in range(2):
        res = _result(ranks, 'feeds', r)
        assert res['paired_s_enhance'] == 2
        assert np.isfinite(res['paired_loss'])


def test_device_transform_training_matches_host(run):
    ranks, _, _ = run
    for r in range(2):
        losses = _result(ranks, 'feeds', r)['losses']
        np.testing.assert_allclose(losses[True], losses[False], rtol=1e-4)


def test_dual_pipeline_from_files(run):
    ranks, _, _ = run
    for r in range(2):
        assert np.isfinite(_result(ranks, 'feeds', r)['files_loss'])


def test_mesh_2d_sharding_layout(run):
    ranks, _, _ = run
    arr = np.arange(4 * 8 * 6 * 2, dtype=np.float32).reshape(4, 8, 6, 2)
    for r in range(WORLD):
        res = _result(ranks, 'layout', r)
        i, j = res['coords']
        want = arr[2 * i:2 * i + 2, 4 * j:4 * j + 4]
        assert res['block'].shape == (2, 4, 6, 2)
        np.testing.assert_array_equal(res['block'], want)
        np.testing.assert_array_equal(res['full'], want)
        np.testing.assert_array_equal(res['weights'],
                                      np.arange(2 * i, 2 * i + 2))
        assert len(res['errors']) == 2
        assert all('not divisible' in e for e in res['errors'])
        assert res['axis'] == 'space'


if __name__ == '__main__':
    run_rank_scenarios(SCENARIOS, *sys.argv[1:])
