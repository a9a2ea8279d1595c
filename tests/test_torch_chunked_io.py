"""``ForwardPassStrategy(chunked_io=True)`` in the port against its own
eager pass and against the JAX package's ``chunked_io`` pass, on the
fixtures of tests/data_handlers/test_lazy_loading.py: each chunk reads
and derives only its padded window. Chunk inputs equal the eager
strategy's (bit-exact where the JAX tests demand it, else rtol 1e-6);
pass outputs agree with the eager pass within 1e-6 of their largest
magnitude and with the JAX package's within 1e-4 (the repo's fp32 parity
bar). Also: the GCM handler with NSRDB clearsky through ``chunked_io``,
flattened inputs, the grid / time remap refusal, and one train step fed
by lazy handlers held to the JAX package's step."""

import warnings

import numpy as np
import pytest
import torch

from sup3r_tpu.pipeline import ForwardPass as JaxForwardPass
from sup3r_tpu.pipeline import ForwardPassStrategy as JaxStrategy
from sup3r_tpu.preprocessing import DataHandler as JaxDataHandler
from sup3r_tpu.preprocessing import Sampler as JaxSampler
from sup3r_tpu.preprocessing.batch_queues import (
    SingleBatchQueue as JaxQueue,
)
from sup3r_tpu.utilities import RANDOM_GENERATOR as JAX_RNG
from sup3r_tpu.utilities.test_helpers import (
    make_fake_flat_nc_file,
    make_fake_h5_file,
    make_fake_nc4_file,
)
from sup3r_tpu.utilities.test_helpers import (
    make_fake_nc_file as jax_fake_nc_file,
)
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from sup3r_tpu_torch.preprocessing import DataHandler, Sampler
from sup3r_tpu_torch.preprocessing.batch_queues import SingleBatchQueue
from sup3r_tpu_torch.utilities import RANDOM_GENERATOR
from sup3r_tpu_torch.utilities.test_helpers import make_fake_nc_file
from tests.data_handlers.test_lazy_loading import _small_gan
from tests.forward_pass.test_forward_pass import _save_model, _st_gen_config
from test_torch_train_step import _compare_networks, _pair

torch.set_num_threads(1)

RTOL = 1e-4


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    tol = rtol * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def _strategies(model_dir, **kwargs):
    """(port eager, port chunked_io, JAX chunked_io) strategies."""
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        port_kw = {'model_dir': model_dir, 'device': 'cpu'}
        eager = ForwardPassStrategy(model_kwargs=port_kw, **kwargs)
        lazy = ForwardPassStrategy(model_kwargs=port_kw, chunked_io=True,
                                   **kwargs)
        jax = JaxStrategy(model_kwargs={'model_dir': model_dir},
                          chunked_io=True, **kwargs)
    assert (eager.fwp_slicer.n_chunks == lazy.fwp_slicer.n_chunks
            == jax.fwp_slicer.n_chunks)
    return eager, lazy, jax


def _hold_passes(eager, lazy, jax, exact=False):
    """Chunk inputs equal (exactly or at rtol 1e-6); the lazy pass equals
    the eager one within 1e-6 of max and the JAX pass within 1e-4."""
    for idx in range(eager.fwp_slicer.n_chunks):
        a, _ = eager.prep_chunk_data(idx)
        b, _ = lazy.prep_chunk_data(idx)
        c, _ = jax.prep_chunk_data(idx)
        if exact:
            np.testing.assert_array_equal(b, a)
            np.testing.assert_array_equal(b, c)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6)
            np.testing.assert_allclose(b, c, rtol=1e-6)
    out_e = ForwardPass.run(eager, 0)
    out_l = ForwardPass.run(lazy, 0)
    out_j = JaxForwardPass.run(jax, 0)
    assert sorted(out_l) == sorted(out_e) == sorted(out_j)
    for key in out_e:
        _close(out_l[key], out_e[key], 1e-6, ('eager', key))
        _close(out_l[key], out_j[key], RTOL, ('jax', key))


@pytest.fixture(scope='module')
def small_gan(tmp_path_factory):
    return _small_gan(tmp_path_factory.mktemp('gan'))


@pytest.mark.parametrize('kind', ['nc4', 'nc3', 'flat_nc', 'flat_h5',
                                  'multifile_h5', 'nc4_time_slice'])
def test_chunked_io_pass_matches_eager_and_jax(tmp_path, small_gan, kind):
    """NetCDF4 (windowed h5py reads), NetCDF3 (read whole per chunk, as
    the JAX package reads it), flattened NetCDF and H5 (gid windows),
    multi-file H5 given out of order, and a narrowed time_slice."""
    kwargs = dict(fwp_chunk_shape=(6, 6, 3), spatial_pad=1,
                  temporal_pad=1, out_pattern=None)
    exact = False
    if kind in ('nc4', 'nc4_time_slice'):
        kwargs['file_paths'] = make_fake_nc4_file(
            str(tmp_path / 'in.nc'), (12, 12, 8), ['u100', 'v100'])
        if kind == 'nc4_time_slice':
            kwargs['input_handler_kwargs'] = {'time_slice': slice(2, 7)}
    elif kind == 'nc3':
        kwargs['file_paths'] = make_fake_nc_file(
            str(tmp_path / 'in.nc'), (12, 12, 6), ['u_100m', 'v_100m'])
    elif kind == 'flat_nc':
        kwargs.update(fwp_chunk_shape=(5, 5, 4), temporal_pad=0,
                      file_paths=make_fake_flat_nc_file(
                          str(tmp_path / 'in_flat.nc'), (10, 10, 4),
                          ['u_100m', 'v_100m']))
        exact = True
    elif kind == 'flat_h5':
        kwargs.update(fwp_chunk_shape=(5, 5, 4), temporal_pad=0,
                      file_paths=make_fake_h5_file(
                          str(tmp_path / 'in.h5'), (10, 10, 4),
                          ['u_100m', 'v_100m']))
    else:
        feb = make_fake_h5_file(str(tmp_path / 'a_feb.h5'), (10, 10, 4),
                                ['u_100m', 'v_100m'], start='2023-02-01')
        jan = make_fake_h5_file(str(tmp_path / 'b_jan.h5'), (10, 10, 4),
                                ['u_100m', 'v_100m'], start='2023-01-01')
        kwargs.update(fwp_chunk_shape=(5, 5, 6), file_paths=[feb, jan])
    eager, lazy, jax = _strategies(small_gan, **kwargs)
    if kind.startswith('flat'):
        assert isinstance(lazy._meta_rast.raster_index, np.ndarray)
    if kind == 'multifile_h5':
        assert np.asarray(lazy.input_handler.time_index)[0] < np.datetime64(
            '2023-02-01')
    _hold_passes(eager, lazy, jax, exact=exact)


def test_chunked_io_spatiotemporal_batched_pass(tmp_path):
    """A 5D generator through the device-batched dispatch: chunked_io
    inputs feed the same batches as the eager pass."""
    model_dir = _save_model(str(tmp_path / 'st'), _st_gen_config(), 3,
                            4)[0]
    inp = make_fake_nc_file(str(tmp_path / 'in.nc'), (8, 8, 8),
                            ['u_100m', 'v_100m'])
    eager, lazy, jax = _strategies(
        model_dir, file_paths=inp, fwp_chunk_shape=(4, 4, 4),
        spatial_pad=1, temporal_pad=1, device_batch_size=2,
        out_pattern=None)
    _hold_passes(eager, lazy, jax, exact=True)


@pytest.mark.parametrize('kwargs', [{'hr_spatial_coarsen': 2},
                                    {'time_roll': 1}, {'time_shift': -30}])
def test_chunked_io_rejects_grid_remaps(tmp_path, small_gan, kwargs):
    """Remaps of the global grid or time axis cannot be windowed: both
    packages refuse them with an AssertionError naming chunked_io."""
    inp = make_fake_nc4_file(str(tmp_path / 'in.nc'), (8, 8, 4),
                             ['u100', 'v100'])
    kw = dict(file_paths=inp, fwp_chunk_shape=(8, 8, 4), out_pattern=None,
              input_handler_kwargs=kwargs, chunked_io=True)
    with pytest.raises(AssertionError, match='chunked_io'):
        ForwardPassStrategy(model_kwargs={'model_dir': small_gan,
                                          'device': 'cpu'}, **kw)
    with pytest.raises(AssertionError, match='chunked_io'):
        JaxStrategy(model_kwargs={'model_dir': small_gan}, **kw)


def _csr_gan(tmp_path):
    """The JAX test's clearsky_ratio model (2D, s_enhance 2)."""
    from sup3r_tpu.models import Sup3rGan as JaxGan

    features = ['clearsky_ratio']
    gen = [{'class': 'Conv2D', 'filters': 4, 'kernel_size': 3,
            'strides': 1, 'padding': 'same'},
           {'class': 'SpatialExpansion', 'spatial_mult': 2},
           {'class': 'Conv2D', 'filters': 1, 'kernel_size': 3,
            'strides': 1, 'padding': 'same'}]
    disc = [{'class': 'Conv2D', 'filters': 4, 'kernel_size': 3,
             'strides': 2, 'padding': 'same'},
            {'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]
    model = JaxGan(gen, disc)
    model.meta.update(lr_features=features, hr_out_features=features,
                      s_enhance=2, t_enhance=1,
                      input_resolution={'spatial': '100km',
                                        'temporal': '1440min'})
    model.set_norm_stats({f: 0.5 for f in features},
                         {f: 0.2 for f in features})
    model.init_weights((1, 4, 4, 1), (1, 8, 8, 1))
    model_dir = str(tmp_path / 'csr_model')
    model.save(model_dir)
    return model_dir


@pytest.mark.parametrize('scale', ['computed', 'npy'])
def test_chunked_io_with_nc_for_cc(tmp_path, scale):
    """chunked_io composes with the GCM handler: the strategy computes
    the full-domain per-pixel clearsky scale once (or takes it as an
    .npy path) and each chunk regrids the NSRDB clearsky on its window;
    chunk inputs and outputs equal the eager pass and the JAX package's
    chunked_io pass."""
    gcm = jax_fake_nc_file(str(tmp_path / 'rsds.nc'), (8, 8, 4), ['rsds'],
                           freq='D')
    nsrdb = make_fake_h5_file(
        str(tmp_path / 'nsrdb.h5'), (10, 10, 48), ['clearsky_ghi'],
        freq='30min', value_range=(0, 1000),
        lat_range=(40.2, 38.9), lon_range=(-105.7, -104.2))
    ihk = {'nsrdb_source_fp': nsrdb, 'nsrdb_agg': 2}
    if scale == 'npy':
        fp = str(tmp_path / 'scale.npy')
        np.save(fp, np.linspace(0.5, 1.5, 64, dtype=np.float32).reshape(
            8, 8))
        ihk['clearsky_scale'] = fp
    eager, lazy, jax = _strategies(
        _csr_gan(tmp_path), file_paths=gcm,
        input_handler_name='DataHandlerNCforCC', input_handler_kwargs=ihk,
        fwp_chunk_shape=(4, 4, 4), spatial_pad=1, temporal_pad=0,
        out_pattern=None)
    np.testing.assert_array_equal(lazy._chunk_ihk['clearsky_scale'],
                                  jax._chunk_ihk['clearsky_scale'])
    for idx in range(eager.fwp_slicer.n_chunks):
        a, _ = eager.prep_chunk_data(idx)
        b, _ = lazy.prep_chunk_data(idx)
        c, _ = jax.prep_chunk_data(idx)
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(b, c)
    out_l = ForwardPass.run(lazy, 0)
    out_j = JaxForwardPass.run(jax, 0)
    for key in out_j:
        _close(out_l[key], out_j[key], RTOL, key)


def _reseed(seed):
    for rng in (RANDOM_GENERATOR, JAX_RNG):
        rng.bit_generator.state = np.random.default_rng(
            seed).bit_generator.state


def test_lazy_fed_train_step_matches_jax(tmp_path):
    """Lazy handlers feed the same batches as eager ones (single-threaded
    queues, both packages' RANDOM_GENERATOR reseeded alike), and one
    train step on the first lazy batch equals the JAX package's step on
    its own lazy batch within 1e-4 of each tensor's largest magnitude."""
    inp = make_fake_nc4_file(str(tmp_path / 'in.nc'), (16, 16, 24),
                             ['u100', 'v100'])
    feats = ['u_100m', 'v_100m']
    queues = []
    for handler_cls, sampler_cls, queue_cls, mode in (
            (DataHandler, Sampler, SingleBatchQueue, 'lazy'),
            (DataHandler, Sampler, SingleBatchQueue, 'eager'),
            (JaxDataHandler, JaxSampler, JaxQueue, 'lazy')):
        handler = handler_cls(inp, features=feats, mode=mode)
        queues.append(queue_cls(
            [sampler_cls(handler.data, (12, 12, 12))], batch_size=2,
            s_enhance=3, t_enhance=4, mode=mode,
            transform_kwargs={'temporal_coarsening_method': 'average'}))
    batches = []
    for queue in queues:
        _reseed(5)
        batches.append(queue.post_proc(queue.sample_batch()))
    (lr, hr), (lr_e, hr_e), (lr_j, hr_j) = batches
    np.testing.assert_array_equal(hr, hr_e)
    np.testing.assert_array_equal(hr, hr_j)
    np.testing.assert_array_equal(lr, lr_j)
    # the lazy samples stack into another memory layout than the eager
    # ones, so the LR average sums in another order: within an ulp, as in
    # the JAX package itself
    np.testing.assert_allclose(lr, lr_e, rtol=1e-6, atol=0)
    assert lr.shape == (2, 4, 4, 3, 2) and hr.shape == (2, 12, 12, 12, 2)

    jax_model, port = _pair('spatiotemporal')
    for model, (x, y) in ((port, (lr, hr)), (jax_model, (lr_j, hr_j))):
        model.run_gradient_descent(np.asarray(x, np.float32),
                                   np.asarray(y, np.float32),
                                   train_gen=True, train_disc=True)
    _compare_networks(jax_model, port)
