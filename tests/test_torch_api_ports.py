"""The JAX package's public names that the port gained last, each held to
its JAX counterpart on the same seeded numpy inputs:

- ``GridDataset.dims`` / ``qa`` / ``compute`` / ``flatten`` /
  ``unflatten`` (equal; ``qa`` at rtol 1e-6, with NaNs in the data);
- ``ops.interp.bilinear_resize`` on tensors with an explicit device, up
  and down (rtol 1e-6);
- ``Sup3rGan.generator_weights`` / ``discriminator_weights`` / ``weights``
  (the port's parameter tensors, ``gen_params``' layout; equal values);
- ``AbstractSingleModel.save_network_params`` / ``load_network_params``
  (byte-equal files, each package loads the other's, the same ValueError
  text for a single-stage ``Sup3rObsModel`` checkpoint);
- ``Network.apply(allow_pending_skips=)`` (a prefix cut inside a skip,
  rtol 1e-5) and ``Network.dtype_cast`` (floating params only);
- the ``make_fake_nc4_file`` / ``make_fake_flat_nc_file`` /
  ``make_fake_h5_file`` / ``make_fake_dual`` helpers (files from the same
  arguments and seed read back equal through both packages' loaders);
- ``SubpixelTailConv.alpha`` (the held tail block's slope) and the
  handlers' ``SUPPORTS_LAZY``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from sup3r_tpu.configs import get_config as jax_config
from sup3r_tpu.models import Sup3rGan as JaxGan
from sup3r_tpu.models.abstract import AbstractSingleModel as JaxAbstract
from sup3r_tpu.models.network import Network as JaxNetwork
from sup3r_tpu.ops.interp import bilinear_resize as jax_bilinear_resize
from sup3r_tpu.preprocessing import loaders as jax_loaders
from sup3r_tpu.preprocessing.grid import GridDataset as JaxGrid
from sup3r_tpu.utilities import RANDOM_GENERATOR as JAX_RNG
from sup3r_tpu.utilities import test_helpers as jax_helpers
from sup3r_tpu_torch.models import Sup3rGan
from sup3r_tpu_torch.models.abstract import AbstractSingleModel
from sup3r_tpu_torch.models.network import Network
from sup3r_tpu_torch.models.weights import moments_to_jax, params_from_jax
from sup3r_tpu_torch.ops.interp import bilinear_resize
from sup3r_tpu_torch.preprocessing import loaders
from sup3r_tpu_torch.preprocessing.grid import GridDataset
from sup3r_tpu_torch.utilities import RANDOM_GENERATOR
from sup3r_tpu_torch.utilities import test_helpers as helpers

torch.set_num_threads(1)

FEATURES = ['u_100m', 'v_100m', 'temperature_2m']


def _grids(nan=True):
    """The same (s1, s2, t, f) block with NaNs, lat_lon and times in a
    GridDataset of each package."""
    rng = np.random.default_rng(3)
    data = rng.standard_normal((6, 5, 8, 3)).astype(np.float32) * 3 + 1
    if nan:
        data[rng.random(data.shape) < 0.15] = np.nan
        data[..., 2] = np.nan
    lat_lon = rng.random((6, 5, 2)).astype(np.float32)
    times = pd.date_range('2023-01-01', periods=8, freq='h')
    return (GridDataset(data, FEATURES, lat_lon=lat_lon,
                        time_index=times.values),
            JaxGrid(data, FEATURES, lat_lon=lat_lon, time_index=times))


def test_grid_dims_and_compute():
    port, ref = _grids()
    assert port.dims == ref.dims
    assert port.compute() is port


@pytest.mark.parametrize('stats', [None, ('max', 'nan_perc')])
@pytest.mark.filterwarnings('ignore::RuntimeWarning')
def test_grid_qa_matches_with_nans(stats):
    """Per-feature stats with NaNs in the data (one feature all NaN)."""
    port, ref = _grids()
    kw = {} if stats is None else {'stats': stats}
    got, want = port.qa(**kw), ref.qa(**kw)
    assert list(got) == list(want)
    for f in want:
        assert list(got[f]) == list(want[f])
        for stat, value in want[f].items():
            np.testing.assert_allclose(got[f][stat], value, rtol=1e-6,
                                       equal_nan=True)


def test_grid_flatten_and_unflatten_match():
    port, ref = _grids(nan=False)
    (flat, coords), (jflat, jcoords) = port.flatten(), ref.flatten()
    np.testing.assert_array_equal(flat, jflat)
    np.testing.assert_array_equal(coords, jcoords)
    back = GridDataset.unflatten(flat, port.grid_shape, FEATURES,
                                 lat_lon=coords,
                                 time_index=port.time_index)
    jback = JaxGrid.unflatten(jflat, ref.grid_shape, FEATURES,
                              lat_lon=jcoords, time_index=ref.time_index)
    np.testing.assert_array_equal(back.data, jback.data)
    np.testing.assert_array_equal(back.lat_lon, jback.lat_lon)
    np.testing.assert_array_equal(back.data, port.data)
    np.testing.assert_array_equal(np.asarray(back.time_index.values),
                                  jback.time_index.values)


@pytest.mark.parametrize('shape,out', [
    ((6, 5, 3), (12, 10)), ((8, 8, 2), (4, 4)), ((7, 9, 4, 2), (14, 3)),
    ((5, 4), (11, 9)), ((12, 6, 1), (5, 13))])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_bilinear_resize_matches(shape, out, dtype):
    """On a tensor with an explicit device, against JAX's on the same
    array: float32 against the jax.numpy path, float64 against the numpy
    path (the JAX function dispatches on its input's array module)."""
    arr = np.random.default_rng(5).random(shape).astype(dtype)
    got = bilinear_resize(torch.as_tensor(arr, device='cpu'), *out)
    assert got.device.type == 'cpu' and got.dtype == getattr(torch, dtype)
    want = jax_bilinear_resize(jnp.asarray(arr) if dtype == 'float32'
                               else arr, *out)
    assert got.shape == want.shape == (*out, *shape[2:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(bilinear_resize(arr, *out).numpy(),
                               got.numpy(), rtol=0)


# ----------------------------------------------------------------------
# models
@pytest.fixture(scope='module')
def gan_pair(tmp_path_factory):
    """A seeded JAX Sup3rGan and the port's load of its save."""
    d = str(tmp_path_factory.mktemp('gan'))
    ref = JaxGan(jax_config('spatiotemporal/gen_3x_4x_2f'),
                 jax_config('spatiotemporal/disc_test'))
    ref.init_weights((1, 6, 6, 4, 2), (1, 18, 18, 16, 2))
    ref.meta.update(lr_features=['u_100m', 'v_100m'],
                    hr_out_features=['u_100m', 'v_100m'])
    ref.save(d)
    return ref, Sup3rGan.load(d, device='cpu')


def _same_tree(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))


@pytest.mark.parametrize('which', ['generator', 'discriminator'])
def test_network_weights_match(gan_pair, which):
    """``<network>_weights`` are the port's parameter tensors in the
    layout of ``gen_params`` (a tuple in ``parameters()`` order), equal
    per layer to the JAX package's params."""
    ref, port = gan_pair
    got = getattr(port, f'{which}_weights')
    short = 'gen' if which == 'generator' else 'disc'
    params = getattr(port, f'{short}_params')
    assert isinstance(got, tuple) and len(got) == len(params)
    assert all(a is b for a, b in zip(got, params))
    network = getattr(port, which)
    tree = moments_to_jax(network, got)
    _same_tree([tree[str(i)] for i in range(len(tree))],
               getattr(ref, f'{which}_weights'))
    both = port.weights
    assert list(both) == list(ref.weights) == ['generator', 'discriminator']
    assert all(a is b for a, b in zip(both[which], params))


def _obs_template():
    config = [{'class': 'Sup3rObsModel', 'name': 'u_100m_obs',
               'filters': 8}]
    template, _ = JaxNetwork(config).init(jax.random.PRNGKey(0),
                                          (1, 6, 6, 4))
    return config, template


def test_save_network_params_is_byte_equal(gan_pair, tmp_path):
    """The same params written by both packages give the same bytes:
    the JAX package's per-layer list, and the port's network (saved as
    ``params_to_jax`` gives it)."""
    ref, port = gan_pair
    params = jax.tree.map(np.asarray, ref.generator_weights)
    fj, fp, fn = (str(tmp_path / f'{n}.msgpack') for n in 'jpn')
    JaxAbstract.save_network_params(params, fj)
    AbstractSingleModel.save_network_params(params, fp)
    AbstractSingleModel.save_network_params(port.generator, fn)
    raw = open(fj, 'rb').read()
    assert open(fp, 'rb').read() == raw
    assert open(fn, 'rb').read() == raw
    # tensors as leaves, and a Sup3rObsModel's two-stage params
    torch_params = [{k: torch.tensor(v) for k, v in p.items()}
                    for p in params]
    AbstractSingleModel.save_network_params(torch_params, fp)
    assert open(fp, 'rb').read() == raw
    # bfloat16 leaves, as a ``dtype_cast`` gives them
    JaxAbstract.save_network_params(
        JaxNetwork([]).dtype_cast(ref.generator_weights, jnp.bfloat16), fj)
    AbstractSingleModel.save_network_params(
        Network.dtype_cast(torch_params, torch.bfloat16), fp)
    assert open(fp, 'rb').read() == open(fj, 'rb').read()
    _, template = _obs_template()
    JaxAbstract.save_network_params(template, fj)
    AbstractSingleModel.save_network_params(
        jax.tree.map(np.asarray, template), fp)
    assert open(fp, 'rb').read() == open(fj, 'rb').read()


def test_load_network_params_both_ways(gan_pair, tmp_path):
    """Each package loads what the other wrote, into its template's
    structure; the port's loaded list loads into a network."""
    ref, port = gan_pair
    params = jax.tree.map(np.asarray, ref.generator_weights)
    fj, fp = str(tmp_path / 'j.msgpack'), str(tmp_path / 'p.msgpack')
    JaxAbstract.save_network_params(params, fj)
    AbstractSingleModel.save_network_params(port.generator, fp)
    _same_tree(AbstractSingleModel.load_network_params(params, fj), params)
    _same_tree(AbstractSingleModel.load_network_params(port.generator, fj),
               params)
    _same_tree(JaxAbstract.load_network_params(ref.generator_weights, fp),
               params)
    fresh = Sup3rGan(jax_config('spatiotemporal/gen_3x_4x_2f'),
                     jax_config('spatiotemporal/disc_test'), device='cpu')
    fresh.init_weights((1, 6, 6, 4, 2), (1, 18, 18, 16, 2), seed=7)
    params_from_jax(fresh.generator,
                    AbstractSingleModel.load_network_params(
                        fresh.generator, fj))
    for a, b in zip(fresh.generator_weights, port.generator_weights):
        assert torch.equal(a, b)


def test_single_stage_obs_checkpoint_raises_the_same_error(tmp_path):
    """tests/models/test_round4_model_fixes.py:189's case: a checkpoint
    of the earlier single-kernel Sup3rObsModel(filters=...) form against
    the two-stage template raises the JAX package's ValueError, word for
    word; the port's own network template raises it too."""
    config, template = _obs_template()
    old = list(template)
    old[0] = {'kernel': np.zeros((2, 4), np.float32),
              'bias': np.zeros(4, np.float32)}
    fj, fp = str(tmp_path / 'j.msgpack'), str(tmp_path / 'p.msgpack')
    JaxAbstract.save_network_params(old, fj)
    AbstractSingleModel.save_network_params(old, fp)
    errors = []
    for load, fn in ((JaxAbstract.load_network_params, fj),
                     (AbstractSingleModel.load_network_params, fj),
                     (AbstractSingleModel.load_network_params, fp)):
        with pytest.raises(ValueError, match='Sup3rObsModel') as err:
            load(template, fn)
        errors.append(str(err.value).replace(fp, fj))
    assert errors[1] == errors[0] == errors[2]
    net = Network(config)
    net.init((1, 6, 6, 4), torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match='two-stage projection'):
        AbstractSingleModel.load_network_params(net, fj)
    # a structure mismatch without kernel_out is flax's error, unwrapped
    with pytest.raises(ValueError, match='size of the list') as err:
        AbstractSingleModel.load_network_params(old + old, fj)
    with pytest.raises(ValueError, match='size of the list') as jerr:
        JaxAbstract.load_network_params(old + old, fj)
    assert str(err.value) == str(jerr.value)


SKIP_NET = [
    {'class': 'Conv2D', 'filters': 4, 'kernel_size': 3, 'strides': 1,
     'padding': 'same'},
    {'class': 'SkipConnection', 'name': 'a'},
    {'class': 'Conv2D', 'filters': 4, 'kernel_size': 3, 'strides': 1,
     'padding': 'same'},
    {'class': 'LeakyReLU', 'alpha': 0.2},
    {'class': 'Conv2D', 'filters': 4, 'kernel_size': 3, 'strides': 1,
     'padding': 'same'},
    {'class': 'SkipConnection', 'name': 'a'},
    {'class': 'Conv2D', 'filters': 2, 'kernel_size': 3, 'strides': 1,
     'padding': 'same'}]


@pytest.mark.parametrize('cut', [2, 4, 5, len(SKIP_NET)])
def test_apply_allow_pending_skips_matches(cut):
    """A layer-list prefix cut inside the residual span raises without
    ``allow_pending_skips`` in both packages and runs with it, equal to
    the JAX prefix on the same params (rtol 1e-5)."""
    config = SKIP_NET[:cut]
    x = np.random.default_rng(2).standard_normal((2, 6, 5, 3)).astype(
        np.float32)
    jnet = JaxNetwork(config)
    params, _ = jnet.init(jax.random.PRNGKey(1), x.shape)
    net = Network(config)
    net.init(x.shape, torch.Generator().manual_seed(0))
    params_from_jax(net, jax.tree.map(np.asarray, params))
    pending = 1 < cut < 6
    if pending:
        with pytest.raises(ValueError, match='Unclosed skip'):
            net.apply(torch.as_tensor(x))
        with pytest.raises(ValueError, match='Unclosed skip'):
            jnet.apply(params, x)
    with torch.no_grad():
        got = net.apply(torch.as_tensor(x), allow_pending_skips=True)
    want = jnet.apply(params, x, allow_pending_skips=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize('dtype', ['bfloat16', 'float16'])
def test_dtype_cast_floating_params_only(dtype):
    """Floating leaves cast, integer leaves pass through, the structure
    (a per-layer list of dicts, or ``gen_params``' tuple) kept: equal to
    the JAX package's cast of the same params."""
    jnet = JaxNetwork(SKIP_NET)
    params, _ = jnet.init(jax.random.PRNGKey(1), (1, 6, 5, 3))
    params = [dict(p, step=np.arange(3, dtype=np.int32)) if p else p
              for p in params]
    want = jnet.dtype_cast(params, getattr(jnp, dtype))
    tparams = [{k: torch.tensor(np.asarray(v)) for k, v in p.items()}
               for p in params]
    for spec in (dtype, getattr(torch, dtype)):
        got = Network.dtype_cast(tparams, spec)
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for k in w:
                assert str(g[k].dtype).split('.')[-1] == str(w[k].dtype)
                np.testing.assert_array_equal(
                    g[k].float().numpy(),
                    np.asarray(w[k]).astype(np.float32))
    net = Network(SKIP_NET)
    net.init((1, 6, 5, 3), torch.Generator().manual_seed(0))
    cast = net.dtype_cast(tuple(net.parameters()), dtype)
    assert isinstance(cast, tuple)
    assert all(t.dtype == getattr(torch, dtype) for t in cast)
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_subpixel_tail_alpha_is_the_tail_s():
    """JAX's ``SubpixelTailConv(alpha=)`` is the fused tail conv's slope;
    the port's layer reads it off the tail block it holds."""
    from sup3r_tpu_torch.models.fuse import SubpixelTailConv

    class Tail(torch.nn.Module):
        alpha = 0.2

    assert SubpixelTailConv(2, Tail()).alpha == 0.2
    assert SubpixelTailConv(2, Tail(), alpha_prev=0.1).alpha == 0.2


def test_supports_lazy_matches():
    from sup3r_tpu.preprocessing import data_handlers as jax_dh
    from sup3r_tpu_torch.preprocessing import data_handlers as dh

    for name in ('DataHandler', 'DailyDataHandler', 'DataHandlerNCforCC',
                 'DataHandlerH5SolarCC', 'DataHandlerNCforCCwithPowerLaw'):
        assert (getattr(dh, name).SUPPORTS_LAZY
                is getattr(jax_dh, name).SUPPORTS_LAZY is True)


# ----------------------------------------------------------------------
# the fake-data helpers
def _seed(seed):
    for rng in (RANDOM_GENERATOR, JAX_RNG):
        rng.bit_generator.state = np.random.default_rng(
            seed).bit_generator.state


def _read(loader_module, path):
    """What a package's loader reads from ``path``: every variable,
    lat/lon and the time index as numpy arrays."""
    loader = loader_module.Loader(path)
    out = {}
    if hasattr(loader, 'data'):
        data = loader.data
        out['lat_lon'] = data.lat_lon
        for name in data.features:
            out[name] = np.asarray(data[name])
            out[f'{name}_dims'] = data.dims(name)
        times = data.time_index
    else:
        out['lat_lon'] = loader.lat_lon_flat
        out['elevation'] = loader.elevation
        for name in loader.features:
            out[name] = np.asarray(loader.get(name))
        times = loader.time_index
    out['times'] = (None if times is None else np.asarray(
        getattr(times, 'values', times)).astype('datetime64[ns]'))
    return out


def _same_reads(port_file, jax_file):
    reads = [_read(mod, path) for mod in (loaders, jax_loaders)
             for path in (port_file, jax_file)]
    want = reads[-1]
    for got in reads[:-1]:
        assert sorted(got) == sorted(want)
        for k in want:
            if want[k] is None or isinstance(want[k], tuple):
                assert got[k] == want[k], k
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('kwargs', [
    {}, {'levels': [1000.0, 850.0], 'ascending_lats': True},
    {'scale_factor': 0.01, 'fill_value': -999, 'freq': '30min'},
    {'calendar': 'noleap', 'start': '2023-01-01 06:00'},
    {'include_time': False, 'var_attrs': {'u_100m': {'units': 'm s-1'}}}])
def test_make_fake_nc4_file_reads_back_equal(tmp_path, kwargs):
    files = []
    for name, mod in (('port', helpers), ('jax', jax_helpers)):
        _seed(11)
        files.append(mod.make_fake_nc4_file(
            str(tmp_path / f'{name}.nc'), (5, 4, 6), ['u_100m', 'v_100m'],
            **kwargs))
    _same_reads(*files)


@pytest.mark.parametrize('kwargs', [
    {}, {'space_first': True, 'with_topography': True, 'freq': 'D'},
    {'data': {'u_100m': np.arange(120.0).reshape(6, 5, 4)}}])
def test_make_fake_flat_nc_file_reads_back_equal(tmp_path, kwargs):
    files = []
    for name, mod in (('port', helpers), ('jax', jax_helpers)):
        _seed(12)
        files.append(mod.make_fake_flat_nc_file(
            str(tmp_path / f'{name}.nc'), (5, 4, 6), ['u_100m', 'v_100m'],
            **kwargs))
    _same_reads(*files)


@pytest.mark.parametrize('kwargs', [
    {}, {'start': '2023-01-01 08:00', 'freq': '30min',
         'scale_factor': 10.0, 'value_range': (-5, 5)}])
def test_make_fake_h5_file_reads_back_equal(tmp_path, kwargs):
    files = []
    for name, mod in (('port', helpers), ('jax', jax_helpers)):
        _seed(13)
        files.append(mod.make_fake_h5_file(
            str(tmp_path / f'{name}.h5'), (4, 5, 7),
            ['windspeed_100m', 'winddirection_100m'], **kwargs))
    _same_reads(*files)


@pytest.mark.parametrize('with_obs', [False, True])
def test_make_fake_dual_matches(with_obs):
    pairs = []
    for mod in (helpers, jax_helpers):
        _seed(14)
        pairs.append(mod.make_fake_dual((4, 3, 5), 2, 3, FEATURES[:2],
                                        with_obs=with_obs))
    got, want = pairs
    assert list(got.members) == list(want.members)
    for g, w in zip(got, want):
        assert g.features == w.features
        np.testing.assert_array_equal(g.data, w.data)
        np.testing.assert_array_equal(g.lat_lon, w.lat_lon)
        np.testing.assert_array_equal(np.asarray(g.time_index.values),
                                      w.time_index.values)
