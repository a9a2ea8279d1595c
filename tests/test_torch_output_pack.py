"""The port's device output pack, memory planner and checkpoint codec
against the JAX package's: ``pack_chunks`` (torch, on the CPU) matches
the JAX package's jitted pack within one storage quantum with equal
output-check statistics; ``resolve_device_batch_size`` resolves the same
batch at the same memory budget; the msgpack codec writes the bytes the
``msgpack`` package writes; save directories load both ways with
``generate`` equal at the fp32 parity bar."""

import os

import jax
import msgpack
import numpy as np
import pytest
import torch

from sup3r_tpu.configs import generator_st, get_config
from sup3r_tpu.models import Sup3rGan as JaxGan
from sup3r_tpu.ops.output_pack import pack_chunks as jax_pack_chunks
from sup3r_tpu.ops.output_pack import pack_plan as jax_pack_plan
from sup3r_tpu.pipeline.memory import (
    resolve_device_batch_size as jax_resolve,
)
from sup3r_tpu.postprocessing.writers import OutputHandlerH5 as JaxH5
from sup3r_tpu.utilities.utilities import get_dset_attrs
from sup3r_tpu_torch.models import Sup3rGan
from sup3r_tpu_torch.models.weights import (
    load_jax_checkpoint,
    packb,
    unpackb,
)
from sup3r_tpu_torch.ops.output_pack import (
    fetch_stats,
    pack_chunks,
    pack_plan,
    theta_for,
)
from sup3r_tpu_torch.pipeline.memory import resolve_device_batch_size

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
FEATURES = ['u_100m', 'v_100m']
LR_SHAPE = (1, 6, 6, 4, 2)
HR_SHAPE = (1, 18, 18, 16, 2)


def _grid(s1, s2, descending=True):
    lats = (np.linspace(40, 39, s1) if descending
            else np.linspace(39, 40, s1))
    return np.dstack(np.meshgrid(
        lats, np.linspace(-105, -104, s2),
        indexing='ij')).astype(np.float32)


def _host_pack(data, features, lat_lon, invert_uv):
    """The host transform + quantization, as the H5 writer does it."""
    d, names = JaxH5._transform_output(data.copy(), list(features),
                                       lat_lon, max_workers=1,
                                       invert_uv=invert_uv)
    s1, s2, t = d.shape[:3]
    out = []
    for i, f in enumerate(names):
        attrs, dtype = get_dset_attrs(f)
        flat = d[..., i].reshape(s1 * s2, t).T
        out.append(np.round(flat * attrs['scale_factor']).astype(dtype))
    return out


@pytest.mark.parametrize('invert_uv', [True, False])
@pytest.mark.parametrize('descending', [True, False])
def test_pack_chunks_matches_jax(invert_uv, descending):
    rng = np.random.default_rng(7)
    n, s1, s2, t = 3, 6, 5, 8
    out = rng.normal(0, 8, (n, s1, s2, t, 2)).astype(np.float32)
    out[1, ..., 1] = 2.5  # a constant channel
    out[2, 0, 0, 0, 0] = 200.0  # beyond the u / windspeed limit
    lat_lon = _grid(s1, s2, descending)
    invert_lat = not descending
    names, pairs, quant = pack_plan(FEATURES, invert_uv)
    assert (names, pairs, quant) == jax_pack_plan(FEATURES, invert_uv)
    theta = np.stack([theta_for(lat_lon, invert_lat)] * n)
    packed, stats = pack_chunks(torch.from_numpy(out),
                                torch.from_numpy(theta), pairs, quant,
                                invert_lat)
    want_packed, want_stats = jax_pack_chunks(out, theta, pairs, quant,
                                              invert_lat)
    for got, want, q in zip(packed, want_packed, quant):
        got = got.numpy()
        assert got.dtype == np.dtype(q[0])
        diff = got.astype(np.int64) - np.asarray(want).astype(np.int64)
        assert np.abs(diff).max() <= 1
    got_stats = fetch_stats(stats)
    for key in ('nan_any', 'ch_const', 'ch_first'):
        np.testing.assert_array_equal(got_stats[key],
                                      np.asarray(want_stats[key]))
    for key in ('ch_min', 'ch_max'):
        np.testing.assert_allclose(got_stats[key],
                                   np.asarray(want_stats[key]),
                                   rtol=1e-5, atol=1e-4)
    # and the host transform, chunk by chunk (the clip of the
    # out-of-range value included)
    for j in range(n):
        for got, want in zip(packed, _host_pack(out[j], FEATURES, lat_lon,
                                                invert_uv)):
            diff = got[j].numpy().astype(np.int64) - want.astype(np.int64)
            assert np.abs(diff).max() <= 1


def test_pack_stats_flag_nan():
    out = np.ones((2, 3, 3, 4, 2), np.float32)
    out[1, 2, 1, 3, 0] = np.nan
    _, pairs, quant = pack_plan(FEATURES, False)
    _, stats = pack_chunks(torch.from_numpy(out),
                           torch.zeros((2, 3, 3)), pairs, quant, False)
    stats = fetch_stats(stats)
    np.testing.assert_array_equal(stats['nan_any'], [False, True])
    np.testing.assert_array_equal(stats['ch_const'][0], [True, True])


def _models(seed=0):
    gen = generator_st(2, (3,), (2, 2), filters=8, n_resblocks=1)
    disc = get_config('spatiotemporal/disc_test')
    kw = dict(meta={'lr_features': list(FEATURES),
                    'hr_out_features': list(FEATURES)},
              means={'u_100m': 0.5, 'v_100m': -0.2},
              stdevs={'u_100m': 0.3, 'v_100m': 0.7})
    jmodel = JaxGan(gen, disc, **kw)
    jmodel.init_weights(LR_SHAPE, HR_SHAPE, seed=seed)
    model = Sup3rGan(gen, disc, device='cpu', **kw)
    model.init_weights(LR_SHAPE, HR_SHAPE, seed=seed)
    return jmodel, model


@pytest.fixture(scope='module')
def models():
    return _models()


@pytest.mark.parametrize('hbm_mb', [1, 64, 1024, 16 * 1024])
def test_resolve_device_batch_size_matches(models, hbm_mb):
    jmodel, model = models
    for padded in ((20, 20, 24), (8, 8, 10)):
        assert resolve_device_batch_size(
            model, padded, 2, hbm_bytes=hbm_mb * 2 ** 20) == jax_resolve(
            jmodel, padded, 2, hbm_bytes=hbm_mb * 2 ** 20)


def test_auto_batch_needs_a_budget_on_the_cpu(models):
    _, model = models
    with pytest.raises(ValueError, match='hbm_bytes'):
        resolve_device_batch_size(model, (8, 8, 10), 2)


def _ext(obj):
    if isinstance(obj, np.ndarray):
        return msgpack.ExtType(1, msgpack.packb(
            (obj.shape, obj.dtype.name, obj.tobytes('C')),
            use_bin_type=True))
    raise TypeError(type(obj))


def _ext_hook(code, data):
    shape, dtype, buf = msgpack.unpackb(data, raw=False)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


@pytest.mark.parametrize('obj', [
    {'0': {}, '1': {'bias': np.zeros(3, np.float32),
                    'kernel': np.arange(24, dtype=np.float32).reshape(
                        1, 2, 3, 4)}},
    [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -128,
     -129, -40000, -2 ** 40, 1.5, -0.0, None, True, False],
    {'s': 'x' * 31, 'm': 'y' * 32, 'l': 'z' * 70000, 'b': b'\x00' * 300,
     'n': [list(range(15)), list(range(16)), list(range(70000))]},
    {str(i): np.full((i + 1,), i, np.float64) for i in range(20)},
    {'big': np.random.default_rng(0).standard_normal(
        (64, 70)).astype(np.float32), 'i': np.arange(5, dtype=np.int16)},
])
def test_codec_matches_msgpack(obj):
    data = packb(obj)
    assert data == msgpack.packb(obj, default=_ext, use_bin_type=True)
    np.testing.assert_equal(unpackb(data), msgpack.unpackb(
        data, ext_hook=_ext_hook, raw=False, strict_map_key=False))


def test_port_save_loads_in_jax_and_back(tmp_path):
    """A JAX save -> port load -> port save writes the JAX package's
    checkpoint bytes; the JAX package loads the port's save; all three
    generate the same output."""
    jmodel, _ = _models(seed=3)
    jmodel.save(str(tmp_path / 'jax'))
    model = Sup3rGan.load(str(tmp_path / 'jax'), device='cpu')
    model.save(str(tmp_path / 'port'))
    for name in ('model_gen.msgpack', 'model_disc.msgpack'):
        with open(tmp_path / 'jax' / name, 'rb') as a, \
                open(tmp_path / 'port' / name, 'rb') as b:
            assert a.read() == b.read(), name
    back = JaxGan.load(str(tmp_path / 'port'))
    lr = np.random.default_rng(1).standard_normal(LR_SHAPE).astype(
        np.float32)
    want = np.asarray(jmodel.generate(lr))
    np.testing.assert_allclose(model.generate(lr), want, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(np.asarray(back.generate(lr)), want,
                               rtol=RTOL, atol=ATOL)
    for a, b in zip(jax.tree.leaves(back.disc_params),
                    jax.tree.leaves(jmodel.disc_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_initialized_save_loads_in_jax(tmp_path):
    """Weights the port drew itself (incl. the transposed-conv
    orientation of a spatial generator) reach the JAX package."""
    gen = get_config('spatial/gen_2x_2f')
    disc = [{'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]
    meta = {'lr_features': list(FEATURES),
            'hr_out_features': list(FEATURES)}
    model = Sup3rGan(gen, disc, meta=meta, device='cpu')
    model.init_weights((2, 6, 6, 2), (2, 12, 12, 2), seed=1)
    model.save(str(tmp_path))
    assert os.path.exists(tmp_path / 'model_params.json')
    jmodel = JaxGan.load(str(tmp_path))
    assert len(load_jax_checkpoint(str(tmp_path / 'model_gen.msgpack'))) \
        == len(model.generator)
    lr = np.random.default_rng(2).standard_normal((2, 6, 6, 2)).astype(
        np.float32)
    np.testing.assert_allclose(model.generate(lr),
                               np.asarray(jmodel.generate(lr)),
                               rtol=RTOL, atol=ATOL)
