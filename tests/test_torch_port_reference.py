"""The port's reference-checkpoint import (``sup3r_tpu_torch.utilities.
port``) against the JAX package's, on tests/models/test_port_reference.py's
fixtures (phygnn pickles written in ``tmp_path`` from a JAX model's
weights): the same configs and TF-layout weights come out of the
pickles, the conv-transpose kernels take the flip-and-swap, imported
networks and ``load_reference_gan`` models serve the same outputs
within 1e-5, and an export by either package loads in the other."""

import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

from sup3r_tpu.utilities import port as jax_port
from sup3r_tpu_torch.models import Sup3rGan
from sup3r_tpu_torch.models.weights import params_to_jax
from sup3r_tpu_torch.utilities import port
from tests.models.test_port_reference import (
    FEATURES,
    _disc_cfg,
    _gen_cfg,
    _to_tf_weights,
    _write_reference_dir,
)
from tests.models.test_port_reference import (
    source_model,  # noqa: F401  (the JAX fixture)
)

torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * float(np.abs(want).max()))


def _lr(seed, shape=(1, 8, 8, 2)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def test_pickles_parse_alike(source_model, tmp_path):  # noqa: F811
    d = _write_reference_dir(tmp_path, source_model)
    for name in ('model_gen.pkl', 'model_disc.pkl'):
        fp = os.path.join(d, name)
        cfg, weights = port.load_phygnn_pickle(fp)
        jcfg, jweights = jax_port.load_phygnn_pickle(fp)
        assert cfg == jcfg
        assert len(weights) == len(jweights)
        for a, b in zip(weights, jweights):
            np.testing.assert_array_equal(a, b)


def test_foreign_classes_are_stubbed(tmp_path):
    """A pickle holding phygnn objects loads without phygnn."""
    mod = types.ModuleType('phygnn')
    sub = types.ModuleType('phygnn.layers.handlers')

    class FakeLayersObj:
        pass

    FakeLayersObj.__module__ = 'phygnn.layers.handlers'
    FakeLayersObj.__qualname__ = 'FakeLayersObj'
    sub.FakeLayersObj = FakeLayersObj
    obj = FakeLayersObj()
    obj.weights = [np.ones((3, 1), np.float32), np.zeros(1, np.float32)]
    fp = str(tmp_path / 'gen.pkl')
    sys.modules['phygnn'] = mod
    sys.modules['phygnn.layers.handlers'] = sub
    try:
        with open(fp, 'wb') as f:
            pickle.dump({'hidden_layers': [{'class': 'Dense', 'units': 1}],
                         'layers_obj': obj}, f)
    finally:
        del sys.modules['phygnn']
        del sys.modules['phygnn.layers.handlers']
    cfg, weights = port.load_phygnn_pickle(fp)
    assert cfg[0]['class'] == 'Dense'
    assert [w.shape for w in weights] == [(3, 1), (1,)]


def test_import_network_matches_jax(source_model):  # noqa: F811
    """The imported network holds the JAX import's params exactly (the
    conv-transpose kernel flipped and swapped) and serves its output."""
    gen_w = _to_tf_weights(source_model.generator, source_model.gen_params)
    net, params = port.import_phygnn_network(_gen_cfg(), gen_w,
                                             (1, 8, 8, 2))
    jnet, jparams = jax_port.import_phygnn_network(_gen_cfg(), gen_w,
                                                   (1, 8, 8, 2))
    for got, loaded, want, orig in zip(params, params_to_jax(net), jparams,
                                       source_model.gen_params):
        for key in want:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))
            np.testing.assert_array_equal(loaded[key],
                                          np.asarray(want[key]))
            np.testing.assert_array_equal(got[key], np.asarray(orig[key]))
    transpose = [i for i, lyr in enumerate(net.layers)
                 if type(lyr).__name__ == 'Conv2DTranspose']
    assert transpose
    tf_kernel = gen_w[2 * 1]  # the second weighted layer's kernel
    np.testing.assert_array_equal(
        params[transpose[0]]['kernel'],
        np.swapaxes(np.flip(tf_kernel, (0, 1)), -1, -2))
    x = _lr(0)
    with torch.no_grad():
        got = net.apply(torch.as_tensor(x)).numpy()
    _close(got, np.asarray(jnet.apply(jparams, x)))


def test_load_reference_gan_matches_jax(source_model, tmp_path):  # noqa
    d = _write_reference_dir(tmp_path, source_model)
    model = port.load_reference_gan(d, lr_shape=(1, 8, 8, 2), device='cpu')
    jmodel = jax_port.load_reference_gan(d, lr_shape=(1, 8, 8, 2))
    assert isinstance(model, Sup3rGan) and model.device.type == 'cpu'
    assert model.s_enhance == 2 and model.lr_features == FEATURES
    assert model._gen_in_shape == (1, 8, 8, 2)
    assert model._disc_in_shape == tuple(jmodel._disc_in_shape)
    assert model._gen_opt_state['count'] == 0
    for got, want in zip(params_to_jax(model.discriminator),
                         jmodel.disc_params):
        for key in want:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    lr = _lr(1)
    _close(model.generate(lr), jmodel.generate(lr))
    _close(model.generate(lr), source_model.generate(lr))
    # the imported model survives a save / load round trip
    model.save(str(tmp_path / 'saved'))
    again = Sup3rGan.load(str(tmp_path / 'saved'), device='cpu')
    np.testing.assert_allclose(again.generate(lr), model.generate(lr),
                               rtol=1e-6)


def test_generator_only_directory(source_model, tmp_path):  # noqa: F811
    d = _write_reference_dir(tmp_path, source_model)
    os.remove(os.path.join(d, 'model_disc.pkl'))
    model = port.load_reference_gan(d, lr_shape=(1, 8, 8, 2), device='cpu')
    assert model.disc_params is not None
    assert model._disc_in_shape == (1, 16, 16, 2)
    _close(model.generate(_lr(2)), source_model.generate(_lr(2)))


def test_partial_norm_stats_still_load(source_model, tmp_path):  # noqa
    import json

    d = _write_reference_dir(tmp_path, source_model)
    fp = os.path.join(d, 'model_params.json')
    with open(fp) as f:
        params = json.load(f)
    params['stdevs'] = None
    with open(fp, 'w') as f:
        json.dump(params, f)
    model = port.load_reference_gan(d, lr_shape=(1, 8, 8, 2), device='cpu')
    assert model._means == {k: 0.1 for k in FEATURES}
    assert model._stdevs is None


def test_port_export_loads_in_jax(source_model, tmp_path):  # noqa: F811
    d = _write_reference_dir(tmp_path, source_model)
    model = port.load_reference_gan(d, lr_shape=(1, 8, 8, 2), device='cpu')
    out = str(tmp_path / 'exported')
    port.export_reference_gan(model, out)
    with open(os.path.join(out, 'model_gen.pkl'), 'rb') as f:
        record = pickle.load(f)['version_record']
    assert list(record) == ['sup3r_tpu_torch']
    jmodel = jax_port.load_reference_gan(out, lr_shape=(1, 8, 8, 2))
    lr = _lr(5)
    _close(jmodel.generate(lr), model.generate(lr))
    again = port.load_reference_gan(out, lr_shape=(1, 8, 8, 2),
                                    device='cpu')
    np.testing.assert_allclose(again.generate(lr), model.generate(lr),
                               rtol=1e-6)


def test_jax_export_loads_in_the_port(source_model, tmp_path):  # noqa
    out = str(tmp_path / 'jax_exported')
    jax_port.export_reference_gan(source_model, out)
    model = port.load_reference_gan(out, lr_shape=(1, 8, 8, 2), device='cpu')
    lr = _lr(6)
    _close(model.generate(lr), source_model.generate(lr))


def test_bad_checkpoints_raise(source_model, tmp_path):  # noqa: F811
    gen_w = _to_tf_weights(source_model.generator, source_model.gen_params)
    gen_w[0] = gen_w[0][:, :, :1, :]
    with pytest.raises(ValueError, match='kernel shape'):
        port.import_phygnn_network(_gen_cfg(), gen_w, (1, 8, 8, 2))
    fp = str(tmp_path / 'junk.pkl')
    with open(fp, 'wb') as f:
        pickle.dump({'something': 1}, f)
    with pytest.raises(ValueError, match='hidden_layers'):
        port.load_phygnn_pickle(fp)
    disc_w = _to_tf_weights(source_model.discriminator,
                            source_model.disc_params)
    with pytest.raises(ValueError, match='Ran out'):
        port.import_phygnn_network(_disc_cfg(), disc_w[:2], (1, 16, 16, 2))


def test_load_reference_gan_defaults_to_the_card(source_model, tmp_path,
                                                 monkeypatch):  # noqa
    d = _write_reference_dir(tmp_path, source_model)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.load_reference_gan(d, lr_shape=(1, 8, 8, 2))
