"""The port's layer DSL (``sup3r_tpu_torch/models/layers.py``,
``network.py``) against the JAX package's on the same params: each case
builds a small network from one config in both packages, carries the
JAX params across with ``params_from_jax`` and compares the outputs.
The cases pin the known traps: TF's (r, r, c) depth-to-space channel
order (not ``F.pixel_shuffle``'s), temporal nearest / depth_to_time /
linear expansion, the transposed-conv weight mapping (``jax.lax.
conv_transpose`` does not flip the kernel), SYMMETRIC padding (which
``F.pad`` lacks), skips, crops and exo injection. Tolerance rtol 1e-5 /
atol 1e-5: fp32 convolutions summed in another order."""

import jax
import numpy as np
import pytest
import torch

from sup3r_tpu import configs as jax_configs
from sup3r_tpu.models.network import Network as JaxNetwork
from sup3r_tpu_torch import configs as torch_configs
from sup3r_tpu_torch.models import Network, params_from_jax

torch.set_num_threads(1)

PAD3 = {'class': 'FlexiblePadding',
        'paddings': [[0, 0], [3, 3], [3, 3], [3, 3], [0, 0]],
        'mode': 'REFLECT'}


def _conv(cls, filters, **kw):
    return {'class': cls, 'filters': filters, 'kernel_size': 3, **kw}


CASES = {
    'depth_to_space_2d': ([_conv('Conv2D', 12, padding='same'),
                           {'class': 'SpatialExpansion',
                            'spatial_mult': 2}], (2, 5, 4, 3)),
    'st_pixel_shuffle': ([{'class': 'SpatioTemporalExpansion',
                           'spatial_mult': 3}], (2, 3, 4, 5, 18)),
    'temporal_nearest': ([{'class': 'SpatioTemporalExpansion',
                           'spatial_mult': 2, 'temporal_mult': 3,
                           'temporal_method': 'nearest'}], (1, 3, 2, 4, 8)),
    'depth_to_time_roll': ([{'class': 'SpatioTemporalExpansion',
                             'temporal_mult': 4,
                             'temporal_method': 'depth_to_time',
                             't_roll': 3}], (2, 3, 2, 5, 8)),
    'temporal_linear': ([{'class': 'SpatioTemporalExpansion',
                          'temporal_mult': 3,
                          'temporal_method': 'linear'}], (1, 2, 3, 4, 2)),
    'conv2d_transpose_valid': ([_conv('Conv2DTranspose', 4,
                                      activation='relu')], (2, 5, 6, 3)),
    'conv2d_transpose_same_s2': ([_conv('Conv2DTranspose', 3, strides=2,
                                        padding='same')], (1, 4, 5, 2)),
    'conv3d_transpose_s2': ([_conv('Conv3DTranspose', 2, strides=2)],
                            (1, 3, 4, 3, 2)),
    'conv2d_transpose_s4_valid': ([_conv('Conv2DTranspose', 2, strides=4)],
                                  (1, 3, 2, 2)),
    'conv3d_strided_same': ([_conv('Conv3D', 4, strides=2, padding='same',
                                   activation='tanh')], (2, 7, 6, 5, 3)),
    'conv2d_strided_valid': ([_conv('Conv2D', 4, strides=(2, 1),
                                    activation='elu')], (1, 9, 8, 2)),
    'pad_conv_crop_skip': ([{'class': 'SkipConnection', 'name': 'a'}, PAD3,
                            _conv('Conv3D', 2), {'class': 'Cropping3D',
                                                 'cropping': 2},
                            {'class': 'LeakyReLU', 'alpha': 0.2},
                            {'class': 'SkipConnection', 'name': 'a'}],
                           (2, 4, 5, 3, 2)),
    'symmetric_pad_crop': ([{'class': 'FlexiblePadding',
                             'paddings': [[0, 0], [2, 3], [4, 1], [0, 0]],
                             'mode': 'SYMMETRIC'},
                            {'class': 'Cropping2D',
                             'cropping': [[1, 0], [0, 2]]}], (2, 3, 4, 2)),
    'reflect_pad_wider_than_dim': ([{'class': 'FlexiblePadding',
                                     'paddings': [[0, 0], [4, 2], [1, 5],
                                                  [0, 0]],
                                     'mode': 'REFLECT'}], (1, 3, 4, 2)),
    'constant_pad_channels': ([{'class': 'FlexiblePadding',
                                'paddings': [[0, 0], [1, 2], [0, 1], [1, 0],
                                             [2, 1]],
                                'mode': 'CONSTANT'}], (1, 2, 3, 2, 2)),
    'activations': ([{'class': 'Activation', 'activation': 'sigmoid'},
                     {'class': 'Activation', 'activation': 'gelu'},
                     {'class': 'Activation', 'activation': 'softplus'},
                     {'class': 'Activation', 'activation': 'softmax'},
                     {'class': 'Activation', 'activation': 'linear'}],
                    (2, 3, 4, 3)),
    'exo_adder_concat': ([{'class': 'Sup3rAdder', 'name': 'topography'},
                          {'class': 'Sup3rConcat', 'name': 'srl'},
                          _conv('Conv2D', 3, padding='same')],
                         (2, 4, 5, 3)),
    'disc_head': ([_conv('Conv3D', 4, strides=2, padding='same'),
                   {'class': 'LeakyReLU', 'alpha': 0.2}, {'class': 'Flatten'},
                   {'class': 'Dense', 'units': 5, 'activation': 'relu'},
                   {'class': 'Dense', 'units': 1}], (3, 6, 5, 4, 2)),
}


def _exo(in_shape):
    """One raster broadcast over the batch, one without its channel
    dim: the two forms ``_get_exo`` reshapes."""
    rng = np.random.default_rng(7)
    spatial = in_shape[1:-1]
    return {'topography': rng.standard_normal((1, *spatial, 1)).astype(
        np.float32), 'srl': rng.standard_normal(
            (in_shape[0], *spatial)).astype(np.float32)}


@pytest.mark.parametrize('case', sorted(CASES))
def test_layer_matches_jax(case):
    config, in_shape = CASES[case]
    jnet = JaxNetwork(config)
    jparams, jout_shape = jnet.init(jax.random.PRNGKey(3), in_shape)
    net = Network(config)
    out_shape = net.init(in_shape, torch.Generator().manual_seed(3))
    assert tuple(out_shape) == tuple(jout_shape)
    params_from_jax(net, jax.tree.map(np.asarray, jparams))

    x = np.random.default_rng(0).standard_normal(in_shape).astype(
        np.float32)
    exo = _exo(in_shape) if case.startswith('exo') else {}
    want = np.asarray(jnet.apply(jparams, x, exo=exo))
    with torch.no_grad():
        got = net.apply(torch.from_numpy(x), {
            k: torch.from_numpy(v) for k, v in exo.items()}).numpy()
    # (the JAX package's out_shape undercounts a VALID transposed conv
    # whose stride exceeds its kernel; apply is what the port matches)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_depth_to_space_is_not_pixel_shuffle():
    """The TF channel order the configs were trained with: output cell
    (0, 1) of channel 0 comes from input channel 1 * c = 3, where
    ``F.pixel_shuffle`` would take channel 1."""
    net = Network([{'class': 'SpatialExpansion', 'spatial_mult': 2}])
    x = torch.arange(12.0).reshape(1, 1, 1, 12)  # (n, h, w, 4 * c)
    out = net.apply(x)
    assert out[0, 0, 1, 0].item() == 3.0
    shuffled = torch.nn.functional.pixel_shuffle(x.permute(0, 3, 1, 2), 2)
    assert shuffled[0, 0, 0, 1].item() == 1.0


def _config_in_shape(name, config):
    n_dims = JaxNetwork(config["hidden_layers"]).input_dims
    if 'disc' in name:
        return (1, 64, 64, 64, 2)[:n_dims - 1] + (2,)
    return (1, 6, 6, 4, 2)[:n_dims - 1] + (2,)


@pytest.mark.parametrize('name', sorted(jax_configs.CONFIGS))
def test_configs_and_out_shape_match_jax(name):
    """The port's copy of the config registry builds the same layer
    lists, and the networks infer the same output shapes."""
    config = torch_configs.get_config(name)
    assert config == jax_configs.get_config(name)
    in_shape = _config_in_shape(name, config)
    assert Network(config['hidden_layers']).out_shape(in_shape) == (
        JaxNetwork(config['hidden_layers']).out_shape(in_shape))


def test_config_registries_have_the_same_names():
    assert sorted(torch_configs.CONFIGS) == sorted(jax_configs.CONFIGS)


@pytest.mark.parametrize('cls', ['Dropout', 'Sup3rObsModel'])
def test_layers_of_later_slices_raise(cls):
    """Every layer class of the JAX package is ported now
    (tests/test_torch_with_obs.py holds these to it); an unknown class
    still raises, naming the known ones."""
    layer = Network([{'class': cls, 'name': 'x'}]).layers[0]
    assert type(layer).__name__ == cls
    with pytest.raises(KeyError, match=cls):
        Network([{'class': cls + 'X', 'name': 'x'}])


#: one full-width config of each family (all of CONFIGS takes ~1 min
#: on one CPU thread, mostly the JAX package's eager apply)
FORWARD_CONFIGS = {
    'spatial/gen_2x_2f': (1, 4, 4, 2),                 # ConvT + relu
    'spatiotemporal/gen_3x_4x_2f': (1, 4, 4, 3, 2),    # the flagship
    'sup3rcc/gen_trh_1x_24x_2f': (1, 4, 4, 3, 2),      # depth_to_time
    'sup3rcc/gen_wind_5x_1x_6f': (1, 4, 4, 2),         # Sup3rConcat
    'spatial/disc_test': (1, 16, 16, 2),
    'spatiotemporal/disc_test': (1, 16, 16, 16, 2),
}


@pytest.mark.parametrize('name', sorted(FORWARD_CONFIGS))
def test_config_forward_matches_jax(name):
    """Whole shipped networks, full width, on the same params: rtol
    1e-4, the repository's fp32 parity bar, with atol 1e-5 of the
    output's largest magnitude (random-weight outputs reach ~10, and
    fp32 rounding error scales with them)."""
    config = jax_configs.get_config(name)['hidden_layers']
    in_shape = FORWARD_CONFIGS[name]
    jnet = JaxNetwork(config)
    jparams, _ = jnet.init(jax.random.PRNGKey(0), in_shape)
    net = Network(config)
    net.init(in_shape, torch.Generator().manual_seed(0))
    params_from_jax(net, jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(1)
    x = rng.standard_normal(in_shape).astype(np.float32)
    exo = {f: rng.standard_normal((1, 20, 20, 1)).astype(np.float32)
           for f in jnet.exo_features}
    want = np.asarray(jnet.apply(jparams, x, exo=exo))
    with torch.no_grad():
        got = net.apply(torch.from_numpy(x), {
            k: torch.from_numpy(v) for k, v in exo.items()}).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
