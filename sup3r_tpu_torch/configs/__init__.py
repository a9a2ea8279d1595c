"""Programmatic builders for the standard generator/discriminator
architectures.

The port's own copy of ``sup3r_tpu/configs/__init__.py`` (the port
imports nothing of the JAX package); tests/test_torch_layers.py holds
the two registries equal.

The reference ships these as literal JSON files (sup3r/configs/*/*.json);
here the same architectures are generated from parameterized builders —
the DSL dicts produced are interchangeable with raw reference JSON (the
``Network`` interpreter accepts either). Builder outputs are verified
against the reference layer sequences in tests/models/test_layers.py.

Architecture family (ESRGAN-style, reference configs):
  * body: K residual blocks of [pad, conv, crop(, act), pad, conv, crop]
    wrapped in named skip connections, inside one long skip.
  * expansion: per enhancement stage, a conv widening channels by the
    pixel-shuffle factor followed by Spatial/SpatioTemporalExpansion.
  * head: final conv to ``n_features`` output channels.
"""

import itertools

_SPATIAL_PAD = {'class': 'FlexiblePadding',
                'paddings': [[0, 0], [3, 3], [3, 3], [0, 0]],
                'mode': 'REFLECT'}
_ST_PAD = {'class': 'FlexiblePadding',
           'paddings': [[0, 0], [3, 3], [3, 3], [3, 3], [0, 0]],
           'mode': 'REFLECT'}
_LRELU = {'class': 'LeakyReLU', 'alpha': 0.2}


def _s_conv(filters, activation=None):
    """pad/convT/crop unit preserving spatial shape (net +6+2-8=0)."""
    return [
        dict(_SPATIAL_PAD),
        {'class': 'Conv2DTranspose', 'filters': filters, 'kernel_size': 3,
         'strides': 1, 'activation': activation},
        {'class': 'Cropping2D', 'cropping': 4},
    ]


def _st_conv(filters):
    """pad/conv3d/crop unit preserving shape (net +6-2-4=0)."""
    return [
        dict(_ST_PAD),
        {'class': 'Conv3D', 'filters': filters, 'kernel_size': 3,
         'strides': 1},
        {'class': 'Cropping3D', 'cropping': 2},
    ]


def generator_spatial(n_features, spatial_mults=(2,), filters=64,
                      n_resblocks=16):
    """Spatial-only super-resolution generator.

    Equivalent to reference configs/spatial/gen_{prod(mults)}x_{nf}f.json.
    """
    layers = []
    layers += _s_conv(filters, 'relu')
    layers.append({'class': 'SkipConnection', 'name': 'a'})
    layers.append({'n': n_resblocks, 'repeat': [
        {'class': 'SkipConnection', 'name': 'b'},
        *_s_conv(filters, 'relu'),
        *_s_conv(filters, None),
        {'class': 'SkipConnection', 'name': 'b'},
    ]})
    layers += _s_conv(filters, None)
    layers.append({'class': 'SkipConnection', 'name': 'a'})
    for mult in spatial_mults:
        layers += _s_conv(filters * mult * mult, None)
        layers.append({'class': 'SpatialExpansion', 'spatial_mult': mult})
        layers.append({'class': 'Activation', 'activation': 'relu'})
    layers += _s_conv(n_features, None)
    return {'hidden_layers': layers}


def generator_st(n_features, spatial_mults=(3,), temporal_mults=(2, 2),
                 temporal_method='nearest', filters=64, n_resblocks=16):
    """Spatiotemporal generator (3D convs, nearest temporal expansion
    stages up front, pixel-shuffle spatial expansion after the body).

    Equivalent to reference configs/spatiotemporal/gen_*x_*x_*f.json.
    """
    layers = []
    for t_mult in temporal_mults:
        layers += _st_conv(filters)
        layers.append(dict(_LRELU))
        layers.append({'class': 'SpatioTemporalExpansion',
                       'temporal_mult': t_mult,
                       'temporal_method': temporal_method})
    layers.append({'class': 'SkipConnection', 'name': 'a'})
    layers.append({'n': n_resblocks, 'repeat': [
        {'class': 'SkipConnection', 'name': 'b'},
        *_st_conv(filters),
        dict(_LRELU),
        *_st_conv(filters),
        {'class': 'SkipConnection', 'name': 'b'},
    ]})
    layers += _st_conv(filters)
    layers.append({'class': 'SkipConnection', 'name': 'a'})
    for mult in spatial_mults:
        # widen channels so pixel shuffle lands on 'filters/8' maps like
        # the reference (e.g. 72 -> 3x3 shuffle -> 8 channels)
        layers += _st_conv((filters // 8) * mult * mult)
        layers.append({'class': 'SpatioTemporalExpansion',
                       'spatial_mult': mult})
        layers.append(dict(_LRELU))
    layers += _st_conv(n_features)
    return {'hidden_layers': layers}


def generator_cc_temporal(n_features, temporal_mult=24, t_roll=12,
                          filters=64, n_resblocks=16, chan_per_step=32):
    """Sup3rCC-style pure-temporal generator: body at daily resolution,
    one depth_to_time expansion to hourly/sub-hourly, centered by t_roll.

    Equivalent to reference configs/sup3rcc/gen_trh_1x_24x_2f.json and
    gen_wind_1x_24x_6f.json.
    """
    layers = []
    layers += _st_conv(filters)
    layers.append(dict(_LRELU))
    layers.append({'n': n_resblocks, 'repeat': [
        {'class': 'SkipConnection', 'name': 'small_skip'},
        *_st_conv(filters),
        dict(_LRELU),
        *_st_conv(filters),
        {'class': 'SkipConnection', 'name': 'small_skip'},
    ]})
    layers += _st_conv(filters)
    layers.append(dict(_LRELU))
    layers += _st_conv(chan_per_step * temporal_mult)
    layers.append({'class': 'SpatioTemporalExpansion',
                   'temporal_mult': temporal_mult,
                   'temporal_method': 'depth_to_time', 't_roll': t_roll})
    layers.append(dict(_LRELU))
    layers += _st_conv(n_features)
    return {'hidden_layers': layers}


def generator_cc_spatial(n_features, spatial_mult=5, filters=64,
                         n_resblocks=8, with_topography=True):
    """Sup3rCC-style spatial generator with mid-network topography
    injection (Sup3rConcat) after the expansion.

    Equivalent to reference configs/sup3rcc/gen_wind_5x_1x_6f.json.
    """

    def conv_unit(f):
        return [
            dict(_SPATIAL_PAD),
            {'class': 'Conv2D', 'filters': f, 'kernel_size': 3,
             'strides': 1},
            {'class': 'Cropping2D', 'cropping': 2},
        ]

    def body(tag):
        return [
            {'class': 'SkipConnection', 'name': f'big_skip_{tag}'},
            {'n': n_resblocks, 'repeat': [
                {'class': 'SkipConnection', 'name': f'small_skip_{tag}'},
                *conv_unit(filters),
                dict(_LRELU),
                *conv_unit(filters),
                {'class': 'SkipConnection', 'name': f'small_skip_{tag}'},
            ]},
            *conv_unit(filters),
            {'class': 'SkipConnection', 'name': f'big_skip_{tag}'},
        ]

    layers = []
    layers += conv_unit(filters)
    layers.append(dict(_LRELU))
    layers += body(1)
    layers += conv_unit(filters * spatial_mult * spatial_mult)
    layers.append({'class': 'SpatialExpansion', 'spatial_mult':
                   spatial_mult})
    layers.append(dict(_LRELU))
    if with_topography:
        layers.append({'class': 'Sup3rConcat', 'name': 'topography'})
    layers += conv_unit(filters)
    layers.append(dict(_LRELU))
    layers += body(2)
    layers += conv_unit(n_features)
    return {'hidden_layers': layers}


def discriminator_spatial(padding='valid'):
    """Strided conv pyramid + dense head (reference:
    configs/spatial/disc.json). Pass padding='same' for small training
    samples (reference tests use this:
    tests/data/config_disc_s_test.json)."""
    layers = []
    for f, s in itertools.product([32, 64, 128, 256], [1, 2]):
        layers.append({'class': 'Conv2D', 'filters': f, 'kernel_size': 3,
                       'strides': s, 'padding': padding})
        layers.append(dict(_LRELU))
    layers += [{'class': 'Flatten'}, {'class': 'Dense', 'units': 1024},
               dict(_LRELU), {'class': 'Dense', 'units': 1}]
    return {'hidden_layers': layers}


def discriminator_st(padding='valid'):
    """3D conv pyramid + dense head (reference:
    configs/spatiotemporal/disc.json; 'same' variant mirrors
    tests/data/config_disc_st_test.json)."""
    layers = []
    for f, s in itertools.product([32, 64, 128, 256], [1, 2]):
        layers.append({'class': 'Conv3D', 'filters': f, 'kernel_size': 3,
                       'strides': s, 'padding': padding})
        layers.append(dict(_LRELU))
    if padding == 'same':
        layers += [{'class': 'Flatten'}, {'class': 'Dense', 'units': 2048},
                   dict(_LRELU)]
    else:
        layers.append({'class': 'Flatten'})
    layers += [{'class': 'Dense', 'units': 1024},
               dict(_LRELU), {'class': 'Dense', 'units': 1}]
    return {'hidden_layers': layers}


#: named registry mirroring the reference's shipped config files
CONFIGS = {
    'spatial/gen_2x_1f': lambda: generator_spatial(1, (2,)),
    'spatial/gen_2x_2f': lambda: generator_spatial(2, (2,)),
    'spatial/gen_10x_2f': lambda: generator_spatial(2, (2, 5)),
    'spatial/disc': discriminator_spatial,
    'spatial/disc_test': lambda: discriminator_spatial('same'),
    'spatiotemporal/disc_test': lambda: discriminator_st('same'),
    'spatiotemporal/gen_2x_2x_2f': lambda: generator_st(
        2, (2,), (2,)),
    'spatiotemporal/gen_3x_4x_1f': lambda: generator_st(
        1, (3,), (2, 2)),
    'spatiotemporal/gen_3x_4x_2f': lambda: generator_st(
        2, (3,), (2, 2)),
    'spatiotemporal/gen_3x_4x_10f': lambda: generator_st(
        10, (3,), (2, 2)),
    'spatiotemporal/gen_3x_4x_14f': lambda: generator_st(
        14, (3,), (2, 2)),
    'spatiotemporal/gen_2x_12x_14f': lambda: generator_st(
        14, (2,), (2, 2, 3)),
    'spatiotemporal/gen_4x_24x_3f': lambda: generator_st(
        3, (4,), (2, 2, 2, 3), filters=64),
    'spatiotemporal/disc': discriminator_st,
    'sup3rcc/gen_wind_3x_4x_2f': lambda: generator_st(2, (3,), (2, 2)),
    'sup3rcc/gen_wind_5x_1x_6f': lambda: generator_cc_spatial(6, 5),
    'sup3rcc/gen_wind_1x_24x_6f': lambda: generator_cc_temporal(
        6, 24, 12),
    'sup3rcc/gen_trh_1x_24x_2f': lambda: generator_cc_temporal(2, 24, 12),
    'sup3rcc/gen_solar_5x_1x_1f': lambda: generator_cc_spatial(
        1, 5, with_topography=True),
    'sup3rcc/gen_solar_1x_8x_1f': lambda: generator_cc_temporal(
        1, 8, 4, chan_per_step=64),
}


def get_config(name):
    """Fetch a named architecture config (e.g. 'spatial/gen_2x_2f')."""
    key = name.replace('.json', '')
    if key not in CONFIGS:
        raise KeyError(
            f'Unknown config "{name}". Available: {sorted(CONFIGS)}')
    return CONFIGS[key]()
