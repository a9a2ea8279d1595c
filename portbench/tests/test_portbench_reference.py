"""The plain reference against the program on the CPU, at small widths;
its layer lists against the program's configs; its operation counts
against counts by hand."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.drivers import fwp
from portbench.reference import gan as ref_gan
from portbench.reference.flops import forward_flops, gan_step_flops
from portbench.reference.network import apply, param_shapes
from portbench.reference.topo import block_mean
from portbench.tests.tiny import narrow

PB = Path(__file__).resolve().parents[1]


def config(name):
    return json.loads((PB / 'configs' / f'{name}.json').read_text())


@pytest.mark.parametrize('name, part, published', [
    ('st_gan_3x4x_2f', ('members', 0, 'generator'),
     'spatiotemporal/gen_3x_4x_2f'),
    ('st_gan_3x4x_2f', ('discriminator',), 'spatiotemporal/disc'),
    ('cc_wind_chain', ('members', 0, 'generator'),
     'sup3rcc/gen_wind_5x_1x_6f'),
    ('cc_wind_chain', ('members', 1, 'generator'),
     'sup3rcc/gen_wind_1x_24x_6f'),
])
def test_frozen_layer_lists_are_the_programs(name, part, published):
    from sup3r_tpu_torch.configs import get_config

    layers = config(name)
    for key in part:
        layers = layers[key]
    assert layers == get_config(published)['hidden_layers']


def test_flops_by_hand():
    pad = {'class': 'FlexiblePadding', 'mode': 'REFLECT',
           'paddings': [[0, 0], [3, 3], [3, 3], [3, 3], [0, 0]]}
    conv = {'class': 'Conv3D', 'filters': 4, 'kernel_size': 3, 'strides': 1}
    crop = {'class': 'Cropping3D', 'cropping': 2}
    # the crop keeps 5 x 5 x 5 outputs of 4 channels, 2 * 27 taps each
    assert forward_flops([pad, conv, crop], (1, 5, 5, 5, 2)) == \
        2 * 125 * 4 * 2 * 27
    # the flagship on one padded (20, 20, 56) chunk: a 2 -> 64 conv at t
    # 56, a 64 -> 64 conv at t 112, 33 at t 224, 64 -> 72 at t 224, the
    # 8 -> 2 tail at (60, 60, 224)
    cells = 20 * 20
    macs = (cells * 56 * 64 * 2 * 27 + cells * 112 * 64 * 64 * 27
            + 33 * cells * 224 * 64 * 64 * 27
            + cells * 224 * 72 * 64 * 27 + 60 * 60 * 224 * 2 * 8 * 27)
    gen = config('st_gan_3x4x_2f')['members'][0]['generator']
    assert forward_flops(gen, (1, 20, 20, 56, 2)) == 2 * macs
    # the published discriminator on (72, 72, 72): valid convs
    # 72 -> 70 -> 34 -> 32 -> 15 -> 13 -> 6 -> 4 -> 1, then 256 -> 1024 -> 1
    sizes = [70, 34, 32, 15, 13, 6, 4, 1]
    chans = [2, 32, 32, 64, 64, 128, 128, 256, 256]
    d_macs = sum(s ** 3 * ci * co * 27 for s, ci, co in
                 zip(sizes, chans[:-1], chans[1:])) + 256 * 1024 + 1024
    disc = config('st_gan_3x4x_2f')['discriminator']
    assert forward_flops(disc, (1, 72, 72, 72, 2)) == 2 * d_macs
    # a step: G forward, D forward twice, the generator's loss back
    # through D (all dgrads) and G (dgrads but the first, wgrads), the
    # discriminator's loss back through both D calls
    g = forward_flops(gen, (1, 24, 24, 18, 2))
    g0 = 2 * 24 * 24 * 18 * 64 * 2 * 27
    d = 2 * d_macs
    d0 = 2 * 70 ** 3 * 2 * 32 * 27
    assert gan_step_flops(gen, disc, (1, 24, 24, 18, 2),
                          (1, 72, 72, 72, 2)) == \
        g + 2 * d + d + (2 * g - g0) + 2 * (2 * d - d0)


def port_gan(gen_layers, disc_layers, lr_shape, hr_shape, seed, **kwargs):
    """The program's model on the CPU holding the benchmark's weights for
    ``seed``; returns (model, gen weights, disc weights)."""
    from sup3r_tpu_torch.models import Sup3rGan

    model = Sup3rGan(gen_layers, disc_layers, device='cpu', **kwargs)
    model.init_weights(lr_shape, hr_shape, seed=0)
    gw = harness.make_weights(param_shapes(gen_layers, lr_shape), seed, 10,
                              'cpu')
    dw = harness.make_weights(param_shapes(disc_layers, hr_shape), seed, 20,
                              'cpu')
    with torch.no_grad():
        for net, ws in ((model._gen, gw), (model._disc, dw)):
            for p, w in zip(net.parameters(), ws):
                p.copy_(w)
    return model, gw, dw


TINY_DISC = [{'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]


@pytest.mark.parametrize('name, member, lr_shape', [
    ('st_gan_3x4x_2f', 0, (2, 6, 5, 4, 2)),
    ('cc_wind_chain', 0, (3, 5, 4, 7)),
    ('cc_wind_chain', 1, (1, 4, 5, 3, 6)),
])
def test_generator_is_the_programs(name, member, lr_shape):
    m = config(name)['members'][member]
    layers = narrow(m['generator'], {64: 8, 1600: 200, 768: 48}, 2)
    hr_shape = (lr_shape[0], 4, 4, 1)
    model, gw, _ = port_gan(layers, TINY_DISC, lr_shape, hr_shape, 7)
    x = torch.as_tensor(harness.seed_rng(7, 0).standard_normal(lr_shape),
                        dtype=torch.float32)
    exo = {}
    if m['hr_exo_features']:
        s = m['s_enhance']
        raster = torch.as_tensor(harness.seed_rng(7, 1).standard_normal(
            (lr_shape[0], lr_shape[1] * s, lr_shape[2] * s, 1)),
            dtype=torch.float32)
        exo = {'topography': raster}
    got = model.generate(x.numpy(), norm_in=False, un_norm_out=False,
                         exogenous_data={k: {'steps': [{
                             'model': 0, 'combine_type': 'layer',
                             'data': v.numpy()}]} for k, v in exo.items()}
                         or None)
    want = apply(layers, gw, x.movedim(-1, 1),
                 {k: v.movedim(-1, 1) for k, v in exo.items()})
    want = want.movedim(1, -1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(
        want).max())


def test_gan_step_is_the_programs():
    cfg = config('st_gan_3x4x_2f')
    gen = narrow(cfg['members'][0]['generator'], {64: 8}, 1)
    disc = narrow(cfg['discriminator'],
                  {32: 4, 64: 4, 128: 8, 256: 8, 1024: 16}, 1)
    lr_shape, hr_shape = (2, 21, 21, 16, 2), (2, 63, 63, 64, 2)
    model, gw, dw = port_gan(gen, disc, lr_shape, hr_shape, 3,
                             loss='MeanAbsoluteError', learning_rate=1e-4)
    hr = torch.as_tensor(harness.seed_rng(3, 0).standard_normal(hr_shape),
                         dtype=torch.float32)
    lr = ref_gan.coarsen(hr, 3, 4)
    ref_g = {'layers': gen, 'params': [w.clone().requires_grad_(True)
                                       for w in gw]}
    ref_d = {'layers': disc, 'params': [w.clone().requires_grad_(True)
                                        for w in dw]}
    ref_g['opt'] = ref_gan.Adam(ref_g['params'], 1e-4)
    ref_d['opt'] = ref_gan.Adam(ref_d['params'], 1e-4)
    for _ in range(2):
        got = model.run_gradient_descent(lr, hr, weight_gen_advers=1e-3,
                                         train_gen=True, train_disc=True)
        g_loss, d_loss, _, _ = ref_gan.gan_step(ref_g, ref_d, lr, hr, 1e-3)
        assert got['loss_gen'] == pytest.approx(g_loss, rel=1e-5)
        assert got['loss_disc'] == pytest.approx(d_loss, rel=1e-5)
    # after two Adam steps of lr 1e-4 each leaf moved by up to 2e-4; the
    # two sides' leaves agree to a small share of that
    for p, r in zip(model.gen_params + model.disc_params,
                    ref_g['params'] + ref_d['params']):
        np.testing.assert_allclose(p.detach().numpy(), r.detach().numpy(),
                                   rtol=0, atol=2e-5)


def test_coarsening_is_the_programs():
    from sup3r_tpu_torch.ops.coarsen import (
        spatial_coarsening,
        temporal_coarsening,
    )

    hr = harness.seed_rng(1, 0).standard_normal((2, 9, 6, 8, 2)).astype(
        np.float32)
    want = temporal_coarsening(spatial_coarsening(hr, 3), 4, 'subsample')
    got = ref_gan.coarsen(torch.as_tensor(hr), 3, 4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_topography_raster_is_the_programs(tmp_path):
    from sup3r_tpu_torch.preprocessing.exo import ExoRasterizer

    lat, lon = np.linspace(40.0, 39.0, 6), np.linspace(-105.5, -104.3, 4)
    harness.write_nc(tmp_path / 'lr.nc', {'u_10m': np.zeros((6, 4, 2))},
                     lat, lon, 24)
    src_lat, src_lon = fwp.source_grid(lat, lon, 10)
    topo = harness.seed_rng(2, 0).random((60, 40)).astype(np.float32) * 2000
    harness.write_static_nc(tmp_path / 'topo.nc', 'topography', topo,
                            src_lat, src_lon)
    for s_enhance, factor in ((5, 2), (1, 10)):
        raster = ExoRasterizer(
            file_paths=str(tmp_path / 'lr.nc'),
            source_file=str(tmp_path / 'topo.nc'), feature='topography',
            s_enhance=s_enhance, cache_dir=str(tmp_path / 'cache')).data
        np.testing.assert_allclose(raster[..., 0], block_mean(topo, factor),
                                   rtol=1e-6)


def test_reference_imports_nothing_of_the_program():
    allowed = {'math', 'numpy', 'torch', 'portbench'}
    for path in (PB / 'reference').glob('*.py'):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or '']
            else:
                continue
            for name in names:
                assert name.split('.')[0] in allowed, (path.name, name)
                if name.startswith('portbench'):
                    assert name.startswith('portbench.reference'), name
