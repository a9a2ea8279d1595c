"""The port's ``estimate_flops`` (``torch.utils.flop_counter``) against
the JAX package's jaxpr count on the cases of
tests/utilities/test_flops.py: a matmul, a conv, forward plus backward,
and the flagship generator at two batch sizes. Both count a conv as
``2 * prod(out) * k_in * prod(k_spatial)`` and a matmul as ``2 * b * m *
n * k``, so the counts are equal. The flagship compares unfused
(``inference_fuse = False``): inside its Pallas kernels the JAX count
differs by design (utilities/flops.py). The hand kernels' own report
(``count_kernel_conv``) is held to the counter's count of their plain
versions, which is what makes the card's count equal the CPU's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from sup3r_tpu.configs import get_config as jax_get_config
from sup3r_tpu.models import Sup3rGan as JaxGan
from sup3r_tpu.utilities.flops import estimate_flops as jax_flops
from sup3r_tpu_torch.configs import get_config
from sup3r_tpu_torch.models import Sup3rGan
from sup3r_tpu_torch.ops.kernels import reflect_conv_reference
from sup3r_tpu_torch.utilities.flops import (
    count_kernel_conv,
    estimate_flops,
)


def test_matmul_flops():
    got = estimate_flops(lambda a, b: a @ b, torch.ones(64, 32),
                         torch.ones(32, 16))
    want = jax_flops(lambda a, b: a @ b, jnp.ones((64, 32)),
                     jnp.ones((32, 16)))
    assert got == want == 2 * 64 * 32 * 16


def test_batched_matmul_flops():
    got = estimate_flops(torch.bmm, torch.ones(3, 8, 5), torch.ones(3, 5, 7))
    want = jax_flops(jnp.matmul, jnp.ones((3, 8, 5)), jnp.ones((3, 5, 7)))
    assert got == want == 2 * 3 * 8 * 7 * 5


@pytest.mark.parametrize('spatial', [2, 3])
def test_conv_flops(spatial):
    x = np.ones((1, 4) + (8,) * spatial, np.float32)
    w = np.ones((8, 4) + (3,) * spatial, np.float32)
    conv = F.conv2d if spatial == 2 else F.conv3d
    got = estimate_flops(lambda a, b: conv(a, b, padding=1),
                         torch.from_numpy(x), torch.from_numpy(w))
    dn = ('NHWC', 'HWIO', 'NHWC') if spatial == 2 else (
        'NDHWC', 'DHWIO', 'NDHWC')

    def jconv(a, b):
        return lax.conv_general_dilated(a, b, (1,) * spatial, 'SAME',
                                        dimension_numbers=dn)

    want = jax_flops(jconv, jnp.ones((1,) + (8,) * spatial + (4,)),
                     jnp.ones((3,) * spatial + (4, 8)))
    assert got == want == 2 * 8 ** spatial * 8 * 4 * 3 ** spatial


def test_matmul_forward_and_backward():
    a = torch.ones(64, 32, requires_grad=True)
    b = torch.ones(32, 16)

    def fwd_bwd(a, b):
        (a @ b).sum().backward()

    fwd = estimate_flops(lambda a, b: a @ b, a.detach(), b)
    both = estimate_flops(fwd_bwd, a, b)
    g = jax.jit(lambda a, b: jnp.sum(a @ b))
    want = jax_flops(jax.grad(g), jnp.ones((64, 32)), jnp.ones((32, 16)))
    assert both == want == 2 * fwd


def test_conv_forward_and_backward():
    x = torch.ones(2, 4, 6, 6, requires_grad=True)
    w = torch.ones(8, 4, 3, 3, requires_grad=True)

    def fwd_bwd(x, w):
        F.conv2d(x, w, padding=1).sum().backward()

    def jloss(a, b):
        return jnp.sum(lax.conv_general_dilated(
            a, b, (1, 1), 'SAME',
            dimension_numbers=('NHWC', 'HWIO', 'NHWC')))

    got = estimate_flops(fwd_bwd, x, w)
    want = jax_flops(jax.grad(jloss, argnums=(0, 1)),
                     jnp.ones((2, 6, 6, 4)), jnp.ones((3, 3, 4, 8)))
    assert got == want == 3 * 2 * (2 * 6 * 6 * 8) * 4 * 9


@pytest.fixture(scope='module')
def flagships():
    """The flagship generator in both packages, JAX weights carried
    over; unfused."""
    jax_model = JaxGan(jax_get_config('spatiotemporal/gen_3x_4x_2f'),
                       jax_get_config('spatiotemporal/disc_test'))
    jax_model.init_weights((1, 8, 8, 8, 2), (1, 24, 24, 32, 2))
    model = Sup3rGan(get_config('spatiotemporal/gen_3x_4x_2f'),
                     get_config('spatiotemporal/disc_test'), device='cpu')
    model.init_weights((1, 8, 8, 8, 2), (1, 24, 24, 32, 2))
    model.inference_fuse = False
    return model, jax_model


def test_flagship_flops_match_jax_at_two_batch_sizes(flagships):
    model, jax_model = flagships
    apply_fn = jax_model._get_gen_apply()
    counts = []
    for n in (1, 2):
        x = np.zeros((n, 8, 8, 8, 2), np.float32)
        got = estimate_flops(model.generate, x)
        want = jax_flops(lambda p, x: apply_fn(p, x, {}),
                         jax_model.gen_params, jnp.asarray(x))
        assert got == want
        counts.append(got)
    assert counts[0] > 1e9
    assert counts[1] == 2 * counts[0]


def test_fused_flagship_counts_its_kernels_whole(flagships):
    """The fused network's count is the sum of its fused blocks' whole
    reflect-pad-1 k3 convs (read by hooks), which is what the card's
    kernels report at launch; it is below the unfused count."""
    from sup3r_tpu_torch.models.fuse import FusedReflectConv

    model, _ = flagships
    x = np.zeros((1, 8, 8, 8, 2), np.float32)
    unfused = estimate_flops(model.generate, x)
    model.inference_fuse = True
    shapes = []
    hooks = [lyr.register_forward_pre_hook(
        lambda m, args: shapes.append((tuple(args[0].shape),
                                       m.conv.bias.shape[0])))
        for lyr in model._get_fused_apply().layers
        if isinstance(lyr, FusedReflectConv)]
    try:
        fused = estimate_flops(model.generate, x)
    finally:
        model.inference_fuse = False
        for h in hooks:
            h.remove()
    assert shapes and fused == sum(
        2 * n * co * int(np.prod(sp)) * ci * 27
        for (n, ci, *sp), co in shapes)
    assert 0 < fused < unfused


@pytest.mark.parametrize('x_shape,co', [((2, 8, 6, 5, 4), 2),
                                        ((1, 3, 7, 6), 5)])
def test_kernel_report_matches_plain_version(x_shape, co):
    """``count_kernel_conv`` (what a launch on the card reports) equals
    the counter's count of the kernel's plain version on the CPU."""
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(x_shape, generator=gen)
    w = torch.rand((co, x_shape[1]) + (3,) * (len(x_shape) - 2),
                   generator=gen)
    b = torch.rand(co, generator=gen)
    plain = estimate_flops(reflect_conv_reference, x, w, b, 0.2)
    assert estimate_flops(count_kernel_conv, x_shape, co) == plain
    # no count is open outside estimate_flops: the report is a no-op
    count_kernel_conv(x_shape, co)
    assert estimate_flops(lambda: None) == 0
