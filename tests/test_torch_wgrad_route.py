"""The route of a fused block's weight gradient (``ops/kernels.py``
``reflect_conv_backward``), on the CPU: the plain twin of the
hand-written ``reflect_conv_wgrad`` kernel is autograd's weight gradient
of ``F.pad(reflect) -> conv3d``; the gate (``wgrad_kernel_wins``) routes
the flagship's training blocks as they were timed on the card; bf16, 2D,
CPU and sharded blocks keep the library route (a stand-in for a CUDA
tensor drives the predicate); and the route counters move once per fused
block's weight gradient while a profiler records."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from sup3r_tpu_torch.configs import generator_st
from sup3r_tpu_torch.models import Sup3rGan
from sup3r_tpu_torch.models.fuse import FusedReflectConv
from sup3r_tpu_torch.ops import kernels
from sup3r_tpu_torch.ops.conv_ad import (
    reflect_conv_ad,
    reflect_conv_halo,
    reflect_conv_shard_aligned,
)
from sup3r_tpu_torch.ops.kernels import reflect_conv_wgrad, wgrad_kernel_wins
from sup3r_tpu_torch.utilities import trace

torch.set_num_threads(1)

FEATURES = ['u_100m', 'v_100m']
#: the benchmark's train cell's fused generator blocks: (input shape, co)
#: at batch 16 of HR (72, 72, 72): the head, the two body lengths, the
#: block before the expansion and the HR tail
TRAIN_CELL = [((16, 2, 24, 24, 18), 64), ((16, 64, 24, 24, 36), 64),
              ((16, 64, 24, 24, 72), 64), ((16, 64, 24, 24, 72), 72),
              ((16, 8, 72, 72, 72), 2)]
#: the other shipped generators' training blocks, and wider ones, the
#: kernel was timed faster on, within its error (an H100; PERF.md's
#: kernel table): the flagship at LR (12, 12, 12) at batch 16, the
#: WithObs tail, the SolarCC temporal member at batch 8, a t past one
#: tile, and the smallest size the gate takes
KERNEL_FASTER = [((16, 2, 12, 12, 12), 64), ((16, 64, 12, 12, 48), 72),
                 ((16, 8, 36, 36, 48), 2), ((16, 12, 36, 36, 48), 2),
                 ((2, 8, 36, 36, 48), 2), ((8, 3, 20, 20, 9), 64),
                 ((8, 64, 20, 20, 9), 512), ((8, 64, 20, 20, 72), 1),
                 ((4, 32, 10, 10, 130), 16), ((4, 3, 16, 16, 16), 6)]
#: blocks below 16,384 output cells, kept on cuDNN: on few input channels
#: its fp32 sum over a short K carried up to half the kernel's error
#: (3xTF32 products); the rule keeps wide blocks of this size there too
CUDNN_KEPT = [((1, 64, 2, 2, 2), 64), ((2, 64, 9, 11, 13), 64),
              ((3, 5, 7, 9, 11), 6), ((2, 128, 16, 16, 16), 128),
              ((3, 8, 20, 20, 9), 2), ((3, 4, 16, 16, 16), 32),
              ((2, 64, 12, 12, 48), 64)]
#: small blocks on the CPU: a body, a head, a tail, and one odd in every
#: dim
BLOCKS = [((2, 16, 4, 4, 8), 16), ((2, 2, 4, 4, 6), 64),
          ((2, 8, 6, 6, 6), 2), ((3, 5, 7, 9, 11), 6)]


class CudaInput:
    """What the predicate reads of a CUDA tensor."""

    is_cuda = True

    def __init__(self, shape, dtype=torch.float32):
        self.shape = torch.Size(shape)
        self.dtype = dtype


def _pair(x_shape, co, dtype=torch.float32):
    dy_shape = (x_shape[0], co) + tuple(x_shape[2:])
    return CudaInput(x_shape, dtype), CudaInput(dy_shape, dtype)


@pytest.mark.parametrize('x_shape, co', BLOCKS)
def test_plain_twin_is_autograds_weight_gradient(x_shape, co):
    rng = np.random.default_rng(sum(x_shape) + co)
    x = torch.as_tensor(rng.standard_normal(x_shape))
    dy = torch.as_tensor(rng.standard_normal(
        (x_shape[0], co) + x_shape[2:]))
    w = torch.zeros((co, x_shape[1], 3, 3, 3), dtype=x.dtype,
                    requires_grad=True)
    F.conv3d(F.pad(x, (1,) * 6, mode='reflect'), w).backward(dy)
    launches = reflect_conv_wgrad.launches
    got = reflect_conv_wgrad(x, dy)
    torch.testing.assert_close(got, w.grad, rtol=1e-12, atol=1e-12)
    # in float32: fp32 rounding, against the largest magnitude
    scale = w.grad.abs().max().item()
    torch.testing.assert_close(
        reflect_conv_wgrad(x.float(), dy.float()).double(), w.grad,
        rtol=0, atol=1e-5 * scale)
    # the plain version launches nothing
    assert reflect_conv_wgrad.launches == launches


@pytest.mark.parametrize('x_shape, co', TRAIN_CELL + KERNEL_FASTER)
def test_gate_sends_the_training_blocks_to_the_kernel(x_shape, co):
    assert wgrad_kernel_wins(*_pair(x_shape, co))


@pytest.mark.parametrize('x_shape, co', CUDNN_KEPT)
def test_gate_keeps_few_cells_on_cudnn(x_shape, co):
    assert not wgrad_kernel_wins(*_pair(x_shape, co))


@pytest.mark.parametrize('case', ['bf16', '2d', 'cpu', 'dim_below_2'])
def test_library_route_keeps(case):
    x_shape, co = TRAIN_CELL[2]
    if case == 'bf16':
        assert not wgrad_kernel_wins(*_pair(x_shape, co, torch.bfloat16))
    elif case == '2d':
        assert not wgrad_kernel_wins(*_pair((6, 64, 70, 70), 64))
    elif case == 'cpu':
        # a shape the gate takes on the card
        assert wgrad_kernel_wins(*_pair((16, 1, 8, 8, 16), 2))
        assert not wgrad_kernel_wins(torch.zeros((16, 1, 8, 8, 16)),
                                     torch.zeros((16, 2, 8, 8, 16)))
    else:
        assert not wgrad_kernel_wins(*_pair((16, 64, 24, 24, 1), 64))


@pytest.mark.parametrize('route', ['shard_aligned', 'halo'])
def test_sharded_blocks_keep_their_own_backward(monkeypatch, route):
    """The sharded formulations' backwards take their weight gradient on
    the library and never ask the kernel route."""
    asked = []
    monkeypatch.setattr(kernels, 'wgrad_kernel_wins',
                        lambda *args: asked.append(args) or True)
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((2, 4, 6, 5, 7)),
                        dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((3, 4, 3, 3, 3)) * 0.2,
                        dtype=torch.float32).requires_grad_()
    b = torch.zeros(3, requires_grad=True)
    if route == 'shard_aligned':
        y = reflect_conv_shard_aligned(x, w, b, 3, 0.2)
    else:
        y = reflect_conv_halo(x, w, b, 3, 0.2)
    y.sum().backward()
    assert asked == []
    # the plain block's backward does ask, and its gradient is the same
    w2 = w.detach().clone().requires_grad_()
    reflect_conv_ad(x, w2, b.detach(), 3, 0.2).sum().backward()
    assert len(asked) == 1
    torch.testing.assert_close(w2.grad, w.grad, rtol=1e-5, atol=1e-5)


def _model(seed=0):
    model = Sup3rGan(
        generator_st(2, (2,), (2,), filters=8, n_resblocks=1),
        {'hidden_layers': [
            {'class': 'Conv3D', 'filters': 4, 'kernel_size': 3,
             'strides': 2, 'padding': 'same'},
            {'class': 'LeakyReLU', 'alpha': 0.2},
            {'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]},
        meta={'lr_features': FEATURES, 'hr_out_features': FEATURES,
              's_enhance': 2, 't_enhance': 2,
              'input_resolution': {'spatial': '30km', 'temporal': '60min'}},
        means={f: 0.5 for f in FEATURES}, stdevs={f: 0.3 for f in FEATURES},
        learning_rate=1e-4, device='cpu')
    model.init_weights((1, 4, 4, 4, 2), (1, 8, 8, 8, 2), seed=seed)
    return model


def _step(model, seed=0):
    rng = np.random.default_rng(seed)
    lr = rng.random((2, 4, 4, 4, 2), dtype=np.float32)
    hr = rng.random((2, 8, 8, 8, 2), dtype=np.float32)
    return model.run_gradient_descent(lr, hr, train_gen=True,
                                      train_disc=True)


def test_route_counters_once_per_fused_blocks_weight_gradient(monkeypatch):
    model = _model()
    n_fused = sum(isinstance(lyr, FusedReflectConv)
                  for lyr in model._train_gen_net().layers)
    assert n_fused > 0
    trace.reset()
    _step(model)
    assert trace.snapshot()['counts'] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        _step(model, seed=1)
    counts = trace.snapshot()['counts']
    assert counts.get('conv_ad.wgrad_cudnn') == n_fused
    assert 'conv_ad.wgrad_kernel' not in counts
    library = [p.detach().clone() for p in model._gen.parameters()]

    # the kernel's route, its launch the plain twin on the CPU: the same
    # step, counted on the other counter
    model = _model()
    monkeypatch.setattr(kernels, 'wgrad_kernel_wins', lambda *args: True)
    launches = reflect_conv_wgrad.launches
    _step(model)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _step(model, seed=1)
    counts = trace.snapshot()['counts']
    assert counts.get('conv_ad.wgrad_kernel') == n_fused
    assert 'conv_ad.wgrad_cudnn' not in counts
    assert reflect_conv_wgrad.launches == launches
    for got, want in zip(model._gen.parameters(), library):
        torch.testing.assert_close(got.detach(), want, rtol=0, atol=0)
    trace.reset()
