"""The route a fused block takes on the card (``FusedReflectConv.route``,
from the rules of ``ops/kernels.py``), on the CPU: the route that sends a
block to the hand-written ``reflect_conv`` kernel is a function of the
input's shape, dtype and device type, of the grad mode and of the shard
context, so a stand-in for a CUDA tensor drives it; the block's packed
weights are made once per weight version; a training step never takes
the kernel route; the route counters count while a profiler records
(the kernel's launch emulated from the packed weights) and agree with
the routes ``route`` names; and the kernel rules and the pack cache live
in ``ops/kernels.py`` alone (read as ASTs)."""

import ast
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sup3r_tpu_torch.configs import generator_st
from sup3r_tpu_torch.models import Sup3rGan
from sup3r_tpu_torch.models.fuse import FusedReflectConv
from sup3r_tpu_torch.models.weights import params_from_jax, params_to_jax
from sup3r_tpu_torch.ops import kernels as tk
from sup3r_tpu_torch.utilities import trace

torch.set_num_threads(1)

FEATURES = ['u_100m', 'v_100m']
#: the benchmark's node cell's body blocks: (input shape, co), padded
#: chunks (20, 20, 56) in device batches of 8
NODE_BODY = [((8, 2, 20, 20, 56), 64), ((8, 64, 20, 20, 112), 64),
             ((8, 64, 20, 20, 224), 64), ((8, 64, 20, 20, 224), 72)]
#: shapes cuDNN was timed faster on (an H100; PERF.md's kernel table)
CUDNN_FASTER = [((1, 64, 2, 2, 2), 64), ((4, 64, 3, 3, 3), 64),
                ((8, 64, 4, 4, 4), 64), ((2, 64, 9, 11, 13), 64),
                ((1, 512, 12, 12, 12), 64), ((1, 1024, 8, 8, 8), 64)]
#: shapes of the shipped generators the kernel was timed faster on: the
#: chains' 2D and t = 6 blocks, their narrow tails, a chain chunk's
#: 35 x 35 x 5 body, batch-1 and training-validation sizes
KERNEL_FASTER = [((1, 64, 35, 35, 5), 64), ((1, 64, 70, 70, 6), 64),
                 ((1, 32, 70, 70, 144), 2), ((1, 64, 70, 70, 48), 1),
                 ((6, 64, 14, 14), 1600), ((5, 64, 7, 7), 64),
                 ((1, 2, 20, 20, 24), 64), ((16, 64, 12, 12, 24), 64),
                 ((8, 256, 20, 20, 56), 64), ((2, 64, 2, 2), 64)]


class CudaInput:
    """What the predicate reads of a CUDA tensor."""

    is_cuda = True

    def __init__(self, shape, dtype=torch.float32):
        self.shape = torch.Size(shape)
        self.ndim = len(shape)
        self.dtype = dtype


def _block(x_shape, co):
    return FusedReflectConv(len(x_shape) - 2, SimpleNamespace(filters=co))


def _route(x_shape, co, ctx=None, grad=False, **kwargs):
    """Whether the block takes the ``reflect_conv`` kernel by default."""
    with torch.set_grad_enabled(grad):
        return _block(x_shape, co).route(CudaInput(x_shape, **kwargs),
                                         ctx or {}) == 'body'


@pytest.mark.parametrize('x_shape, co', NODE_BODY + KERNEL_FASTER)
def test_node_cell_and_shipped_blocks_take_the_kernel(x_shape, co):
    assert _route(x_shape, co)


@pytest.mark.parametrize('x_shape, co', CUDNN_FASTER)
def test_shapes_cudnn_won_stay_on_cudnn(x_shape, co):
    assert not tk.body_kernel_wins(CudaInput(x_shape))
    assert not _route(x_shape, co)


@pytest.mark.parametrize('case', ['bf16', 'grad', 'shard', 'small_tail',
                                  'dim_below_2', 'cpu', 'wide_input',
                                  'batch_past_grid'])
def test_predicate_declines(case):
    x_shape, co = NODE_BODY[2]
    if case == 'bf16':
        assert not _route(x_shape, co, dtype=torch.bfloat16)
    elif case == 'grad':
        assert not _route(x_shape, co, grad=True)
    elif case == 'shard':
        shard = SimpleNamespace(gather_small=False)
        assert not _route(x_shape, co, ctx={'spatial': shard, 's1': 20})
    elif case == 'small_tail':
        # the flagship's HR 8 -> 2 tail is the small kernel's
        assert not _route((8, 8, 60, 60, 224), 2)
        block = _block((8, 8, 60, 60, 224), 2)
        block.small_channel_kernel = False
        with torch.no_grad():
            assert block.route(CudaInput((8, 8, 60, 60, 224)),
                               {}) == 'body'
    elif case == 'dim_below_2':
        assert not _route((8, 64, 20, 20, 1), co)
    elif case == 'cpu':
        with torch.no_grad():
            assert _block(x_shape, co).route(torch.zeros(1, 64, 4, 4, 4),
                                             {}) != 'body'
    elif case == 'wide_input':
        assert not _route((8, 512, 20, 20, 56), 64)
    else:
        assert not _route((70000, 64, 14, 14), 64)


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


def _body_blocks(network):
    """The fused blocks the small kernel does not take."""
    return [lyr for lyr in network.layers
            if isinstance(lyr, FusedReflectConv) and not tk.small_kernel_wins(
                torch.zeros((1, lyr.weight.shape[1]) + (2,) * lyr.n_spatial),
                lyr.conv.filters)]


def _lr(seed=0, n=2):
    rng = np.random.default_rng(seed)
    return rng.random((n, 4, 4, 4, 2), dtype=np.float32)


def _step(model, seed=0):
    rng = np.random.default_rng(seed)
    hr = rng.random((2, 8, 8, 8, 2), dtype=np.float32)
    return model.run_gradient_descent(_lr(seed), hr, train_gen=True,
                                      train_disc=True)


def test_packed_weights_are_cached_per_weight_version():
    model = _model()
    block = _body_blocks(model._get_fused_apply())[0]

    def packed():
        return block.packed_weights.get(block.conv.weight, block.weight)

    n_tile, first = packed()
    assert n_tile == tk.reflect_conv_n_tile(block.weight.shape[0])
    assert torch.equal(first, tk.pack_weights(block.weight, n_tile))
    assert packed()[1] is first
    # the optimizer's in-place update
    params = list(model._gen.parameters())
    with torch.no_grad():
        torch._foreach_add_(params, [torch.full_like(p, 0.01)
                                     for p in params])
    updated = packed()[1]
    assert updated is not first
    assert torch.equal(updated, tk.pack_weights(block.weight, n_tile))
    assert not torch.equal(updated, first)
    assert packed()[1] is updated
    # new params loaded over the old ones
    params_from_jax(model._gen, params_to_jax(_model(seed=1)._gen))
    loaded = packed()[1]
    assert loaded is not updated
    assert torch.equal(loaded, tk.pack_weights(block.weight, n_tile))
    # a training step updates the params in place too
    _step(model)
    assert packed()[1] is not loaded


def test_training_step_never_reaches_the_kernel_route(monkeypatch):
    """Each fused body block's route, asked as though its input were on
    the card: never the kernel in a training step (gradients on), the
    kernel for every body block when serving."""
    asked = []
    real = FusedReflectConv.route

    def spy(self, x, ctx):
        route = real(self, CudaInput(tuple(x.shape), x.dtype), ctx)
        if route != 'small':
            asked.append(route == 'body')
        return real(self, x, ctx)

    monkeypatch.setattr(FusedReflectConv, 'route', spy)
    model = _model()
    assert model.train_fuse
    _step(model)
    n_body = len(_body_blocks(model._train_gen_net()))
    assert n_body > 0 and len(asked) == n_body
    assert not any(asked)
    asked.clear()
    model.generate(_lr())
    assert asked == [True] * n_body


def _emulated_launch(x, packed, bias, co, n_tile, alpha=None):
    """``reflect_conv_packed`` on the CPU: the weights rebuilt from the
    packing (hi + lo) through the kernels' plain version."""
    n_tiles, chunks, k0, taps, _, halves, _, k4 = packed.shape
    n_spatial = x.ndim - 2
    w = packed.permute(4, 0, 6, 1, 5, 7, 2, 3).reshape(
        2, n_tiles * n_tile, chunks * halves * k4, *(3,) * n_spatial)
    w = (w[0] + w[1])[:co, :x.shape[1]]
    return tk.reflect_conv_reference(x, w, bias, alpha)


def _kernel_route(monkeypatch):
    """Every fused body block on the ``reflect_conv`` route, its launch
    emulated on the CPU."""
    real = FusedReflectConv.route
    monkeypatch.setattr(
        FusedReflectConv, 'route',
        lambda self, x, ctx: ('body' if real(self, x, ctx) == 'library'
                              else real(self, x, ctx)))
    monkeypatch.setattr(tk, 'reflect_conv_packed', _emulated_launch)


def test_route_counters_while_the_profiler_records(monkeypatch):
    model = _model()
    lr = _lr()
    library = model.generate(lr)
    n_body = len(_body_blocks(model._get_fused_apply()))
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        model.generate(lr)
    assert trace.snapshot()['counts'] == {'fuse.body_cudnn': n_body}

    # the kernel route, its launch emulated
    _kernel_route(monkeypatch)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        first = model.generate(lr)
    assert trace.snapshot()['counts'] == {'fuse.body_kernel': n_body,
                                          'fuse.body_pack': n_body}
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        again = model.generate(lr)
    assert trace.snapshot()['counts'] == {'fuse.body_kernel': n_body}
    np.testing.assert_array_equal(again, first)
    # hi + lo rebuilds each weight to 2^-22 relative
    assert np.abs(first - library).max() <= 1e-5 * np.abs(library).max()
    trace.reset()


@pytest.mark.parametrize('kernel', [False, True], ids=['library', 'body'])
def test_route_agrees_with_the_counters(monkeypatch, kernel):
    """The routes ``route`` names for a served network's blocks are the
    ones its counters count: 'body' as ``fuse.body_kernel``, 'library'
    as ``fuse.body_cudnn``, the small kernel's blocks as neither, and
    one packing for each block on the kernel."""
    model = _model()
    if kernel:
        _kernel_route(monkeypatch)
    routes = []
    real = FusedReflectConv.route

    def spy(self, x, ctx):
        routes.append(real(self, x, ctx))
        return routes[-1]

    monkeypatch.setattr(FusedReflectConv, 'route', spy)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        model.generate(_lr())
    counts = trace.snapshot()['counts']
    trace.reset()
    blocks = [lyr for lyr in model._get_fused_apply().layers
              if isinstance(lyr, FusedReflectConv)]
    assert len(routes) == len(blocks)
    assert routes.count('small') == len(blocks) - len(_body_blocks(
        model._get_fused_apply())) > 0
    assert set(routes) == {'small', 'body' if kernel else 'library'}
    want = {'fuse.body_kernel': routes.count('body'),
            'fuse.body_cudnn': routes.count('library'),
            'fuse.body_pack': routes.count('body')}
    assert counts == {k: v for k, v in want.items() if v}


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(rel):
    with open(os.path.join(ROOT, 'sup3r_tpu_torch', rel)) as f:
        return ast.parse(f.read())


def _imported_modules(tree):
    """Every module an import anywhere in ``tree`` names, function-level
    imports included: ``from a.b import c`` gives 'a.b' and 'a.b.c'."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
            out.update(f'{node.module}.{a.name}' for a in node.names)
    return out


def _names(tree):
    """Every identifier ``tree`` defines, assigns, reads or imports."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Name):
            out.add(node.id)
        elif isinstance(node, ast.Attribute):
            out.add(node.attr)
        elif isinstance(node, ast.alias):
            out.add(node.asname or node.name.split('.')[-1])
    return out


#: the launches of ``ops/kernels.py``, each the caller of a C entry point
LAUNCHES = ('small_reflect_conv_packed', 'reflect_conv_packed',
            'reflect_conv_wgrad')


@pytest.mark.parametrize('check', [
    'kernels_imports_no_conv_ad', 'kernels_imports_no_models',
    'fuse_imports_no_launch', 'fuse_has_no_kernel_constant',
    'fuse_has_no_pack_cache', 'kernels_holds_the_rules'])
def test_kernel_choice_has_one_home(check):
    """``ops/kernels.py`` holds the kernel rules, the pack cache and the
    launches and imports nothing above it; ``models/fuse.py`` keeps none
    of them."""
    kernels, fuse = _tree('ops/kernels.py'), _tree('models/fuse.py')
    if check == 'kernels_imports_no_conv_ad':
        assert not any(m.startswith('sup3r_tpu_torch.ops.conv_ad')
                       for m in _imported_modules(kernels))
    elif check == 'kernels_imports_no_models':
        assert not any(m.startswith('sup3r_tpu_torch.models')
                       for m in _imported_modules(kernels))
    elif check == 'fuse_imports_no_launch':
        assert not _names(fuse) & set(LAUNCHES)
    elif check == 'fuse_has_no_kernel_constant':
        defined = {t.id for node in ast.walk(fuse)
                   if isinstance(node, ast.Assign)
                   for t in node.targets if isinstance(t, ast.Name)}
        defined |= {node.name for node in ast.walk(fuse) if isinstance(
            node, (ast.FunctionDef, ast.ClassDef))}
        assert not {n for n in defined if '_KERNEL_' in n}
        assert not defined & {'body_kernel_wins', '_small_ok', '_body_ok'}
        assert not _names(fuse) & {'_small_ok', '_body_ok'}
    elif check == 'fuse_has_no_pack_cache':
        names = _names(fuse)
        assert '_packed' not in names and '_pack' not in names
        assert 'pack_weights' not in names
    else:
        defined = {node.name for node in kernels.body
                   if isinstance(node, (ast.FunctionDef, ast.ClassDef))}
        assert {'small_kernel_wins', 'body_kernel_wins',
                'wgrad_kernel_wins', 'PackedWeights', 'SmallReflectConv',
                'reflect_conv_backward', *LAUNCHES} <= defined
