"""Content-loss library in torch (the port of ``sup3r_tpu/ops/losses.py``).

Every loss is a plain function ``loss(x1, x2) -> scalar tensor``
(synthetic first, ground truth second) resolved by name with
:func:`get_loss_fun`, differentiable under autograd. Batches keep the JAX
package's feature-last layout: 4D ``(n, s1, s2, f)`` spatial or 5D
``(n, s1, s2, t, f)`` spatiotemporal.

Losses that draw random numbers (``SlicedWassersteinLoss``) take a
``torch.Generator`` where the JAX package takes a PRNG key; they declare
``needs_generator`` and :func:`apply_loss` threads one to them only.
"""

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F


def mae(x1, x2):
    """Mean absolute error."""
    return torch.mean(torch.abs(x1 - x2))


def mse(x1, x2):
    """Mean squared error."""
    return torch.mean((x1 - x2) ** 2)


def _central_diff(x, axis):
    """np.gradient-style central difference along ``axis`` (one-sided at
    the boundaries)."""
    n = x.shape[axis]
    first = x.narrow(axis, 1, 1) - x.narrow(axis, 0, 1)
    mid = (x.narrow(axis, 2, n - 2) - x.narrow(axis, 0, n - 2)) / 2
    last = x.narrow(axis, n - 1, 1) - x.narrow(axis, n - 2, 1)
    return torch.cat([first, mid, last], dim=axis)


def exp_loss(x1, x2):
    """Squared-exponential difference: mean(1 - exp(-(x1-x2)^2))."""
    return torch.mean(1 - torch.exp(-((x1 - x2) ** 2)))


def _gaussian_kernel_mean(x1, x2, sigma=1.0):
    """mean_{i,j} exp(-0.5 * ||x1_i - x2_j||^2 / sigma^2) comparing every
    observation to every other observation over the last axis."""
    sq = torch.sum((x1[:, None] - x2[None]) ** 2, dim=-1)
    return torch.mean(torch.exp(-0.5 * sq / sigma**2))


def mmd_loss(x1, x2, sigma=1.0):
    """Maximum mean discrepancy with a gaussian kernel."""
    return (
        _gaussian_kernel_mean(x1, x1, sigma)
        + _gaussian_kernel_mean(x2, x2, sigma)
        - 2 * _gaussian_kernel_mean(x1, x2, sigma)
    )


def mmd_mse_loss(x1, x2, sigma=1.0):
    """MMD + MSE combination."""
    return mmd_loss(x1, x2, sigma=sigma) + mse(x1, x2)


def _material_derivative(x, fidx):
    """Df/Dt = df/dt + u df/dx + v df/dy for feature channel ``fidx``,
    assuming channels 2k/2k+1 hold the u/v pair for channel pair k."""
    uidx = 2 * (fidx // 2)
    vidx = uidx + 1
    md = _central_diff(x[..., fidx], axis=3)
    md = md + x[..., uidx] * _central_diff(x[..., fidx], axis=1)
    md = md + x[..., vidx] * _central_diff(x[..., fidx], axis=2)
    return md


def material_derivative_loss(x1, x2):
    """MAE between material derivatives of u channels (5D only)."""
    assert x1.ndim == 5 and x2.ndim == 5, (
        'MaterialDerivativeLoss requires 5D spatiotemporal tensors')
    n_pairs = x1.shape[-1] // 2
    x1_md = torch.stack(
        [_material_derivative(x1, 2 * i) for i in range(n_pairs)])
    x2_md = torch.stack(
        [_material_derivative(x2, 2 * i) for i in range(n_pairs)])
    return mae(x1_md, x2_md)


def spatial_derivative_loss(x1, x2):
    """MAE of summed spatial central differences (>=4D)."""
    assert x1.ndim >= 4 and x2.ndim >= 4
    d1 = _central_diff(x1, 1) + _central_diff(x1, 2)
    d2 = _central_diff(x2, 1) + _central_diff(x2, 2)
    return mae(d1, d2)


def temporal_derivative_loss(x1, x2):
    """MAE of temporal central differences (5D only)."""
    assert x1.ndim == 5 and x2.ndim == 5
    return mae(_central_diff(x1, 3), _central_diff(x2, 3))


def coarse_mse_loss(x1, x2):
    """MSE of spatial means (full spatial collapse)."""
    return mse(torch.mean(x1, dim=(1, 2)), torch.mean(x2, dim=(1, 2)))


def spatial_extremes_loss(x1, x2):
    """Mean of MAE on spatial minima and spatial maxima."""
    mae_min = mae(torch.amin(x1, dim=(1, 2)), torch.amin(x2, dim=(1, 2)))
    mae_max = mae(torch.amax(x1, dim=(1, 2)), torch.amax(x2, dim=(1, 2)))
    return (mae_min + mae_max) / 2


def temporal_extremes_loss(x1, x2):
    """Mean of MAE on temporal minima and maxima (5D, time axis=3)."""
    mae_min = mae(torch.amin(x1, dim=3), torch.amin(x2, dim=3))
    mae_max = mae(torch.amax(x1, dim=3), torch.amax(x2, dim=3))
    return (mae_min + mae_max) / 2


def spatial_extremes_only_loss(x1, x2):
    """Alias used by some reference configs."""
    return spatial_extremes_loss(x1, x2)


def temporal_extremes_only_loss(x1, x2):
    """Alias used by some reference configs."""
    return temporal_extremes_loss(x1, x2)


def _freq_weights(shape_st, device):
    """Outer product of squared wavenumbers for the given spatial(-temporal)
    shape, used to emphasize high frequencies."""
    grids = [np.arange(n) ** 2 for n in shape_st]
    w = functools.reduce(np.multiply.outer, grids)
    return torch.as_tensor(w[np.newaxis, ..., np.newaxis],
                           dtype=torch.float32, device=device)


def _fft_spec(x, dims):
    """log(1 + k^2-weighted |FFT|) over ``dims``."""
    xh = torch.abs(torch.fft.fftn(x.to(torch.complex64), dim=dims))
    shape = [x.shape[d] for d in dims]
    return torch.log1p(xh.to(x.dtype) * _freq_weights(shape, x.device))


def spatial_fft_loss(x1, x2):
    """MAE of log(1 + k^2-weighted |FFT2|) over spatial dims (4D)."""
    return mae(_fft_spec(x1, (1, 2)), _fft_spec(x2, (1, 2)))


def spatiotemporal_fft_loss(x1, x2):
    """MAE of log(1 + weighted |FFT3|) over space+time dims (5D)."""
    return mae(_fft_spec(x1, (1, 2, 3)), _fft_spec(x2, (1, 2, 3)))


class LowResLoss:
    """Pointwise loss on re-coarsened (synthetic, true) high-res pairs."""

    EX_LOSSES = {
        'SpatialExtremesLoss': spatial_extremes_loss,
        'TemporalExtremesLoss': temporal_extremes_loss,
    }
    PW_LOSSES = {
        'MeanSquaredError': mse,
        'MeanAbsoluteError': mae,
    }

    def __init__(self, s_enhance=1, t_enhance=1, t_method='average',
                 tf_loss='MeanSquaredError', ex_loss=None):
        self._s = s_enhance
        self._t = t_enhance
        self._t_method = str(t_method).casefold()
        # a t_method other than 'average' / 'subsample' would silently
        # apply no temporal coarsening; validate up front instead
        if self._t > 1 and self._t_method not in ('average', 'subsample'):
            raise ValueError(
                f'LowResLoss t_method="{t_method}" is not a valid '
                'option; must be "average" or "subsample"')
        self._pw = self.PW_LOSSES[tf_loss]
        self._ex = self.EX_LOSSES[ex_loss] if ex_loss else None

    def _coarsen(self, x):
        if self._s > 1:
            n, s1, s2 = x.shape[:3]
            trail = x.shape[3:]
            x = x.reshape(n, s1 // self._s, self._s, s2 // self._s,
                          self._s, *trail)
            x = torch.sum(x, dim=(2, 4)) / self._s**2
        if self._t > 1:
            if x.ndim != 5:
                raise ValueError(
                    'LowResLoss with t_enhance > 1 needs 5D '
                    f'(n, s1, s2, t, f) tensors, got shape {tuple(x.shape)}')
            if self._t_method == 'subsample':
                x = x[:, :, :, ::self._t, :]
            else:
                n, s1, s2, t, f = x.shape
                x = x.reshape(n, s1, s2, t // self._t, self._t, f)
                x = torch.sum(x, dim=4) / self._t
        return x

    def __call__(self, x1, x2):
        assert x1.shape == x2.shape
        ex = self._ex(x1, x2) if self._ex is not None else 0.0
        return self._pw(self._coarsen(x1), self._coarsen(x2)) + ex


class SlicedWassersteinLoss:
    """Sliced Wasserstein distance via sorted random 1D projections.

    Projection directions are redrawn at every call from the
    ``generator`` the caller threads (the train step seeds one per
    step); with ``generator=None`` a generator seeded with the instance
    seed gives a fixed-projection loss for standalone evaluation. The
    draws differ from the JAX package's (``jax.random`` against torch's
    generator); ``project`` takes given projections, which is how the
    tests hold the two packages to one value."""

    needs_generator = True

    def __init__(self, n_projections=1024, seed=0):
        self._n_projections = n_projections
        self._seed = seed

    @staticmethod
    def _flat(x):
        assert x.ndim in (4, 5), 'SWL needs 4D or 5D tensors'
        if x.ndim == 4:
            x = x[:, :, :, None, :]
        b, h, w, t, c = x.shape
        return x.reshape(b, h * w * t, c)

    def projections(self, x, generator=None):
        """(n_projections, h * w * t) unit directions drawn on x's
        device."""
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(
                self._seed)
        hwt = int(np.prod(x.shape[1:-1]))
        proj = torch.randn((self._n_projections, hwt), generator=generator,
                           device=x.device, dtype=x.dtype)
        return proj / torch.linalg.norm(proj, dim=-1, keepdim=True)

    def project(self, x1, x2, proj):
        """The distance along the given unit ``proj`` directions."""
        p1 = torch.einsum('ph,bhc->bpc', proj, self._flat(x1))
        p2 = torch.einsum('ph,bhc->bpc', proj, self._flat(x2))
        return torch.mean((torch.sort(p1, dim=1).values
                           - torch.sort(p2, dim=1).values) ** 2)

    def __call__(self, x1, x2, generator=None):
        return self.project(x1, x2, self.projections(x1, generator))


def apply_loss(loss_fun, x1, x2, generator=None):
    """Call ``loss_fun(x1, x2)``, threading ``generator`` only to losses
    that declare ``needs_generator`` (per-call randomized losses like
    :class:`SlicedWassersteinLoss`)."""
    if getattr(loss_fun, 'needs_generator', False):
        return loss_fun(x1, x2, generator=generator)
    return loss_fun(x1, x2)


#: VGG16 feature-trunk topology (layer name order and pool placement;
#: channel counts come from the imported weights themselves).
_VGG16_TOPOLOGY = (
    'block1_conv1', 'block1_conv2', 'block1_pool',
    'block2_conv1', 'block2_conv2', 'block2_pool',
    'block3_conv1', 'block3_conv2', 'block3_conv3', 'block3_pool',
    'block4_conv1', 'block4_conv2', 'block4_conv3', 'block4_pool',
    'block5_conv1', 'block5_conv2', 'block5_conv3', 'block5_pool',
)

#: keras.applications.vgg16.preprocess_input 'caffe' channel means; the
#: inputs are grayscale-replicated to 3 channels so the RGB->BGR flip is
#: a no-op and only the per-channel mean subtraction matters.
_VGG16_MEANS = np.array([103.939, 116.779, 123.68], dtype=np.float32)


def _conv_same(x, kernel):
    """'SAME' k3/s1 conv of a channels-last batch with an HWIO kernel."""
    w = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def _max_pool(x):
    """2x2 / stride 2 'VALID' max pool of a channels-last batch."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class PerceptualLoss:
    """Feature-map MSE, either with imported VGG16 weights (the
    reference's exact loss surface) or a FIXED random-projection
    extractor (the offline default). See the JAX package's
    ``PerceptualLoss`` for the weights' export recipe.

    The default filters are the committed checkpoint
    ``perceptual_v1.npz`` (the port's own copy of the JAX package's), so
    the loss value is the same on any machine; non-default
    ``n_filters``/``seed`` regenerate filters with numpy's PCG64."""

    WEIGHTS_V1 = os.path.join(os.path.dirname(__file__),
                              'perceptual_v1.npz')

    @staticmethod
    def make_kernels(n_filters=(64, 128), seed=0):
        """Generate the frozen extractor kernels (numpy PCG64)."""
        rng = np.random.default_rng(seed)
        kernels, c_in = [], 3
        for c_out in n_filters:
            k = rng.standard_normal(
                (3, 3, c_in, c_out)).astype(np.float32)
            kernels.append(k / np.sqrt(9 * c_in).astype(np.float32))
            c_in = c_out
        return kernels

    @classmethod
    def _load_vgg_weights(cls, weights):
        """{layer: (kernel, bias)} from an npz/dict of VGG16 conv
        weights; accepts '<layer>/kernel' or '<layer>_kernel' keys."""
        if isinstance(weights, str):
            with np.load(weights) as f:
                raw = {k: np.asarray(f[k]) for k in f.files}
        else:
            raw = {k: np.asarray(v) for k, v in dict(weights).items()}
        out = {}
        for key, val in raw.items():
            norm = key.replace('/', '_')
            for suffix in ('_kernel', '_bias'):
                if norm.endswith(suffix):
                    layer = norm[: -len(suffix)]
                    out.setdefault(layer, [None, None])
                    out[layer][suffix == '_bias'] = val.astype(
                        np.float32)
        missing = [k for k, v in out.items() if v[0] is None]
        if missing:
            raise ValueError(
                f'VGG16 weights missing kernels for {missing}')
        return {k: (v[0], v[1] if v[1] is not None
                    else np.zeros(v[0].shape[-1], np.float32))
                for k, v in out.items()}

    def __init__(self, layer_names=None, n_filters=(64, 128), seed=0,
                 weights=None):
        self.layer_names = (list(layer_names) if layer_names is not None
                            else ['block1_conv2', 'block2_conv2'])
        self._vgg = None
        if weights is not None:
            vgg = self._load_vgg_weights(weights)
            unknown = [n for n in self.layer_names
                       if n not in _VGG16_TOPOLOGY]
            if unknown:
                raise ValueError(
                    f'Unknown VGG16 layer_names {unknown}; expected '
                    f'among {list(_VGG16_TOPOLOGY)}')
            deepest = max(_VGG16_TOPOLOGY.index(n)
                          for n in self.layer_names)
            trunk = _VGG16_TOPOLOGY[:deepest + 1]
            need = [n for n in trunk if not n.endswith('_pool')]
            absent = [n for n in need if n not in vgg]
            if absent:
                raise ValueError(
                    f'VGG16 weights file lacks layers {absent} '
                    f'needed for {self.layer_names}')
            self._vgg = [(n, vgg.get(n)) for n in trunk]
            return
        self._n_filters = tuple(n_filters)
        default = self._n_filters == (64, 128) and seed == 0
        if default and os.path.exists(self.WEIGHTS_V1):
            with np.load(self.WEIGHTS_V1) as f:
                self._kernels = [f[k] for k in sorted(f.files)]
        else:
            self._kernels = self.make_kernels(self._n_filters, seed)

    def _feature_maps(self, x):
        if self._vgg is not None:
            x = x - torch.as_tensor(_VGG16_MEANS, dtype=x.dtype,
                                    device=x.device)
            maps = {}
            for name, wb in self._vgg:
                if name.endswith('_pool'):
                    x = _max_pool(x)
                    continue
                kernel, bias = wb
                x = torch.relu(_conv_same(x, kernel) + torch.as_tensor(
                    bias, dtype=x.dtype, device=x.device))
                if name in self.layer_names:
                    maps[name] = x
            return [maps[n] for n in self.layer_names]
        maps = []
        for k in self._kernels:
            x = torch.relu(_conv_same(x, k))
            maps.append(x)
            x = _max_pool(x)
        return maps

    def __call__(self, x1, x2):
        if x1.ndim == 5:
            n, s1, s2, t, f = x1.shape
            if self._vgg is not None:
                # the reference flattens 5D batches with a RAW reshape
                # (time interleaves into spatial rows)
                x1 = x1.reshape(n * t, s1, s2, f)
                x2 = x2.reshape(n * t, s1, s2, f)
            else:
                # the offline extractor batches time frames properly
                x1 = torch.movedim(x1, 3, 1).reshape(n * t, s1, s2, f)
                x2 = torch.movedim(x2, 3, 1).reshape(n * t, s1, s2, f)
        losses = []
        for i in range(x1.shape[-1]):
            a = x1[..., i:i + 1].repeat_interleave(3, dim=-1)
            b = x2[..., i:i + 1].repeat_interleave(3, dim=-1)
            fa = self._feature_maps(a)
            fb = self._feature_maps(b)
            losses.append(sum(torch.mean((u - v) ** 2)
                              for u, v in zip(fa, fb)))
        return torch.mean(torch.stack(losses))


def st_extremes_fft_loss(x1, x2):
    """Spatiotemporal extremes + fft composite."""
    return (spatial_extremes_loss(x1, x2) + temporal_extremes_loss(x1, x2)
            + spatiotemporal_fft_loss(x1, x2))


LOSS_REGISTRY = {
    'MeanSquaredError': mse,
    'MeanAbsoluteError': mae,
    'mse': mse,
    'mae': mae,
    'ExpLoss': exp_loss,
    'MmdLoss': mmd_loss,
    'MmdMseLoss': mmd_mse_loss,
    'MaterialDerivativeLoss': material_derivative_loss,
    'SpatialDerivativeLoss': spatial_derivative_loss,
    'TemporalDerivativeLoss': temporal_derivative_loss,
    'CoarseMseLoss': coarse_mse_loss,
    'SpatialExtremesLoss': spatial_extremes_loss,
    'TemporalExtremesLoss': temporal_extremes_loss,
    'SpatialExtremesOnlyLoss': spatial_extremes_only_loss,
    'TemporalExtremesOnlyLoss': temporal_extremes_only_loss,
    'SpatialFftLoss': spatial_fft_loss,
    'SpatiotemporalFftLoss': spatiotemporal_fft_loss,
    'StExtremesFftLoss': st_extremes_fft_loss,
    'LowResLoss': LowResLoss,
    'PerceptualLoss': PerceptualLoss,
    'SlicedWassersteinLoss': SlicedWassersteinLoss,
}


def get_loss_fun(loss):
    """Resolve a loss spec into a callable ``loss(x1, x2) -> scalar``.

    Accepts: a name string; a dict ``{Name: kwargs}`` for parameterized
    losses; a list of (name|dict, weight) pairs for weighted multi-term
    losses; or a callable passed through unchanged."""
    if callable(loss) and not isinstance(loss, str):
        return loss
    if isinstance(loss, str):
        if loss not in LOSS_REGISTRY:
            raise KeyError(
                f'Unknown loss "{loss}". Options: '
                f'{sorted(LOSS_REGISTRY)}')
        obj = LOSS_REGISTRY[loss]
        return obj() if isinstance(obj, type) else obj
    if isinstance(loss, dict):
        (name, kwargs), = loss.items()
        obj = LOSS_REGISTRY[name]
        if isinstance(obj, type):
            return obj(**kwargs)
        if kwargs:
            return functools.partial(obj, **kwargs)
        return obj
    if isinstance(loss, (list, tuple)):
        terms = []
        for item in loss:
            if isinstance(item, (list, tuple)) and len(item) == 2:
                spec, weight = item
            else:
                spec, weight = item, 1.0
            terms.append((get_loss_fun(spec), float(weight)))

        def multi(x1, x2, generator=None):
            total = 0.0
            for f, w in terms:
                total = total + w * apply_loss(f, x1, x2,
                                               generator=generator)
            return total

        multi.needs_generator = any(
            getattr(f, 'needs_generator', False) for f, _ in terms)
        return multi
    raise TypeError(f'Cannot resolve loss spec: {loss!r}')
