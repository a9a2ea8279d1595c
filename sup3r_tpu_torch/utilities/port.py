"""Import reference (NREL sup3r / phygnn TensorFlow) model checkpoints
(the port of ``sup3r_tpu/utilities/port.py``).

The reference distributes trained GANs as a directory of
``model_params.json`` + ``model_gen.pkl`` / ``model_disc.pkl``, where
the pickles are phygnn ``CustomNetwork.model_params`` dicts holding the
``hidden_layers`` JSON config and a flat list of numpy weight arrays in
TF ``layer.get_weights()`` order (reference: sup3r/models/base.py:133-
197, phygnn CustomNetwork.save). This module unpickles those without
phygnn/TF installed (unknown classes are stubbed), converts the TF
weight layouts to the JAX package's (which the port's layers load), and
returns a ready ``Sup3rGan`` on the requested device.

Weight-layout recipe (validated in tests/parity/test_tf_parity.py):
  - Conv2D/Conv3D/Dense kernels: identical layout (HWIO / in,out).
  - Conv*Transpose: TF stores (..., out, in) — flip the spatial dims
    and swap the last two axes.

Unpickling runs code named by the pickle: load only checkpoints from a
source you trust.
"""

import json
import logging
import os
import pickle

import numpy as np
import torch

import sup3r_tpu_torch
from sup3r_tpu_torch.models.network import Network
from sup3r_tpu_torch.models.weights import params_from_jax, params_to_jax
from sup3r_tpu_torch.utilities.utilities import safe_serialize

logger = logging.getLogger(__name__)

__all__ = ['load_phygnn_pickle', 'import_phygnn_network',
           'load_reference_gan', 'export_reference_gan']

_TRANSPOSE = ('Conv2DTranspose', 'Conv3DTranspose')


class _Stub:
    """Placeholder for unpicklable foreign classes (phygnn/TF/keras
    objects); captures state so weights nested inside still surface."""

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__['state'] = state

    def __reduce__(self):  # pragma: no cover
        return (_Stub, ())


class _TolerantUnpickler(pickle.Unpickler):
    _FOREIGN = ('phygnn', 'tensorflow', 'keras', 'tf_keras')

    def find_class(self, module, name):
        root = module.split('.')[0]
        if root in self._FOREIGN:
            return type(name, (_Stub,), {})
        return super().find_class(module, name)


def _find_weights(obj, out):
    """Recursively collect numpy arrays from a stubbed object tree in
    traversal order."""
    if isinstance(obj, np.ndarray):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _find_weights(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _find_weights(x, out)
    elif isinstance(obj, _Stub):
        _find_weights(obj.__dict__, out)


def load_phygnn_pickle(fp):
    """(hidden_layers_config, weights_list) from a phygnn
    CustomNetwork pickle. Raises with a clear message when the pickle
    doesn't carry a recognizable network."""
    with open(fp, 'rb') as f:
        obj = _TolerantUnpickler(f).load()
    if not isinstance(obj, dict):
        raise ValueError(
            f'{fp}: expected a phygnn model_params dict, got '
            f'{type(obj).__name__}')
    config = obj.get('hidden_layers')
    if config is None:
        raise ValueError(
            f'{fp}: no "hidden_layers" entry — not a phygnn '
            f'CustomNetwork pickle (keys: {sorted(obj)})')
    weights = obj.get('weights')
    if weights is None:
        found = []
        _find_weights(obj, found)
        weights = found
    weights = [np.asarray(w) for w in weights]
    if not weights:
        raise ValueError(f'{fp}: no weight arrays found')
    return list(config), weights


def _load_tf_weights(net, weights):
    """Load a flat TF-ordered weights list into an initialized
    ``Network``; returns its per-layer params in the JAX package's
    layout."""
    unsupported = [lay.get('class') for lay in net.config or []
                   if isinstance(lay, dict)
                   and 'norm' in str(lay.get('class', '')).lower()]
    if unsupported:
        raise NotImplementedError(
            f'Checkpoint config contains {unsupported} layers whose '
            'weights (gamma/beta/moving stats) interleave the flat TF '
            'weights list — importing normalization layers is not '
            'supported')
    params = params_to_jax(net)
    queue = list(weights)
    for idx, (p, lyr) in enumerate(zip(params, net.layers)):
        if 'kernel' not in p:
            continue
        if 'kernel_out' in p:
            # two-stage Sup3rObsModel(filters=...): phygnn's layout for
            # it is not mapped; keeping random kernel_out / bias_out
            # would corrupt the imported model
            raise NotImplementedError(
                f'Layer #{idx} ({type(lyr).__name__}) uses a '
                'two-stage obs projection (filters set); importing '
                'its weights from a reference checkpoint is not '
                'supported — re-train or drop ``filters``')
        if len(queue) < 2:
            raise ValueError(
                'Ran out of weight arrays while importing layer '
                f'#{idx} ({type(lyr).__name__}); the config and the '
                'pickle disagree')
        expected_ndim = p['kernel'].ndim
        if queue[0].ndim != expected_ndim:
            raise ValueError(
                f'Layer #{idx} ({type(lyr).__name__}) expects a '
                f'{expected_ndim}-d kernel but the next checkpoint '
                f'array is {queue[0].ndim}-d — the pickle carries '
                'weights (batch-norm?) this importer does not map')
        kernel = np.asarray(queue.pop(0), dtype=np.float32)
        bias = np.asarray(queue.pop(0), dtype=np.float32)
        if type(lyr).__name__ in _TRANSPOSE:
            # TF convT kernels are (..., out, in): flip the spatial dims
            # and swap io (tests/parity/test_tf_parity.py:67-82)
            kernel = np.swapaxes(np.flip(kernel, tuple(range(
                kernel.ndim - 2))), -1, -2)
        if kernel.shape != p['kernel'].shape:
            raise ValueError(
                f'Layer #{idx} ({type(lyr).__name__}): imported '
                f'kernel shape {kernel.shape} != expected '
                f'{p["kernel"].shape}')
        params[idx] = {'bias': bias, 'kernel': np.ascontiguousarray(kernel)}
    if queue:
        logger.warning(
            'Import left %d unconsumed weight arrays (batch-norm or '
            'non-conv layers are not ported)', len(queue))
    params_from_jax(net, params)
    return params


def import_phygnn_network(config, weights, in_shape):
    """Build a ``Network`` from a reference hidden_layers config and a
    flat TF-ordered weights list; returns (network, params), the params
    per layer in the JAX package's layout (numpy), loaded into the
    network."""
    net = Network(config)
    net.init(tuple(in_shape), torch.Generator().manual_seed(0))
    return net, _load_tf_weights(net, weights)


def _to_tf_weights(net):
    """Flat TF ``get_weights()``-layout list of a Network's params
    (inverse of the import recipe)."""
    out = []
    for p, lyr in zip(params_to_jax(net), net.layers):
        if 'kernel' not in p:
            continue
        k = p['kernel']
        if type(lyr).__name__ in _TRANSPOSE:
            k = np.flip(np.swapaxes(k, -1, -2), tuple(range(k.ndim - 2)))
        out.append(np.ascontiguousarray(k, dtype=np.float32))
        out.append(np.asarray(p['bias'], dtype=np.float32))
    return out


def export_reference_gan(model, out_dir):
    """Write a port ``Sup3rGan`` as a reference-format model directory
    (model_params.json + model_gen.pkl / model_disc.pkl in phygnn
    model_params layout), which reference tooling — or either package's
    ``load_reference_gan`` — reads."""
    if model.generator.config is None:
        raise ValueError(
            'Cannot export: the generator was built from Layer '
            'objects, not a hidden_layers config — reference '
            'checkpoints need the JSON layer config')
    os.makedirs(out_dir, exist_ok=True)
    record = {'sup3r_tpu_torch': sup3r_tpu_torch.__version__}
    nets = {'model_gen.pkl': model.generator}
    if model.disc_params is not None:
        nets['model_disc.pkl'] = model.discriminator
    for name, net in nets.items():
        with open(os.path.join(out_dir, name), 'wb') as f:
            pickle.dump({'hidden_layers': net.config,
                         'weights': _to_tf_weights(net),
                         'version_record': record}, f)
    params_json = safe_serialize({
        'name': getattr(model, 'name', type(model).__name__),
        'means': model._means, 'stdevs': model._stdevs,
        'meta': dict(model.meta),
        'version_record': record}, indent=2)
    with open(os.path.join(out_dir, 'model_params.json'), 'w') as f:
        f.write(params_json)
    logger.info('Exported reference-format model to %s', out_dir)
    return out_dir


def load_reference_gan(model_dir, lr_shape=None, hr_shape=None,
                       device='cuda'):
    """Load a reference-trained Sup3rGan directory (model_params.json
    + model_gen.pkl [+ model_disc.pkl]) into the port's ``Sup3rGan`` on
    ``device``, with its weights, fresh optimizer states and input shapes
    set, so it fine-tunes and survives a save / load round trip. A
    directory without a discriminator gets a seeded stand-in (Flatten +
    Dense).

    ``lr_shape``/``hr_shape``: one-sample input shapes used to resolve
    conv channel counts ((1, s1, s2, [t,] n_features) — inferred from
    the meta when omitted)."""
    from sup3r_tpu_torch.models import Sup3rGan

    with open(os.path.join(model_dir, 'model_params.json')) as f:
        saved = json.load(f)
    meta = saved.get('meta', {})

    gen_cfg, gen_w = load_phygnn_pickle(
        os.path.join(model_dir, 'model_gen.pkl'))
    fp_disc = os.path.join(model_dir, 'model_disc.pkl')
    disc_cfg, disc_w = (load_phygnn_pickle(fp_disc)
                        if os.path.exists(fp_disc) else (None, None))

    model = Sup3rGan(gen_cfg, disc_cfg or [
        {'class': 'Flatten'}, {'class': 'Dense', 'units': 1}],
        device=device)
    model.meta.update(meta)

    n_feats = len(meta.get('lr_features') or []) or 2
    if lr_shape is None:
        # the default spatial extent keeps the DISC's init input >= 64
        # px after enhancement: production 'valid'-padding
        # discriminators need >= 61 px
        s_enh = max(int(meta.get('s_enhance') or 1), 1)
        t_enh = max(int(meta.get('t_enhance') or 1), 1)
        s_lr = max(8, -(-64 // s_enh))
        t_lr = max(8, -(-64 // t_enh))
        lr_shape = ((1, s_lr, s_lr, t_lr, n_feats) if model.generator.is_5d
                    else (1, s_lr, s_lr, n_feats))
    if hr_shape is None:
        n_out = len(meta.get('hr_out_features') or []) or n_feats
        s, t = model.s_enhance, model.t_enhance
        hr_shape = (1, lr_shape[1] * s, lr_shape[2] * s,
                    *([lr_shape[3] * t] if len(lr_shape) == 5 else []),
                    n_out)
    model.init_weights(tuple(lr_shape), tuple(hr_shape), seed=0)
    _load_tf_weights(model.generator, gen_w)
    if disc_cfg is not None:
        _load_tf_weights(model.discriminator, disc_w)
    # unconditional, as in Sup3rGan.load: set_norm_stats takes each
    # argument's None itself (gating on both would drop half-present
    # stats and generate on un-normalized input)
    model.set_norm_stats(saved.get('means'), saved.get('stdevs'))
    logger.info('Imported reference model from %s (%d gen + %d disc '
                'weight arrays)', model_dir, len(gen_w), len(disc_w or []))
    return model
