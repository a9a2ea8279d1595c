"""Model base classes (the port of ``sup3r_tpu/models/abstract.py``):
the inference contract, meta and feature properties, normalization
stats, the forward-pass exo combine for plain-array exo, the save
directory's ``model_params.json``, and the training surface: the content
loss, training-session params, the rolling loss record, the per-epoch
history (a pandas-free ``Record``, written as ``history.csv``) and early
stopping.

Structured ``ExoData`` exo comes with the data-plane slice.
"""

import json
import logging
import os
import platform
import sys

import numpy as np
import torch

import sup3r_tpu_torch
from sup3r_tpu_torch.models.network import Network
from sup3r_tpu_torch.models.record import Record
from sup3r_tpu_torch.names import strip_obs_suffix
from sup3r_tpu_torch.ops.losses import get_loss_fun
from sup3r_tpu_torch.utilities import safe_serialize

logger = logging.getLogger(__name__)

VERSION_RECORD = {
    'sup3r_tpu_torch': sup3r_tpu_torch.__version__,
    'torch': torch.__version__,
    'numpy': np.__version__,
    'python': sys.version,
    'platform': platform.platform(),
}


def _is_structured_exo(exogenous_data):
    """Whether ``exogenous_data`` is in the structured ``ExoData``
    format (``{feature: {'steps': [...]}}``) rather than a plain
    ``{feature: array}`` dict."""
    return any(isinstance(v, dict) and 'steps' in v
               for v in exogenous_data.values())


def _structured_exo_not_ported():
    return NotImplementedError(
        'structured ExoData exo ({feature: {"steps": [...]}}) comes with '
        'the data-plane slice of the port (ROADMAP queue 1 item 5); pass '
        'a plain {feature: array} dict of layer rasters')


class AbstractInterface:
    """Inference contract: every model exposes ``generate``, ``load``,
    ``meta``, enhancement factors and feature lists."""

    meta: dict

    @classmethod
    def load(cls, model_dir, device='cuda', verbose=True):
        """Load a model from a save directory."""
        raise NotImplementedError

    def generate(self, low_res, norm_in=True, un_norm_out=True,
                 exogenous_data=None):
        """Generate high-res output from low-res input."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    @property
    def s_enhance(self):
        """Spatial enhancement factor (from meta, else layer mults)."""
        s = self.meta.get('s_enhance')
        if s is None and hasattr(self, '_gen'):
            s = self._gen.s_enhance
        return s

    @property
    def t_enhance(self):
        """Temporal enhancement factor (from meta, else layer mults)."""
        t = self.meta.get('t_enhance')
        if t is None and hasattr(self, '_gen'):
            t = self._gen.t_enhance
        return t

    @property
    def s_enhancements(self):
        """Per-step spatial enhancements (single-step: [s_enhance])."""
        return [self.s_enhance]

    @property
    def t_enhancements(self):
        """Per-step temporal enhancements (single-step: [t_enhance])."""
        return [self.t_enhance]

    @property
    def input_dims(self):
        """4 if the model takes spatial-only input, 5 for spatiotemporal."""
        if hasattr(self, '_gen'):
            return self._gen.input_dims
        if self.meta.get('input_resolution') is None:
            return 5
        return 4 if self.is_4d else 5

    @property
    def is_5d(self):
        """Whether the model expects 5D input."""
        return self.input_dims == 5

    @property
    def is_4d(self):
        """Whether the model expects 4D (spatial only) input."""
        return hasattr(self, '_gen') and not self._gen.is_5d

    @property
    def lr_features(self):
        """Low-res input feature names (training order)."""
        return self.meta.get('lr_features', [])

    @property
    def hr_out_features(self):
        """High-res output feature names."""
        return self.meta.get('hr_out_features', [])

    @property
    def obs_features(self):
        """Observation-fusion feature names. The observation layers come
        with the model-family slice, so a port network has none."""
        return []

    @property
    def hr_exo_features(self):
        """High-res exogenous features, ordered like the network's exo
        layers."""
        features = []
        if hasattr(self, '_gen'):
            features = list(self._gen.exo_features)
        obs = [strip_obs_suffix(f) for f in self.obs_features]
        features += [f for f in obs if f not in self.hr_out_features]
        return features

    @property
    def hr_features(self):
        """All high-res channel names in training batches (out + exo)."""
        return list(self.hr_out_features) + list(self.hr_exo_features)

    @property
    def smoothing(self):
        """Gaussian smoothing sigma used on coarsened training input."""
        return self.meta.get('smoothing')

    @property
    def smoothed_features(self):
        """Features that were smoothed in training input."""
        return self.meta.get('smoothed_features', [])

    @property
    def model_params(self):
        """Serializable params for save directory."""
        return {'meta': self.meta}

    @property
    def version_record(self):
        """Versions this model was built with."""
        return VERSION_RECORD

    def set_model_params(self, **kwargs):
        """Merge training-session params into meta, checking the
        enhancement factors and exo features against the network."""
        keys = ('input_resolution', 'lr_features', 'hr_exo_features',
                'hr_out_features', 'smoothed_features', 'smoothing',
                's_enhance', 't_enhance')
        for key in keys:
            if key in kwargs and kwargs[key] is not None:
                self.meta[key] = kwargs[key]
        self.meta['class'] = type(self).__name__
        if hasattr(self, '_gen'):
            s_layers = self._gen.s_enhance
            t_layers = self._gen.t_enhance
            s = self.meta.get('s_enhance')
            t = self.meta.get('t_enhance')
            if s is not None and s_layers not in (1, s):
                raise RuntimeError(
                    f'Model layers suggest s_enhance={s_layers} but '
                    f'params say {s}')
            if t is not None and t_layers not in (1, t):
                raise RuntimeError(
                    f'Model layers suggest t_enhance={t_layers} but '
                    f'params say {t}')
        exo_feats = kwargs.get('hr_exo_features')
        if exo_feats and hasattr(self, '_gen'):
            net_feats = self.hr_exo_features
            if list(exo_feats) != list(net_feats):
                raise RuntimeError(
                    f'Batch handler exo features {exo_feats} do not match '
                    f'network exo layers {net_feats}')

    def save_params(self, out_dir):
        """Write model_params.json to the save directory (the JAX
        package's format)."""
        os.makedirs(out_dir, exist_ok=True)
        fp = os.path.join(out_dir, 'model_params.json')
        # the CURRENT class always wins at save time so multi-step
        # loaders dispatch correctly
        meta = getattr(self, 'meta', None)
        if isinstance(meta, dict):
            meta['class'] = type(self).__name__
        params = self.model_params
        params['version_record'] = self.version_record
        with open(fp, 'w') as f:
            f.write(safe_serialize(params, indent=2, sort_keys=True))


class AbstractSingleModel(AbstractInterface):
    """Shared single-model machinery: norm stats, loss resolution, exo
    plumbing, save-directory I/O, loss records and history."""

    #: fuse pad/conv/crop blocks in the train step too: the same rewrite
    #: as ``inference_fuse``, in the generator's forward and backward
    #: (the halo ring is wasted work both ways). The fused blocks hold
    #: the generator's conv layers, so gradients land on its params.
    train_fuse = True

    #: the JAX package's shard-aligned s1 formulation for spatially
    #: sharded training; comes with the multi-device slice
    train_shard_aligned = None

    #: mixed-precision training ('bfloat16'); not ported yet
    train_dtype = None

    #: gradient rematerialization of the generator; not ported yet
    train_remat = False

    def __init__(self):
        self.meta = {}
        self._means = None
        self._stdevs = None
        self._history = None
        self.loss_name = 'MeanSquaredError'
        self.loss_fun = get_loss_fun(self.loss_name)

    # ------------------------------------------------------------------
    # normalization
    def set_norm_stats(self, new_means, new_stdevs):
        """Set per-feature means/stds used to normalize IO."""
        if new_means is not None:
            self._means = {k: float(v) for k, v in new_means.items()}
        if new_stdevs is not None:
            self._stdevs = {k: float(v) for k, v in new_stdevs.items()}

    def _stats_for(self, features):
        means = np.array([self._means[f] for f in features],
                         dtype=np.float32)
        stds = np.array([self._stdevs[f] for f in features],
                        dtype=np.float32)
        stds = np.where(stds == 0, 1, stds)
        return means, stds

    def norm_input(self, low_res):
        """Normalize physical-units low-res input (numpy array or
        tensor; a tensor stays on its device)."""
        if self._means is None:
            return low_res
        missing = [f for f in self.lr_features if f not in self._means]
        if missing:
            raise KeyError(
                f'Low-res features {missing} missing from norm stats')
        means, stds = self._stats_for(self.lr_features)
        if isinstance(low_res, torch.Tensor):
            return ((low_res - torch.as_tensor(means, device=low_res.device))
                    / torch.as_tensor(stds, device=low_res.device))
        return (np.asarray(low_res) - means) / stds

    def _out_stats(self):
        """(means, stds) float32 arrays of the output features."""
        missing = [f for f in self.hr_out_features if f not in self._means]
        if missing:
            raise KeyError(
                f'Output features {missing} missing from norm stats')
        return self._stats_for(self.hr_out_features)

    def un_norm_tensors(self, device):
        """(stds, means) of the output features as tensors on
        ``device`` (None without norm stats). ``generate`` makes them
        before it launches the network: their host-to-device copy would
        otherwise wait for the network to finish."""
        if self._means is None:
            return None
        means, stds = self._out_stats()
        return (torch.as_tensor(stds, device=device),
                torch.as_tensor(means, device=device))

    def un_norm_output(self, output):
        """Denormalize generated output back to physical units (numpy
        array or tensor; a tensor stays on its device)."""
        if self._means is None:
            return output
        if isinstance(output, torch.Tensor):
            stds, means = self.un_norm_tensors(output.device)
            return output * stds + means
        means, stds = self._out_stats()
        return np.asarray(output) * stds + means

    # ------------------------------------------------------------------
    # loss
    def set_loss_function(self, loss):
        """Resolve and set the content loss function."""
        self.loss_name = loss
        self.loss_fun = get_loss_fun(loss)

    @property
    def history(self):
        """Training history ``Record`` (one row per epoch)."""
        return self._history

    @property
    def model_params(self):
        params = super().model_params
        params.update({
            'means': self._means,
            'stdevs': self._stdevs,
            'loss': self.loss_name
            if isinstance(self.loss_name, (str, list, dict))
            else str(self.loss_name),
        })
        return params

    # ------------------------------------------------------------------
    # exo routing (training batches carry exo channels last)
    def get_hr_exo_input(self, hi_res):
        """The exo channels (the last channels of a training HR batch) as
        the ``{feature: (..., 1)}`` dict the network takes."""
        if not self.hr_exo_features:
            return {}
        hr_features = self.hr_features
        return {f: hi_res[..., hr_features.index(f):
                          hr_features.index(f) + 1]
                for f in self.hr_exo_features}

    def _combine_loss_input(self, hi_res_true, hi_res_gen):
        """Append the true exo channels onto generated output so the
        discriminator sees the full channel set."""
        if hi_res_true.shape[-1] > hi_res_gen.shape[-1]:
            exo = self.get_hr_exo_input(hi_res_true)
            hi_res_gen = torch.cat(
                [hi_res_gen, *[exo[f] for f in self.hr_exo_features]],
                dim=-1)
        return hi_res_gen

    # ------------------------------------------------------------------
    # forward-pass exo combine
    def _combine_fwp_input(self, low_res, exogenous_data=None):
        """Concat input-resolution exo channels onto low_res. A plain
        ``{feature: array}`` dict is layer exo only, so low_res passes
        through; the structured format is not ported yet."""
        if exogenous_data is None:
            return low_res
        if _is_structured_exo(exogenous_data):
            raise _structured_exo_not_ported()
        return low_res

    def _combine_fwp_output(self, hi_res, exogenous_data=None):
        """Concat output-resolution exo channels onto hi_res (plain
        dicts carry none; the structured format is not ported yet)."""
        if exogenous_data is None:
            return hi_res
        if _is_structured_exo(exogenous_data):
            raise _structured_exo_not_ported()
        return hi_res

    # ------------------------------------------------------------------
    # save directory
    @classmethod
    def load_saved_params(cls, out_dir, verbose=True):
        """Read model_params.json from a save directory."""
        fp = os.path.join(out_dir, 'model_params.json')
        with open(fp) as f:
            params = json.load(f)
        if verbose:
            logger.info('Loading model from %s', out_dir)
        return params

    def save_history(self, out_dir):
        """Write history.csv if there is any history."""
        if isinstance(self._history, Record):
            self._history.to_csv(os.path.join(out_dir, 'history.csv'))

    @staticmethod
    def update_loss_details(record, new_details, prefix='',
                            max_batches=None):
        """Append a row of loss details; keep the last ``max_batches``
        rows (a ROLLING record carried across epochs: per-epoch resets
        would cold-start the disc gating every epoch)."""
        if record is None:
            record = Record()
        record.append({f'{prefix}{k}': float(v)
                       for k, v in new_details.items()})
        if max_batches is not None and len(record) > max_batches:
            record.tail(max_batches)
        return record

    @staticmethod
    def early_stop(history, column, threshold=0.005, n_epoch=5):
        """True when ``column`` improved less than ``threshold``
        (relative) for ``n_epoch`` consecutive epochs."""
        if history is None or column not in history or len(
                history[column]) < n_epoch + 1:
            return False
        vals = np.asarray(history[column])[-(n_epoch + 1):]
        diffs = np.abs(np.diff(vals)) / np.abs(vals[:-1])
        stop = bool(np.all(diffs < threshold))
        if stop:
            logger.info(
                'Early stop: %s changed by less than %.4f for %d epochs',
                column, threshold, n_epoch)
        return stop

    @staticmethod
    def load_network(config, name):
        """Build a Network from a config list/dict/file path."""
        if isinstance(config, dict) and 'hidden_layers' in config:
            config = config['hidden_layers']
        net = Network(config)
        logger.debug('Built %s network with %d layers', name, len(net))
        return net
