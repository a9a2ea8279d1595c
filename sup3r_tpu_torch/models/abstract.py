"""Model base classes: the inference contract and the shared
single-model machinery the serving path needs (the port of the
inference half of ``sup3r_tpu/models/abstract.py``): meta and feature
properties, normalization stats, the forward-pass exo combine for
plain-array exo, and the save directory's ``model_params.json``.

Training (losses, history, fused train steps) comes with the training
slice; structured ``ExoData`` exo comes with the data-plane slice.
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
from sup3r_tpu_torch.names import strip_obs_suffix
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
    """Shared single-model machinery: norm stats, exo plumbing,
    save-directory I/O."""

    def __init__(self):
        self.meta = {}
        self._means = None
        self._stdevs = None
        self.loss_name = 'MeanSquaredError'

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

    @staticmethod
    def load_network(config, name):
        """Build a Network from a config list/dict/file path."""
        if isinstance(config, dict) and 'hidden_layers' in config:
            config = config['hidden_layers']
        net = Network(config)
        logger.debug('Built %s network with %d layers', name, len(net))
        return net
