"""Model base classes (the port of ``sup3r_tpu/models/abstract.py``):
the inference contract, meta and feature properties, the single
generator's params, fused train network, batch placement and exo
parsing, normalization stats, the forward-pass exo combine (input- and
output-resolution channels of structured ``ExoData``), the save
directory's ``model_params.json`` and the checkpoints in the JAX
package's layout, and the training surface: the content loss,
training-session params, the rolling loss record, the epoch loop with
its per-epoch history (a pandas-free ``Record``, written as
``history.csv``), tensorboard logging and profiling, early stopping and
checkpoint cadence, and the train step's options (``train_dtype``,
``train_remat``).
"""

import functools
import inspect
import json
import logging
import os
import platform
import sys
import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

import sup3r_tpu_torch
from sup3r_tpu_torch.models.fuse import FusedReflectConv, fuse_network
from sup3r_tpu_torch.models.network import Network
from sup3r_tpu_torch.models.record import Record
from sup3r_tpu_torch.models.utilities import (
    make_tb_writer,
    profile_to_dir,
    tb_log_dict,
)
from sup3r_tpu_torch.models.weights import (
    load_jax_checkpoint,
    opt_state_from_jax,
    opt_state_to_jax,
    packb,
    params_from_jax,
    params_to_jax,
    save_jax_checkpoint,
    unpackb,
)
from sup3r_tpu_torch.names import strip_obs_suffix
from sup3r_tpu_torch.ops.conv_ad import shard_aligned_worthwhile
from sup3r_tpu_torch.ops.losses import get_loss_fun
from sup3r_tpu_torch.parallel.mesh import (
    SpatialShard,
    all_gather_rows,
    all_reduce_,
)
from sup3r_tpu_torch.utilities import safe_serialize

logger = logging.getLogger(__name__)

VERSION_RECORD = {
    'sup3r_tpu_torch': sup3r_tpu_torch.__version__,
    'torch': torch.__version__,
    'numpy': np.__version__,
    'python': sys.version,
    'platform': platform.platform(),
}


def compute_dtype(name):
    """The torch dtype a ``train_dtype`` / ``inference_dtype`` names
    ('bfloat16', 'float16', ...), or None for None (float32 compute)."""
    if name is None:
        return None
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f'not a floating-point dtype name: {name!r}')
    return dtype


def _as_exo_data(exogenous_data):
    """``exogenous_data`` as ``ExoData`` when it is in the structured
    format (``{feature: {'steps': [...]}}``), else None (a plain
    ``{feature: array}`` dict carries layer rasters only)."""
    from sup3r_tpu_torch.preprocessing.exo import ExoData

    if exogenous_data is None or isinstance(exogenous_data, ExoData):
        return exogenous_data
    if not all(isinstance(v, dict) and 'steps' in v
               for v in exogenous_data.values()):
        return None
    return ExoData(exogenous_data)


@functools.lru_cache(maxsize=None)
def supports_fetch(model_cls):
    """Whether a model class's ``generate`` takes ``fetch=`` (the
    single-model API that can hand back its output tensor on the
    device)."""
    return 'fetch' in inspect.signature(model_cls.generate).parameters


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
        """Observation-fusion feature names (from the generator's
        observation layers)."""
        if hasattr(self, '_gen'):
            return self._gen.obs_features
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

    #: the JAX package's shard-aligned s1 formulation of the fused
    #: blocks in the train step: None (default) turns it on when a mesh
    #: with a ``space`` axis 4 or more ranks wide is attached (the JAX
    #: package's gate, ``ops.conv_ad.shard_aligned_worthwhile``); True /
    #: False force it on / off. On a ``space`` axis it picks the route
    #: of the blocks the ``small_reflect_conv`` kernel takes, as in the
    #: JAX package, whose shard-aligned blocks bypass Pallas: on, they
    #: exchange halo rows like every other block; off, they gather
    #: their input over the axis and run the kernel on the whole tensor
    #: (``parallel.mesh.SpatialShard.gather_small``). The port's other
    #: blocks exchange the same one-row halos either way. Without a
    #: spatial axis the fused blocks that the kernels do not take run
    #: ``reflect_conv_shard_aligned``. Either way the step is the plain
    #: step's up to fp32 reassociation.
    train_shard_aligned = None

    #: the mesh of data-parallel training (``Sup3rGan.attach_mesh``), its
    #: batch axis and its ``space`` axis (None: data parallel only)
    _mesh = None
    _mesh_axis = None
    _mesh_spatial_axis = None

    #: mixed-precision training: 'bfloat16' runs both networks' forward
    #: and backward in bf16, while master weights, the gradients (cast
    #: back at the network boundary), optimizer state and losses stay
    #: float32. None (default) computes in float32.
    train_dtype = None

    #: gradient rematerialization: the generator's forward runs under
    #: ``torch.utils.checkpoint`` and is recomputed in the backward,
    #: trading a second forward for its saved activations
    train_remat = False

    def __init__(self):
        self.meta = {}
        self._means = None
        self._stdevs = None
        self._history = None
        self.loss_name = 'MeanSquaredError'
        self.loss_fun = get_loss_fun(self.loss_name)
        self._train_net = None

    # ------------------------------------------------------------------
    # the generator (``self._gen``; ``self.device``, ``self._gen_in_shape``)
    @property
    def generator(self):
        """Generator Network module."""
        return self._gen

    @property
    def gen_params(self):
        """The generator's parameter tensors, in layer order (None
        before the weights exist)."""
        if self._gen_in_shape is None:
            return None
        return tuple(self._gen.parameters())

    def _auto_shard_aligned(self):
        """``train_shard_aligned`` resolved: its value when set, else on
        when the attached mesh's ``space`` axis is 4 or more ranks
        wide."""
        if self.train_shard_aligned is not None:
            return bool(self.train_shard_aligned)
        axis = self._mesh_spatial_axis
        if axis is None or self._mesh is None:
            return False
        return shard_aligned_worthwhile(self._mesh.shape[axis])

    def _train_gen_net(self):
        """The generator network the train step runs: fused (see
        ``train_fuse``), its blocks reading the generator's own params,
        in the formulation ``train_shard_aligned`` resolves to."""
        if not self.train_fuse:
            return self._gen
        if self._train_net is None:
            self._train_net = Network(fuse_network(list(self._gen.layers)))
        aligned = self._auto_shard_aligned()
        for lyr in self._train_net.layers:
            if isinstance(lyr, FusedReflectConv):
                lyr.shard_aligned = aligned
        return self._train_net

    def _spatial_shard(self):
        """The ``SpatialShard`` the train step's networks run on (this
        rank's block of s1 rows on the attached mesh's ``space`` axis), or
        None without one."""
        if self._mesh_spatial_axis is None:
            return None
        return SpatialShard(self._mesh, self._mesh_spatial_axis,
                            gather_small=not self._auto_shard_aligned())

    def _split_exo(self, hr):
        """The exo channels of a training HR batch, by feature."""
        n_exo = len(self.hr_exo_features)
        n_out = hr.shape[-1] - n_exo
        return {f: hr[..., n_out + i:n_out + i + 1]
                for i, f in enumerate(self.hr_exo_features)}

    def _place_batch(self, arr):
        """A float32 tensor on the model's device (no copy for one that
        is there already). With a mesh attached, ``arr`` is this rank's
        own rows of the global batch (the JAX package's multi-host
        convention: a rank is a host with one device), and with a
        ``space`` axis its block of each sample's s1 rows too, as
        ``parallel.shard_batch_spatial`` cuts it."""
        return torch.as_tensor(arr, dtype=torch.float32, device=self.device)

    def _gather(self, tensor):
        """``tensor``'s rows of every rank of the attached mesh's batch
        axis, in rank order (differentiable;
        ``parallel.mesh.all_gather_rows``): the losses of a data-parallel
        step are the global batch's, the same on every rank. The tensor
        itself without a mesh (or for None)."""
        if self._mesh is None or tensor is None:
            return tensor
        return all_gather_rows(self._mesh, tensor, self._mesh_axis)

    def _gather_space(self, tensor):
        """A channels-last (n, s1, ...) tensor's s1 blocks gathered over
        the ``space`` axis (dim 1; differentiable), the tensor itself
        without one (or for None)."""
        if self._mesh_spatial_axis is None or tensor is None:
            return tensor
        return all_gather_rows(self._mesh, tensor, self._mesh_spatial_axis,
                               dim=1)

    def _gather_hr(self, tensor):
        """A channels-last (n, s1, ...) tensor of the global batch: its
        s1 blocks gathered over the ``space`` axis, then its rows over
        the batch axis. ``_gather`` without a ``space`` axis."""
        return self._gather(self._gather_space(tensor))

    def _reduce_grads(self, grads, network=None):
        """Sum a step's gradients (of ``network``'s params, in order) over
        the ranks of the attached mesh, in place, and return them. Each
        rank's backward gives its own share of the global loss's
        gradient: over the batch axis, and with a ``space`` axis over
        both axes, except for the params ``network`` computes whole on
        every rank of a ``space`` group
        (``Network.space_replicated_params``), whose gradients are the
        same there and are summed over the batch axis only."""
        if self._mesh is None:
            return grads
        if self._mesh_spatial_axis is None:
            all_reduce_(self._mesh, grads, self._mesh_axis)
            return grads
        whole = {id(p) for p in network.space_replicated_params()}
        shares = [[g for p, g in zip(network.parameters(), grads)
                   if (id(p) in whole) == w] for w in (False, True)]
        all_reduce_(self._mesh, shares[0])
        all_reduce_(self._mesh, shares[1], self._mesh_axis)
        return grads

    @property
    def _is_writer(self):
        """Whether this rank writes the run's files (history, checkpoints,
        tensorboard): the mesh's first rank, or the one process."""
        return self._mesh is None or self._mesh.rank == int(
            self._mesh.devices.flat[0])

    @staticmethod
    def _fetch_details(details):
        """Loss scalars to the host in ONE copy (a stacked tensor), not
        one per scalar."""
        keys = list(details)
        vals = torch.stack([details[k].detach() for k in keys]).cpu()
        return {k: float(v) for k, v in zip(keys, vals.tolist())}

    def _parse_exo_for_generate(self, exogenous_data):
        """{feature: float32 tensor on the device} of the mid-network
        ('layer') rasters, from a plain ``{feature: array}`` dict or the
        structured ``ExoData`` format ({feature: {'steps': [...]}})."""
        if not exogenous_data:
            return {}
        out = {}
        for feat, val in exogenous_data.items():
            if isinstance(val, dict) and 'steps' in val:
                for step in val['steps']:
                    if step.get('combine_type') == 'layer':
                        out[feat] = step['data']
            else:
                out[feat] = val
        return {k: torch.as_tensor(v, dtype=torch.float32,
                                   device=self.device)
                for k, v in out.items()}


    # ------------------------------------------------------------------
    # train-step options
    def _maybe_remat(self, gen_apply):
        """``gen_apply(x, exo)`` under non-reentrant
        ``torch.utils.checkpoint`` when ``train_remat`` is set (and
        gradients are on): the backward recomputes the forward, kernels
        included, instead of keeping its activations. Train, dropout or
        spatial kwargs raise: a rematerialized apply would drop them."""
        if not self.train_remat:
            return gen_apply

        def apply(x, exo=None, **kwargs):
            if any(kwargs.values()):
                raise NotImplementedError(
                    f'train_remat does not support {sorted(kwargs)} '
                    'kwargs on the generator apply')
            if not torch.is_grad_enabled():
                return gen_apply(x, exo or {})
            return checkpoint(gen_apply, x, exo or {}, use_reentrant=False)

        return apply

    def _train_cast(self):
        """``cast(tensor)``: a network input in the ``train_dtype``
        (identity without one). The layers cast their params to their
        input's dtype; callers cast each network's OUTPUT back to float32,
        so losses, the gradients at the boundary and the optimizer's math
        stay float32."""
        dtype = compute_dtype(self.train_dtype)
        if dtype is None:
            return lambda t: t
        return lambda t: t.to(dtype)

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
        """Concat input-resolution exo channels onto low_res when the
        model expects more lr features than given (reference:
        sup3r/models/interface.py:259). A tensor takes them on its
        device; a numpy array on the host."""
        exogenous_data = _as_exo_data(exogenous_data)
        fnum_diff = len(self.lr_features) - low_res.shape[-1]
        if exogenous_data is None or fnum_diff <= 0:
            return low_res
        exo_feats = self.lr_features[-fnum_diff:]
        missing = [f for f in exo_feats if f not in exogenous_data]
        assert not missing, (
            f'exogenous_data is missing input features {missing}')
        exo = [exogenous_data.get_combine_type_data(f, 'input')
               for f in exo_feats]
        if isinstance(low_res, torch.Tensor):
            return torch.cat([low_res] + [torch.as_tensor(
                np.asarray(e), dtype=low_res.dtype, device=low_res.device)
                for e in exo], dim=-1)
        return np.concatenate([low_res] + [np.asarray(e) for e in exo],
                              axis=-1)

    def _combine_fwp_output(self, hi_res, exogenous_data=None):
        """Concat output-resolution exo channels onto the fetched hi_res
        (reference: sup3r/models/interface.py:310)."""
        exogenous_data = _as_exo_data(exogenous_data)
        fnum_diff = len(self.hr_out_features) - hi_res.shape[-1]
        if exogenous_data is None or fnum_diff <= 0:
            return hi_res
        exo_feats = self.hr_out_features[-fnum_diff:]
        missing = [f for f in exo_feats if f not in exogenous_data]
        assert not missing, (
            f'exogenous_data is missing output features {missing}')
        for feature in exo_feats:
            exo_output = exogenous_data.get_combine_type_data(feature,
                                                              'output')
            hi_res = np.concatenate([hi_res, np.asarray(exo_output)],
                                    axis=-1)
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

    def _saved_networks(self):
        """The networks a checkpoint holds, by the key of their weights
        file ``model_<key>.msgpack``."""
        return {'gen': self._gen}

    def _opt_state_tree(self):
        """The optimizer state as the JAX package saves it."""
        return opt_state_to_jax(self._gen_tx, self._gen_opt_state,
                                self._gen)

    def _set_opt_state_tree(self, tree):
        """Restore the optimizer state from the JAX package's tree."""
        self._gen_opt_state = opt_state_from_jax(self._gen_tx, tree,
                                                 self._gen)

    def _init_saved_shapes(self, params):
        """Initialize the weights for the input shapes a save records."""
        self.init_weights(tuple(params['gen_in_shape']))

    def save(self, out_dir):
        """Save to a directory in the JAX package's layout:
        ``model_params.json``, each network's ``model_<key>.msgpack``
        weights and ``opt_state.msgpack`` in flax's format, and
        ``history.csv``, so either package's ``load`` reads it and
        resumes."""
        os.makedirs(out_dir, exist_ok=True)
        if self.gen_params is not None:
            for key, network in self._saved_networks().items():
                save_jax_checkpoint(params_to_jax(network), os.path.join(
                    out_dir, f'model_{key}.msgpack'))
            with open(os.path.join(out_dir, 'opt_state.msgpack'),
                      'wb') as f:
                f.write(packb(self._opt_state_tree()))
        self.save_params(out_dir)
        self.save_history(out_dir)
        logger.info('Saved %s to %s', type(self).__name__, out_dir)

    def _load_saved(self, model_dir, params):
        """Read a save directory's weights (at the input shapes its
        ``params`` record), optimizer state and history into this model,
        as the JAX package's ``save`` or this one wrote them; returns the
        model."""
        if params.get('gen_in_shape') is not None:
            self._init_saved_shapes(params)
            for key, network in self._saved_networks().items():
                params_from_jax(network, load_jax_checkpoint(os.path.join(
                    model_dir, f'model_{key}.msgpack')))
            fp_opt = os.path.join(model_dir, 'opt_state.msgpack')
            if os.path.exists(fp_opt):
                with open(fp_opt, 'rb') as f:
                    self._set_opt_state_tree(unpackb(f.read()))
        fp_history = os.path.join(model_dir, 'history.csv')
        if os.path.exists(fp_history):
            self._history = Record.read_csv(fp_history)
        return self

    # ------------------------------------------------------------------
    # the training loop
    @staticmethod
    def check_batch_handler_attrs(batch_handler):
        """Pull optional metadata attrs off a batch handler."""
        return {
            k: getattr(batch_handler, k, None)
            for k in ['smoothing', 'lr_features', 'hr_exo_features',
                      'hr_out_features', 'smoothed_features']
            if hasattr(batch_handler, k)
        }

    def _prepare_training(self, batch_handler, input_resolution):
        """Take the norm stats and the training-session params from a
        batch handler, and have it stage its batches on this model's
        device (its ``device``, set here when it has none)."""
        self.set_norm_stats(batch_handler.means, batch_handler.stds)
        self.set_model_params(
            input_resolution=input_resolution,
            s_enhance=batch_handler.s_enhance,
            t_enhance=batch_handler.t_enhance,
            **self.check_batch_handler_attrs(batch_handler))
        if getattr(batch_handler, 'device', None) is None:
            batch_handler.device = self.device

    def _train_epochs(self, batch_handler, n_epoch, run_epoch, out_dir,
                      checkpoint_int=None, early_stop_on=None,
                      early_stop_threshold=0.005, early_stop_n_epoch=5,
                      tensorboard_log=False, tensorboard_profile=False):
        """The epoch loop of ``train``. ``run_epoch(epoch, profile)``
        trains one epoch, its training steps inside the context
        ``profile``, validates, and returns the epoch's history row. The
        loop puts the elapsed seconds first in the row, writes the row
        as tensorboard scalars to ``<out_dir>/../logs``
        (``tensorboard_log``; a warning and no logs without the
        ``tensorboard`` package), appends it to the history (epochs
        numbered on from a loaded history), stops early, saves to
        ``out_dir.format(epoch=...)`` at the cadence and at the end, and
        stops the batch handler at the end or on an error.
        ``tensorboard_profile`` records the first epoch's training with
        ``torch.profiler`` into ``<dirname(out_dir)>/profile``. With a
        mesh attached only its first rank writes files; every rank keeps
        the history and stops early on the same (global) losses."""
        epochs = list(range(n_epoch))
        if self._history is None:
            self._history = Record()
        else:
            epochs = [e + len(self._history) for e in epochs]
        writer = self._is_writer
        tb_writer = (make_tb_writer(out_dir) if tensorboard_log and writer
                     else None)
        log_dir = os.path.join(os.path.dirname(out_dir or './'), 'profile')
        t0 = time.time()
        try:
            for epoch in epochs:
                profile = profile_to_dir(
                    log_dir, enabled=tensorboard_profile and writer
                    and epoch == epochs[0])
                row = run_epoch(epoch, profile)
                row = {'elapsed_time': time.time() - t0, **row}
                tb_log_dict(tb_writer, row, epoch)
                self._history.append(row, index=epoch)
                stop = early_stop_on is not None and (
                    early_stop_on in self._history) and self.early_stop(
                        self._history, early_stop_on,
                        threshold=early_stop_threshold,
                        n_epoch=early_stop_n_epoch)
                if writer and out_dir is not None and (
                        stop or epoch == epochs[-1]
                        or (checkpoint_int is not None
                            and epoch % checkpoint_int == 0)):
                    self.save(out_dir.format(epoch=epoch))
                if stop:
                    break
        finally:
            if tb_writer is not None:
                tb_writer.close()
            if hasattr(batch_handler, 'stop'):
                batch_handler.stop()

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
