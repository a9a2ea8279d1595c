"""Samplers: uniform / weighted spatiotemporal crops from GridDatasets
(the port of ``Sampler`` and the box / time samplers of
``sup3r_tpu/preprocessing/samplers.py``).

Every draw comes from the port's locked ``RANDOM_GENERATOR`` in the JAX
package's order, so the same seed gives the same samples. ``DualSampler``
crops aligned LR / HR pairs from a ``PairedDataset``; ``DualSamplerCC``
samples whole days from a (daily, hourly) one. ``SamplerDC`` draws its
crops from loss-adaptive spatial and temporal bin weights.
"""

import logging

import numpy as np

from sup3r_tpu_torch.names import parse_feature
from sup3r_tpu_torch.ops.coarsen import spatial_coarsening
from sup3r_tpu_torch.preprocessing.grid import GridDataset, PairedDataset
from sup3r_tpu_torch.utilities import RANDOM_GENERATOR, nn_fill_array

logger = logging.getLogger(__name__)


def uniform_box_sampler(data_shape, sample_shape):
    """Random (s1_slice, s2_slice) crop of ``sample_shape`` within
    ``data_shape``."""
    s1 = min(sample_shape[0], data_shape[0])
    s2 = min(sample_shape[1], data_shape[1])
    start1 = RANDOM_GENERATOR.integers(0, data_shape[0] - s1 + 1)
    start2 = RANDOM_GENERATOR.integers(0, data_shape[1] - s2 + 1)
    return [slice(start1, start1 + s1), slice(start2, start2 + s2)]


def uniform_time_sampler(data_shape, sample_shape, crop_slice=slice(None)):
    """Random time slice of length ``sample_shape``."""
    t_indices = range(data_shape[2])[crop_slice]
    shape = min(sample_shape, len(t_indices))
    start = RANDOM_GENERATOR.integers(
        t_indices[0], t_indices[-1] - shape + 2)
    return slice(start, start + shape)


def _safe_probs(weights):
    """Normalize bin weights into a valid probability vector in float64
    (NaN / zero weights fall back to uniform)."""
    w = np.asarray(weights, dtype=np.float64)
    w = np.where(np.isfinite(w) & (w > 0), w, 0.0)
    s = w.sum()
    if s <= 0:
        return np.full(len(w), 1.0 / len(w))
    return w / s


def _per_index_probs(n_indices, weights):
    """Per-start-index probabilities from per-bin weights with
    ``np.array_split`` binning; fewer candidate starts than bins fails
    loudly."""
    if n_indices < len(weights):
        raise ValueError(
            f'Need at least as many candidate start indices '
            f'({n_indices}) as sampling bins ({len(weights)}); '
            'reduce the bin count or the sample_shape')
    chunks = np.array_split(np.arange(n_indices), len(weights))
    per_idx = np.concatenate([
        np.full(len(c), w, dtype=np.float64)
        for c, w in zip(chunks, weights)])
    return _safe_probs(per_idx)


def weighted_box_sampler(data_shape, sample_shape, weights):
    """Spatial crop whose start is drawn with per-index probabilities
    from ``len(weights)`` bins of the flattened start index."""
    max_cols = max(data_shape[1] - sample_shape[1] + 1, 1)
    max_rows = max(data_shape[0] - sample_shape[0] + 1, 1)
    n = max_rows * max_cols
    flat = RANDOM_GENERATOR.choice(n, p=_per_index_probs(n, weights))
    row, col = flat // max_cols, flat % max_cols
    return [slice(row, row + sample_shape[0]),
            slice(col, col + sample_shape[1])]


def weighted_time_sampler(data_shape, sample_shape, weights):
    """Time slice whose start is drawn from the temporal bin chosen by
    ``weights``."""
    shape = min(sample_shape, data_shape[2])
    n = data_shape[2] if shape == 1 else data_shape[2] - shape + 1
    start = RANDOM_GENERATOR.choice(n, p=_per_index_probs(n, weights))
    return slice(start, start + shape)


class Sampler:
    """Uniform spatiotemporal crop sampler over a GridDataset.

    feature_sets splits the feature list into what goes to the low-res
    input vs the high-res target:
      * ``lr_only_features``: in LR input only (e.g. coarse-only vars)
      * ``hr_exo_features``: exogenous HR channels (must be the last
        features, order matching the network's exo layers)
    """

    def __init__(self, data, sample_shape=None, batch_size=16,
                 feature_sets=None):
        self.data = data
        self.sample_shape = tuple(sample_shape or (10, 10, 1))
        if len(self.sample_shape) == 2:
            self.sample_shape = (*self.sample_shape, 1)
        self.batch_size = batch_size
        feature_sets = feature_sets or {}
        self.features = [
            f.lower() for f in feature_sets.get('features', data.features)]
        self._lr_only_features = [
            f.lower() for f in feature_sets.get('lr_only_features', [])]
        self._hr_exo_features = [
            f.lower() for f in feature_sets.get('hr_exo_features', [])]
        self._check_features()

    def _match(self, patterns):
        """Expand any wildcard patterns against the feature list."""
        out = []
        for p in patterns:
            if '*' in p:
                base = p.replace('*', '')
                out.extend(f for f in self.features
                           if parse_feature(f)[0] == parse_feature(
                               base)[0] or base in f)
            else:
                out.append(p)
        return out

    def _check_features(self):
        exo = self._match(self._hr_exo_features)
        if exo:
            tail = self.features[-len(exo):]
            if tail != exo:
                raise ValueError(
                    f'hr_exo_features {exo} must be the LAST features; '
                    f'feature list ends with {tail}')

    @property
    def lr_features(self):
        """Features for the low-res input (all features)."""
        return self.features

    @property
    def hr_exo_features(self):
        """Exogenous high-res channels (last features)."""
        return self._match(self._hr_exo_features)

    @property
    def hr_features(self):
        """Features kept in the high-res target batch."""
        return [f for f in self.features
                if f not in self._lr_only_features]

    @property
    def hr_out_features(self):
        """Features the generator must output."""
        out = [f for f in self.hr_features
               if f not in self.hr_exo_features]
        if not out:
            raise RuntimeError('No high-res output features!')
        return out

    @property
    def hr_features_ind(self):
        """Channel indices of hr_features within the full feature list."""
        return [self.features.index(f) for f in self.hr_features]

    @property
    def shape(self):
        """Underlying data shape."""
        return self.data.shape

    def get_sample_index(self):
        """One random (s1, s2, t, features) crop index."""
        box = uniform_box_sampler(self.data.shape, self.sample_shape[:2])
        t = uniform_time_sampler(self.data.shape, self.sample_shape[2])
        return (*box, t, self.features)

    def __next__(self):
        """One HR sample: (s1, s2, t, n_features)."""
        return self.data.sample(self.get_sample_index())


def nsrdb_reduce_daily_data(data, shape, csr_ind=0):
    """Reduce a 5D batch's time axis to ``shape`` steps around its
    daylight hours: NaN clearsky_ratio marks night (reference:
    samplers/utilities.py:258). All-night data comes back unreduced."""
    night_mask = np.isnan(data[:, :, :, :, csr_ind]).any(axis=(0, 1, 2))
    if shape >= data.shape[3]:
        return data
    if night_mask.all():
        return data
    day_ilocs = np.where(~night_mask)[0]
    padding = shape - len(day_ilocs)
    half_pad = int(np.ceil(padding / 2))
    start = max(day_ilocs[0] - half_pad, 0)
    start = min(start, data.shape[3] - shape)
    return data[..., start:start + shape, :]


class SamplerDC(Sampler):
    """Data-centric sampler: the crop's start is drawn from
    loss-adaptive spatial / temporal bin weights (reference:
    samplers/dc.py:23)."""

    def __init__(self, data, sample_shape=None, batch_size=16,
                 feature_sets=None, spatial_weights=None,
                 temporal_weights=None):
        super().__init__(data, sample_shape=sample_shape,
                         batch_size=batch_size, feature_sets=feature_sets)
        self.spatial_weights = spatial_weights
        self.temporal_weights = temporal_weights

    def update_weights(self, spatial_weights, temporal_weights):
        """New sampling weights (``Sup3rGanDC`` sets them each epoch)."""
        self.spatial_weights = spatial_weights
        self.temporal_weights = temporal_weights

    def get_sample_index(self):
        if self.spatial_weights is not None:
            box = weighted_box_sampler(self.data.shape, self.sample_shape[:2],
                                       self.spatial_weights)
        else:
            box = uniform_box_sampler(self.data.shape, self.sample_shape[:2])
        if self.temporal_weights is not None:
            t = weighted_time_sampler(self.data.shape, self.sample_shape[2],
                                      self.temporal_weights)
        else:
            t = uniform_time_sampler(self.data.shape, self.sample_shape[2])
        return (*box, t, self.features)


class DualSampler:
    """Paired LR / HR sampler with enhancement-consistent crops
    (reference: samplers/dual.py:17)."""

    def __init__(self, data, sample_shape=None, batch_size=16,
                 s_enhance=1, t_enhance=1, feature_sets=None):
        """``data``: a PairedDataset with ``low_res`` and ``high_res``
        members (optionally ``obs``)."""
        self.data = data
        self.lr_data = data['low_res']
        self.hr_data = data['high_res']
        self.obs_data = data.members.get('obs')
        self.s_enhance = s_enhance
        self.t_enhance = t_enhance
        self.batch_size = batch_size
        hr_shape = tuple(sample_shape or (10, 10, 1))
        if len(hr_shape) == 2:
            hr_shape = (*hr_shape, 1)
        self.hr_sample_shape = hr_shape
        if hr_shape[0] % s_enhance or hr_shape[1] % s_enhance or (
                hr_shape[2] % t_enhance):
            raise ValueError(
                f'HR sample shape {hr_shape} not divisible by s_enhance '
                f'{s_enhance} / t_enhance {t_enhance}')
        self.lr_sample_shape = (hr_shape[0] // s_enhance,
                                hr_shape[1] // s_enhance,
                                hr_shape[2] // t_enhance)
        self.sample_shape = hr_shape
        feature_sets = feature_sets or {}
        self.lr_features = [
            f.lower() for f in feature_sets.get(
                'lr_features', self.lr_data.features)]
        # lr_only_features are model inputs that never appear on the
        # high-res side
        lr_only = [f.lower()
                   for f in feature_sets.get('lr_only_features', [])]
        default_hr = [f for f in self.hr_data.features
                      if f.lower() not in lr_only]
        hr_feats = feature_sets.get('hr_features', default_hr)
        self.features = list(dict.fromkeys(
            self.lr_features + [f.lower() for f in hr_feats]))
        self._hr_exo_features = [
            f.lower() for f in feature_sets.get('hr_exo_features', [])]
        self.hr_features = [f.lower() for f in hr_feats]
        lr_shape, hr_shape_full = self.lr_data.shape, self.hr_data.shape
        if (lr_shape[0] * s_enhance != hr_shape_full[0]
                or lr_shape[2] * t_enhance != hr_shape_full[2]):
            raise ValueError(
                f'LR/HR data {lr_shape} / {hr_shape_full} inconsistent with '
                f's_enhance={s_enhance}, t_enhance={t_enhance}')

    @property
    def hr_exo_features(self):
        return self._hr_exo_features

    @property
    def hr_out_features(self):
        return [f for f in self.hr_features
                if f not in self._hr_exo_features]

    def get_sample_index(self):
        """Aligned (lr_index, hr_index) crop pair: the LR crop is drawn,
        the HR crop is its enhancement."""
        lr_box = uniform_box_sampler(self.lr_data.shape,
                                     self.lr_sample_shape[:2])
        lr_t = uniform_time_sampler(self.lr_data.shape,
                                    self.lr_sample_shape[2])
        hr_box = [slice(s.start * self.s_enhance, s.stop * self.s_enhance)
                  for s in lr_box]
        hr_t = slice(lr_t.start * self.t_enhance,
                     lr_t.stop * self.t_enhance)
        return ((*lr_box, lr_t, self.lr_features),
                (*hr_box, hr_t, self.hr_features))

    def __next__(self):
        """(lr_sample, hr_sample[, obs_sample]) tuple."""
        lr_idx, hr_idx = self.get_sample_index()
        lr = self.lr_data.sample(lr_idx)
        hr = self.hr_data.sample(hr_idx)
        if self.obs_data is not None:
            obs = self.obs_data.sample(
                (*hr_idx[:3], self.obs_data.features))
            return lr, hr, obs
        return lr, hr


class DualSamplerCC(DualSampler):
    """Climate-change sampler over a (daily, hourly) PairedDataset.

    Samples whole days: low-res samples come from the daily member and
    high-res samples from the hourly member; for solar (clearsky_ratio)
    with 1 < t_enhance < 24 the hourly sample is reduced to its daylight
    window (reference: samplers/cc.py:17-204)."""

    def __init__(self, data, sample_shape=None, batch_size=16,
                 s_enhance=1, t_enhance=24, feature_sets=None):
        """``data``: a PairedDataset with daily and hourly members;
        ``sample_shape`` is the HIGH-RES sample shape, its time length a
        multiple of t_enhance (n_days = t_len // t_enhance)."""
        if not ('daily' in data.members and 'hourly' in data.members):
            raise ValueError('DualSamplerCC needs a PairedDataset with daily '
                             'and hourly members')
        daily, hourly = data['daily'], data['hourly']
        lr = daily
        hr = hourly if t_enhance != 1 else daily
        if s_enhance > 1:
            if hasattr(lr, 'coarsen'):
                # a lazy daily view: block-mean coarsening per sampled
                # window (bit-identical: the blocks are disjoint)
                lr = lr.coarsen(s_enhance)
            else:
                lr = GridDataset(
                    spatial_coarsening(lr.data, s_enhance, obs_axis=False),
                    lr.features,
                    lat_lon=spatial_coarsening(lr.lat_lon, s_enhance,
                                               obs_axis=False),
                    time_index=lr.time_index)
        sample_shape = tuple(sample_shape or (10, 10, 24))
        if sample_shape[2] % t_enhance:
            raise ValueError(f'sample_shape[2]={sample_shape[2]} must be a '
                             f'multiple of t_enhance={t_enhance}')
        self.n_days = sample_shape[2] // t_enhance
        self.hr_sample_t = (self.n_days * 24 if t_enhance != 1
                            else self.n_days)
        self.final_t = sample_shape[2]
        super().__init__(
            PairedDataset(low_res=lr, high_res=hr),
            sample_shape=(sample_shape[0], sample_shape[1],
                          self.hr_sample_t),
            batch_size=batch_size, s_enhance=s_enhance,
            t_enhance=(24 if t_enhance != 1 else 1),
            feature_sets=feature_sets)
        # the index math samples whole days (hourly = 24x daily); the
        # t_enhance others read is the model's factor
        self._index_t_enhance = self.t_enhance
        self.t_enhance = t_enhance
        self.hr_sample_shape = sample_shape
        self.sample_shape = sample_shape

    def get_sample_index(self):
        lr_box = uniform_box_sampler(self.lr_data.shape,
                                     self.lr_sample_shape[:2])
        lr_t = uniform_time_sampler(self.lr_data.shape,
                                    self.lr_sample_shape[2])
        hr_box = [slice(s.start * self.s_enhance, s.stop * self.s_enhance)
                  for s in lr_box]
        hr_t = slice(lr_t.start * self._index_t_enhance,
                     lr_t.stop * self._index_t_enhance)
        return ((*lr_box, lr_t, self.lr_features),
                (*hr_box, hr_t, self.hr_features))

    def __next__(self):
        lr, hr = super().__next__()
        if 'clearsky_ratio' in self.hr_out_features and self.t_enhance != 1:
            i_cs = self.hr_features.index('clearsky_ratio')
            hr = nsrdb_reduce_daily_data(hr[None], self.final_t,
                                         csr_ind=i_cs)[0]
            if hr.shape[2] != self.final_t:
                # all-night samples come back unreduced: centre-crop so
                # every sample of a batch has the same length
                start = max((hr.shape[2] - self.final_t) // 2, 0)
                hr = hr[:, :, start:start + self.final_t]
            if np.isnan(hr[..., i_cs]).any():
                hr[..., i_cs] = nn_fill_array(hr[..., i_cs])
        elif hr.shape[2] != self.final_t:
            # non-solar: centre crop to the requested time length
            start = (hr.shape[2] - self.final_t) // 2
            hr = hr[:, :, start:start + self.final_t]
        return lr, hr

