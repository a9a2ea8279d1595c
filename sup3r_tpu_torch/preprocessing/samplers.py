"""Samplers: uniform / weighted spatiotemporal crops from GridDatasets
(the port of ``Sampler`` and the box / time samplers of
``sup3r_tpu/preprocessing/samplers.py``).

Every draw comes from the port's locked ``RANDOM_GENERATOR`` in the JAX
package's order, so the same seed gives the same samples. ``SamplerDC``
and the dual samplers come with the dual and data-centric handlers
(ROADMAP queue 1 item 6).
"""

import logging

import numpy as np

from sup3r_tpu_torch.names import parse_feature
from sup3r_tpu_torch.utilities import RANDOM_GENERATOR, not_ported

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


__getattr__ = not_ported(
    __name__, ('SamplerDC', 'DualSampler', 'DualSamplerCC'),
    'ROADMAP queue 1 item 6, the dual and data-centric samplers')
