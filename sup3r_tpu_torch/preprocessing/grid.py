"""In-memory labeled grid containers.

``GridDataset`` replaces the reference's xarray-accessor stack
(reference: sup3r/preprocessing/accessor.py Sup3rX,
sup3r/preprocessing/base.py Sup3rDataset) with a minimal eager
container: one float32 block of shape ``(south_north, west_east, time,
feature)`` plus coords. No laziness — chunk streaming happens at the
pipeline layer where it's explicit and double-buffered. The port's copy
of what the forward pass and the training feed use of
``sup3r_tpu/preprocessing/grid.py`` (the sampler hot path ``sample``
and the stats' normalization), with the pandas-free
``TimeIndex``, and ``PairedDataset``, the (low_res, high_res) pair the
dual feed trains on.
"""

import numpy as np

from sup3r_tpu_torch.utilities import TimeIndex, nn_fill_array


class GridDataset:
    """A standardized (s1, s2, t, f) feature block with coords."""

    def __init__(self, data, features, lat_lon=None, time_index=None,
                 attrs=None, levels=None):
        """
        Parameters
        ----------
        data : np.ndarray
            ``(s1, s2, t, f)`` float32 block (3D ``(s1, s2, t)`` accepted
            for a single feature).
        features : list of str
            Feature names ordered like the last axis.
        lat_lon : np.ndarray | None
            ``(s1, s2, 2)`` with (lat, lon) last.
        time_index : TimeIndex | array | None
        attrs : dict | None
        """
        data = np.asarray(data)
        if data.ndim == 3:
            data = data[..., None]
        assert data.ndim == 4, f'Expected 4D block, got {data.shape}'
        self.data = data.astype(np.float32, copy=False)
        self.features = [f.lower() for f in features]
        assert len(self.features) == data.shape[-1], (
            f'{len(self.features)} features vs {data.shape[-1]} channels')
        self.lat_lon = (None if lat_lon is None
                        else np.asarray(lat_lon, dtype=np.float32))
        if time_index is not None and not isinstance(
                time_index, TimeIndex):
            time_index = TimeIndex(time_index)
        self.time_index = time_index
        self.attrs = dict(attrs or {})
        self.levels = levels

    # ------------------------------------------------------------------
    @property
    def shape(self):
        """(s1, s2, t, f)"""
        return self.data.shape

    @property
    def grid_shape(self):
        """(s1, s2)"""
        return self.data.shape[:2]

    @property
    def size(self):
        return self.data.size

    def __contains__(self, feature):
        return str(feature).lower() in self.features

    def feature_index(self, feature):
        """Index of a feature in the channel axis."""
        f = str(feature).lower()
        if f not in self.features:
            raise KeyError(
                f'Feature "{feature}" not in dataset ({self.features})')
        return self.features.index(f)

    def __getitem__(self, key):
        """dataset['u_100m'] -> (s1, s2, t); dataset[['u','v']] ->
        (s1, s2, t, 2); dataset['u_100m', dim_slices...] selects the
        feature then applies the dim slices (reference getitem
        grammar, sup3r/preprocessing/utilities.py:444 parse_keys);
        plain tuple keys slice the block directly."""
        if isinstance(key, str):
            return self.data[..., self.feature_index(key)]
        if isinstance(key, (list, tuple)) and key and isinstance(
                key[0], (str, list)):
            if all(isinstance(f, str) for f in key):
                idx = [self.feature_index(f) for f in key]
                return self.data[..., idx]
            # mixed: feature name(s) followed by dimension keys
            base = self[key[0]]
            rest = tuple(key[1:])
            return base[rest] if rest else base
        return self.data[key]

    def __setitem__(self, feature, values):
        """Overwrite a feature channel (the handler-level bias
        corrections write through this)."""
        self.data[..., self.feature_index(feature)] = values

    def as_array(self, features=None):
        """Stacked (s1, s2, t, f) array for the requested features."""
        if features is None:
            return self.data
        return self[list(features)]

    def slice_dset(self, s1=slice(None), s2=slice(None), t=slice(None),
                   features=None):
        """New GridDataset of a spatiotemporal slice."""
        feats = self.features if features is None else list(features)
        idx = [self.feature_index(f) for f in feats]
        data = self.data[s1, s2, t][..., idx]
        lat_lon = None if self.lat_lon is None else self.lat_lon[s1, s2]
        ti = None if self.time_index is None else self.time_index[t]
        return GridDataset(data, feats, lat_lon=lat_lon, time_index=ti,
                           attrs=self.attrs)

    def sample(self, idx):
        """Crop by an index tuple (s1_slice, s2_slice, t_slice,
        feature_list_or_slice): the sampler hot path."""
        s1, s2, t, f = idx
        if isinstance(f, (list, tuple)) and f and isinstance(f[0], str):
            f = [self.feature_index(x) for x in f]
            return self.data[s1, s2, t][..., f]
        return self.data[s1, s2, t, f]

    def mean(self, features=None):
        """Per-feature means dict."""
        feats = features or self.features
        return {f: float(np.nanmean(self[f])) for f in feats}

    def std(self, features=None):
        """Per-feature stds dict."""
        feats = features or self.features
        return {f: float(np.nanstd(self[f])) for f in feats}

    def normalize(self, means, stds):
        """In-place (x - mean) / std per feature."""
        for i, f in enumerate(self.features):
            sd = stds[f] or 1.0
            self.data[..., i] = (self.data[..., i] - means[f]) / sd

    def interpolate_na(self):
        """Fill NaNs per feature channel from nearest valid values."""
        for i in range(self.data.shape[-1]):
            if np.isnan(self.data[..., i]).any():
                self.data[..., i] = nn_fill_array(self.data[..., i])
        return self

    def __repr__(self):
        return (f'GridDataset(shape={self.shape}, '
                f'features={self.features})')


class PairedDataset:
    """A (low_res, high_res[, obs]) tuple of GridDatasets with attribute
    access by member name (the JAX package's ``PairedDataset``)."""

    def __init__(self, **members):
        assert 1 <= len(members) <= 3
        self._members = dict(members)
        for name, dset in members.items():
            setattr(self, name, dset)

    @property
    def members(self):
        """Ordered member dict."""
        return self._members

    def __iter__(self):
        return iter(self._members.values())

    def __len__(self):
        return len(self._members)

    def __getitem__(self, key):
        if isinstance(key, int):
            return list(self._members.values())[key]
        return self._members[key]

    @property
    def shape(self):
        """Shape of the last (highest-res) member."""
        return list(self._members.values())[-1].shape

    @property
    def size(self):
        """Total elements across members."""
        return sum(m.size for m in self._members.values())

    @property
    def features(self):
        """Union of member features, first-seen order."""
        out = []
        for m in self._members.values():
            out.extend(f for f in m.features if f not in out)
        return out

    def mean(self):
        """Means of the last (high-res) member: normalization stats come
        from the high-res data."""
        return list(self._members.values())[-1].mean()

    def std(self):
        """Stds of the last (high-res) member (see ``mean``)."""
        return list(self._members.values())[-1].std()

    def __repr__(self):
        inner = ', '.join(f'{k}={v!r}' for k, v in self._members.items())
        return f'PairedDataset({inner})'
