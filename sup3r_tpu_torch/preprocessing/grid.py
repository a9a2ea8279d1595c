"""In-memory labeled grid containers.

``GridDataset`` replaces the reference's xarray-accessor stack
(reference: sup3r/preprocessing/accessor.py Sup3rX,
sup3r/preprocessing/base.py Sup3rDataset) with a minimal eager
container: one float32 block of shape ``(south_north, west_east, time,
feature)`` plus coords. No laziness — chunk streaming happens at the
pipeline layer where it's explicit and double-buffered. The port's copy
of what the forward pass uses of ``sup3r_tpu/preprocessing/grid.py``,
with the pandas-free ``TimeIndex``; the sampling, statistics and paired
containers come with the training slice.
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

    def as_array(self, features=None):
        """Stacked (s1, s2, t, f) array for the requested features."""
        if features is None:
            return self.data
        return self[list(features)]

    def interpolate_na(self):
        """Fill NaNs per feature channel from nearest valid values."""
        for i in range(self.data.shape[-1]):
            if np.isnan(self.data[..., i]).any():
                self.data[..., i] = nn_fill_array(self.data[..., i])
        return self

    def __repr__(self):
        return (f'GridDataset(shape={self.shape}, '
                f'features={self.features})')
