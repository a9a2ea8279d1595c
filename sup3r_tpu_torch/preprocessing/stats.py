"""Multi-container statistics: size-weighted means/stds with JSON
files (the port of ``StatsCollection`` in
``sup3r_tpu/preprocessing/stats.py``, for GridDataset containers; the
paired and lazy containers come with the dual handlers and
``chunked_io``)."""

import json
import logging
import os
from warnings import warn

import numpy as np

logger = logging.getLogger(__name__)


def unwrap_container(c):
    """A container's dataset: a GridDataset (anything with ``sample``)
    itself, or a DataHandler's ``data``."""
    if hasattr(c, 'sample'):
        return c
    data = getattr(c, 'data', None)
    if hasattr(data, 'sample'):
        return data
    return c


class StatsCollection:
    """Per-feature means/stds over a list of GridDatasets, weighted by
    container size, with optional JSON persistence; normalizes the
    containers in place."""

    def __init__(self, containers, means=None, stds=None):
        """``means``/``stds``: dicts, or .json file paths to load/save."""
        self.containers = containers
        self.means = self.get_means(means)
        self.stds = self.get_stds(stds)
        self.save_stats(means, stds)
        self.normalize_containers()

    def _datasets(self):
        return [unwrap_container(c) for c in self.containers]

    def _all_features(self):
        """Union of features over every container, first-seen order."""
        feats = []
        for d in self._datasets():
            feats.extend(f for f in d.features if f not in feats)
        return feats

    def _stat_members(self, feature):
        out = []
        for c, d in zip(self.containers, self._datasets()):
            if feature not in d.features:
                raise KeyError(
                    f'Feature "{feature}" not found in container '
                    f'{type(c).__name__} for stats')
            out.append(d)
        return out

    @staticmethod
    def _member_nanstats(member, feature):
        arr = member[feature]
        return float(np.nanmean(arr)), float(np.nanvar(arr))

    @property
    def container_weights(self):
        sizes = [d.size for d in self._datasets()]
        total = sum(sizes)
        return np.array([s / total for s in sizes])

    @staticmethod
    def _loadable(arg):
        return isinstance(arg, str) and os.path.exists(arg)

    def _given_stats(self, stats, what):
        """A user-provided stats dict/file; warns when it only covers
        SOME features (the missing ones are computed)."""
        if self._loadable(stats):
            with open(stats) as f:
                stats = json.load(f)
        if not isinstance(stats, dict) or not stats:
            return {}
        out = {k: float(v) for k, v in stats.items()}
        missing = [f for f in self._all_features() if f not in out]
        if missing:
            warn(f'Given {what} cover {sorted(out)} but not {missing};'
                 f' computing the missing {what} from the data. If the'
                 ' stats come from a prior run make sure they carry '
                 'over.')
        return out

    def get_means(self, means):
        """Given means plus the container-weighted means of the rest."""
        out = self._given_stats(means, 'means')
        weights = self.container_weights
        for f in self._all_features():
            if f not in out:
                vals = [self._member_nanstats(m, f)[0]
                        for m in self._stat_members(f)]
                out[f] = float(np.sum(weights * np.array(vals)))
        return out

    def get_stds(self, stds):
        """Given stds plus the sqrt of the container-weighted mean
        variances of the rest."""
        out = self._given_stats(stds, 'stds')
        weights = self.container_weights
        for f in self._all_features():
            if f not in out:
                vals = [self._member_nanstats(m, f)[1]
                        for m in self._stat_members(f)]
                out[f] = float(np.sqrt(np.sum(weights
                                              * np.array(vals))))
        return out

    def save_stats(self, means, stds):
        """Write stats to the given .json paths if they don't exist."""
        if isinstance(means, str) and not os.path.exists(means):
            with open(means, 'w') as f:
                json.dump(self.means, f, indent=2)
        if isinstance(stds, str) and not os.path.exists(stds):
            with open(stds, 'w') as f:
                json.dump(self.stds, f, indent=2)

    def normalize_containers(self):
        """Normalize every container in place with the collected stats."""
        for d in self._datasets():
            means = {f: self.means.get(f, 0.0) for f in d.features}
            stds = {f: self.stds.get(f, 1.0) for f in d.features}
            d.normalize(means, stds)
