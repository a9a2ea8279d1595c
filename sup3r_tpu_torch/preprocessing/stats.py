"""Multi-container statistics: size-weighted means/stds with JSON
files (the port of ``StatsCollection`` in
``sup3r_tpu/preprocessing/stats.py``, for GridDataset, PairedDataset
and the lazy datasets, whose stats stream over time blocks)."""

import json
import logging
import os
from warnings import warn

import numpy as np

from sup3r_tpu_torch.preprocessing.grid import PairedDataset

logger = logging.getLogger(__name__)


def _is_dataset(obj):
    """A GridDataset or a lazy dataset (anything with ``sample``) or a
    PairedDataset."""
    return hasattr(obj, 'sample') or isinstance(obj, PairedDataset)


def unwrap_container(c):
    """A container's dataset: a GridDataset or PairedDataset itself, or
    a DataHandler's or DualRasterizer's ``data``."""
    if _is_dataset(c):
        return c
    data = getattr(c, 'data', None)
    if _is_dataset(data):
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

    #: the member a paired dataset's stats come from: the high-res one
    #: (features only its other members hold fall back to those)
    _PREFERRED = ('high_res', 'hourly')

    @staticmethod
    def _members(data):
        return (list(data.members.values()) if hasattr(data, 'members')
                else [data])

    def _datasets(self):
        """Stats member per container (a paired dataset's high-res
        member)."""
        out = []
        for c in self.containers:
            data = unwrap_container(c)
            if hasattr(data, 'members'):
                key = next((k for k in self._PREFERRED
                            if k in data.members), None)
                data = (data.members[key] if key
                        else self._members(data)[-1])
            out.append(data)
        return out

    def _ordered_members(self):
        """Per container, its members with the stats member first."""
        return [[pref] + [m for m in self._members(unwrap_container(c))
                          if m is not pref]
                for c, pref in zip(self.containers, self._datasets())]

    def _all_features(self):
        """Union of features over every container and member, the stats
        members' first."""
        feats = []
        for members in self._ordered_members():
            for m in members:
                feats.extend(f for f in m.features if f not in feats)
        return feats

    def _stat_members(self, feature):
        """Per container, the first member (stats member first) that
        holds ``feature``."""
        out = []
        for c, members in zip(self.containers, self._ordered_members()):
            member = next((m for m in members if feature in m.features),
                          None)
            if member is None:
                raise KeyError(
                    f'Feature "{feature}" not found in any member of '
                    f'container {type(c).__name__} for stats')
            out.append(member)
        return out

    @staticmethod
    def _member_nanstats(member, feature):
        """(nanmean, nanvar) of one member's feature: streamed for lazy
        datasets, direct reductions otherwise."""
        if hasattr(member, 'feature_nanstats'):
            return member.feature_nanstats(feature)
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
        """Normalize every container (each member of a paired one) in
        place with the collected stats."""
        for c in self.containers:
            for m in self._members(unwrap_container(c)):
                means = {f: self.means.get(f, 0.0) for f in m.features}
                stds = {f: self.stds.get(f, 1.0) for f in m.features}
                m.normalize(means, stds)
