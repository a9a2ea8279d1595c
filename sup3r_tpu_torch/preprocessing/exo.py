"""Exogenous-feature plumbing: per-model-step exo records and the
rasterizers that map high-res sources (e.g. 90 m topography) onto
enhanced grids.

Reference parity: sup3r/preprocessing/data_handlers/exo.py (ExoData
:53, get_chunk :239, get_exo_steps :363, ExoDataHandler :280),
sup3r/preprocessing/rasterizers/exo.py (KDTree mean-agg rasterization
:295-458, SzaRasterizer :531). The port's copy of
``sup3r_tpu/preprocessing/exo.py`` on numpy and scipy's ``cKDTree``: the
rasters are host arrays; ``generate`` moves them to the model's device.
H5 sources need h5py (CPU machines); NetCDF sources need nothing more.
``ObsRasterizer`` rasterizes sparse station observations (NaN away from
the stations) for ``Sup3rGanWithObs``.
"""

import hashlib
import logging
import os

import numpy as np
from scipy.spatial import cKDTree

from sup3r_tpu_torch.names import strip_obs_suffix
from sup3r_tpu_torch.ops.solar_pos import solar_zenith
from sup3r_tpu_torch.preprocessing.loaders import (
    Loader,
    LoaderH5,
    get_source_type,
)
from sup3r_tpu_torch.utilities import generate_random_string, nn_fill_array
from sup3r_tpu_torch.utilities.times import format_timestamps

logger = logging.getLogger(__name__)


class ExoData(dict):
    """{feature: {'steps': [{'model', 'combine_type', 's_enhance',
    't_enhance', 'data'}]}} with chunk slicing and model-step routing."""

    def __init__(self, steps):
        if not isinstance(steps, dict):
            raise ValueError('ExoData needs a dict of feature entries')
        for feat, entry in steps.items():
            assert 'steps' in entry, f'"{feat}" entry needs a "steps" key'
            for i, step in enumerate(entry['steps']):
                assert 'data' in step and 'combine_type' in step, (
                    f'"{feat}" step #{i} needs "data" and "combine_type"')
        self.update(steps)

    def get_model_step_exo(self, model_step):
        """Sub-ExoData with only the given model step's entries."""
        out = {}
        for feature, entry in self.items():
            steps = [s for s in entry['steps'] if s['model'] == model_step]
            if steps:
                out[feature] = {'steps': steps}
        return ExoData(out)

    @staticmethod
    def _get_bounded_steps(steps, min_step, max_step=None):
        if max_step is not None:
            return [s for s in steps if min_step <= s['model'] < max_step]
        return [s for s in steps if min_step <= s['model']]

    def split(self, split_steps):
        """Split into per-model-group ExoData objects with re-based model
        indices (reference: exo.py:152-196)."""
        split_dict = {i: {} for i in range(len(split_steps) + 1)}
        split_steps = ([0, *split_steps] if split_steps[0] != 0
                       else split_steps)
        for feature, entry in self.items():
            for i, min_step in enumerate(split_steps):
                max_step = (None if min_step == split_steps[-1]
                            else split_steps[i + 1])
                steps_i = self._get_bounded_steps(entry['steps'], min_step,
                                                  max_step)
                for s in steps_i:
                    s.update({'model': s['model'] - min_step})
                if steps_i:
                    split_dict[i][feature] = {'steps': steps_i}
        return [ExoData(s) for s in split_dict.values()]

    def get_combine_type_data(self, feature, combine_type, model_step=None):
        """Data array for the given feature + combine_type (+step)."""
        steps = self[feature]['steps']
        if model_step is not None:
            steps = [s for s in steps if s['model'] == model_step]
        types = [s['combine_type'] for s in steps]
        assert combine_type in types, (
            f'No combine_type="{combine_type}" steps for {feature}')
        return steps[types.index(combine_type)]['data']

    @staticmethod
    def _get_enhanced_slices(lr_slices, step):
        return [slice(sl.start * en, sl.stop * en)
                for en, sl in zip([step['s_enhance'], step['s_enhance'],
                                   step['t_enhance']], lr_slices)]

    def get_chunk(self, lr_slices):
        """Slice all steps' data to the enhanced extent of lr_slices."""
        out = {f: {'steps': []} for f in self}
        for feature in self:
            for step in self[feature]['steps']:
                exo_slices = self._get_enhanced_slices(lr_slices, step)
                new_step = {}
                for k, v in step.items():
                    if k == 'data':
                        new_step[k] = v[tuple(exo_slices)[:v.ndim - 1]]
                    else:
                        new_step[k] = v
                out[feature]['steps'].append(new_step)
        return out


def _default_exo_cache_dir():
    """Exo cache location when the caller gives none: the
    ``SUP3R_TPU_EXO_CACHE_DIR`` environment variable if set, else
    ``./exo_cache`` (the reference default, rasterizers/exo.py:330)."""
    return os.environ.get('SUP3R_TPU_EXO_CACHE_DIR', './exo_cache')


class ExoRasterizer:
    """Map a high-res exo source (e.g. a topography file) onto an
    s/t-enhanced version of the low-res grid by KDTree nearest-neighbor
    mean aggregation (reference: rasterizers/exo.py:295-458)."""

    #: whether get_data depends on the time axis (time-dependent rasters
    #: key their cache by the time extent too)
    TIME_DEPENDENT = False
    #: default for the ``fill_nans`` option
    FILL_NANS_DEFAULT = True

    def __init__(self, file_paths=None, source_file=None, feature=None,
                 s_enhance=1, t_enhance=1, input_handler_kwargs=None,
                 input_handler_name=None, cache_dir=None,
                 distance_upper_bound=None, scale_factor=1.0,
                 fill_nans=None, source_handler_kwargs=None):
        """``scale_factor`` multiplies the raw source values;
        ``fill_nans`` overrides the class default (NN-fill HR cells no
        source point maps to)."""
        from sup3r_tpu_torch.preprocessing.data_handlers import (
            get_input_handler_class,
        )

        self.feature = feature
        self.source_file = source_file
        self.s_enhance = s_enhance
        self.t_enhance = t_enhance
        self.cache_dir = cache_dir or _default_exo_cache_dir()
        self.distance_upper_bound = distance_upper_bound
        self.scale_factor = float(scale_factor)
        self.fill_nans = (self.FILL_NANS_DEFAULT if fill_nans is None
                          else bool(fill_nans))
        self.source_handler_kwargs = source_handler_kwargs or {}

        kwargs = dict(input_handler_kwargs or {})
        time_slice = kwargs.pop('time_slice', slice(None))
        HandlerClass = get_input_handler_class(input_handler_name)
        handler = HandlerClass(
            file_paths, features=[], time_slice=time_slice,
            **{k: v for k, v in kwargs.items()
               if k in ('target', 'shape', 'raster_file', 'threshold')})
        self.lr_lat_lon = handler.lat_lon
        self.lr_time_index = handler.time_index

    @property
    def hr_shape(self):
        """Enhanced (s1, s2, t) shape."""
        return (self.lr_lat_lon.shape[0] * self.s_enhance,
                self.lr_lat_lon.shape[1] * self.s_enhance,
                len(self.lr_time_index) * self.t_enhance)

    @property
    def hr_lat_lon(self):
        """Enhanced grid coordinates (bilinear remesh of the LR grid)."""
        if not hasattr(self, '_hr_lat_lon'):
            if self.s_enhance > 1:
                from sup3r_tpu_torch.postprocessing.writers import (
                    OutputHandler,
                )

                self._hr_lat_lon = OutputHandler.get_lat_lon(
                    self.lr_lat_lon.copy(), self.hr_shape[:2])
            else:
                self._hr_lat_lon = self.lr_lat_lon
        return self._hr_lat_lon

    @property
    def cache_file(self):
        """Cache path keyed by feature + enhancement + spatial extent
        (+ time extent for time-dependent rasters) + source, in the JAX
        package's scheme, so either package reads the other's cache."""
        corner = self.lr_lat_lon[[0, -1], [0, -1]].tobytes()
        key = corner + bytes(str(self.lr_lat_lon.shape), 'utf8')
        if self.TIME_DEPENDENT and self.lr_time_index is not None:
            # pandas' str(Timestamp) of the first and last step, as the
            # JAX package's key has them
            ti = self.lr_time_index
            first, last = format_timestamps([ti[0], ti[-1]])
            key += bytes(f'{first}_{last}_{len(ti)}', 'utf8')
        if self.scale_factor != 1.0:
            key += bytes(f'scale{self.scale_factor!r}', 'utf8')
        if self.fill_nans != self.FILL_NANS_DEFAULT:
            key += bytes(f'fill{self.fill_nans}', 'utf8')
        if self.source_file is not None:
            key += bytes(os.path.abspath(str(self.source_file)), 'utf8')
        if self.source_handler_kwargs:
            key += bytes(str(sorted(self.source_handler_kwargs.items())),
                         'utf8')
        extent = hashlib.md5(key).hexdigest()[:8]
        return os.path.join(
            self.cache_dir,
            f'exo_{self.feature}_{extent}_{self.s_enhance}x_'
            f'{self.t_enhance}x.npy')

    @property
    def data(self):
        """(s1, s2, 1) enhanced exo raster, cached as ``.npy``. The cache
        write is atomic (tmp + rename): workers racing to fill the same
        cache file on a shared filesystem never read a partial file."""
        if not hasattr(self, '_data'):
            if os.path.exists(self.cache_file):
                self._data = np.load(self.cache_file)
            else:
                self._data = self.get_data()
                os.makedirs(self.cache_dir, exist_ok=True)
                tmp = (f'{self.cache_file}.{os.getpid()}'
                       f'.{generate_random_string(6)}.tmp')
                np.save(tmp, self._data)
                # np.save appends .npy when missing
                tmp = tmp if os.path.exists(tmp) else tmp + '.npy'
                os.replace(tmp, self.cache_file)
        return self._data

    def get_source_data(self):
        """(n_points, 2) coords + (n_points,) values from the source."""
        if get_source_type(self.source_file) == 'h5':
            loader = LoaderH5(self.source_file, **self.source_handler_kwargs)
        else:
            loader = Loader(self.source_file, **self.source_handler_kwargs)
        if hasattr(loader, 'lat_lon_flat'):
            # H5 or spatially-flattened NetCDF: a list of sites
            coords = loader.lat_lon_flat
            if self.feature == 'topography' and (
                    loader.elevation is not None):
                values = loader.elevation
            else:
                values = loader.get(self.feature)[0]
            return coords, values
        dset = loader.data
        coords = dset.lat_lon.reshape(-1, 2)
        arr = dset[self.feature]
        if arr.ndim == 3:
            arr = arr[..., 0]
        return coords, arr.reshape(-1)

    def get_distance_upper_bound(self):
        """Twice the diagonal of an HR pixel: points farther than this
        map to no cell (reference: exo.py:275)."""
        if self.distance_upper_bound is not None:
            return self.distance_upper_bound
        lat_span = float(np.ptp(self.hr_lat_lon[..., 0]))
        lon_span = float(np.ptp(self.hr_lat_lon[..., 1]))
        return 2.0 * np.hypot(lat_span / self.hr_shape[0],
                              lon_span / self.hr_shape[1])

    def get_data(self):
        """Mean-aggregate source points onto the HR grid; NN-fill cells
        with no source points (unless ``fill_nans=False``)."""
        coords, values = self.get_source_data()
        if self.scale_factor != 1.0:
            values = np.asarray(values) * self.scale_factor
        grid = self.hr_lat_lon.reshape(-1, 2)
        tree = cKDTree(grid)
        bound = self.get_distance_upper_bound()
        dist, idx = tree.query(coords, distance_upper_bound=bound)
        valid = np.isfinite(dist)
        if not valid.any():
            raise RuntimeError(
                f'No "{self.feature}" source points from '
                f'{self.source_file} mapped onto the target grid within '
                f'distance {bound}; check the source extent / '
                'distance_upper_bound')
        sums = np.bincount(idx[valid], weights=values[valid],
                           minlength=len(grid) + 1)[:len(grid)]
        counts = np.bincount(idx[valid],
                             minlength=len(grid) + 1)[:len(grid)]
        with np.errstate(invalid='ignore'):
            out = sums / counts
        out = out.reshape(self.hr_shape[:2]).astype(np.float32)
        if self.fill_nans and np.isnan(out).any():
            out = nn_fill_array(out)
        return out[..., None]


class SzaRasterizer(ExoRasterizer):
    """Analytic solar zenith angle on the enhanced grid (reference:
    exo.py:531)."""

    @property
    def hr_time_index(self):
        """Enhanced time index."""
        if self.t_enhance == 1:
            return self.lr_time_index
        from sup3r_tpu_torch.postprocessing.writers import OutputHandler

        return OutputHandler.get_times(
            self.lr_time_index, len(self.lr_time_index) * self.t_enhance)

    def get_data(self):
        """(s1, s2, t, 1) sza raster."""
        return solar_zenith(self.hr_time_index, self.hr_lat_lon)[..., None]

    @property
    def data(self):
        """Computed on each new rasterizer, never cached to disk (it is
        cheap)."""
        if not hasattr(self, '_data'):
            self._data = self.get_data()
        return self._data


class ObsRasterizer(ExoRasterizer):
    """Sparse spatiotemporal observations rasterized onto the enhanced
    grid: (s1, s2, t, 1), NaN where a cell has no observation
    (reference: exo.py:461). The feature carries an ``_obs`` suffix; the
    source is read with the base name. Sources: gridded or flattened
    NetCDF, or H5 (which needs h5py)."""

    TIME_DEPENDENT = True
    FILL_NANS_DEFAULT = False

    def _obs_source_series(self):
        """(coords (n, 2), values (n, T_src), source time index)."""
        base = strip_obs_suffix(self.feature)
        if get_source_type(self.source_file) == 'h5':
            loader = LoaderH5(self.source_file, **self.source_handler_kwargs)
            return (loader.lat_lon_flat, loader.get(base).T,
                    loader.time_index)
        loader = Loader(self.source_file, **self.source_handler_kwargs)
        if hasattr(loader, 'lat_lon_flat'):
            # a flattened NetCDF source: a list of sites
            return (loader.lat_lon_flat, np.asarray(loader.get(base)).T,
                    loader.time_index)
        dset = loader.data
        arr = np.asarray(dset[base])
        if arr.ndim == 2:
            arr = arr[..., None]
        return (dset.lat_lon.reshape(-1, 2), arr.reshape(-1, arr.shape[-1]),
                dset.time_index)

    def _hr_time_columns(self, values, src_ti):
        """The column of ``values`` that feeds each enhanced step."""
        n_t = self.hr_shape[2]
        t_src = values.shape[1]
        if t_src == n_t:
            return np.arange(n_t)
        if t_src == 1:
            return np.zeros(n_t, dtype=int)
        if t_src == len(self.lr_time_index):
            return np.repeat(np.arange(t_src), self.t_enhance)
        if src_ti is not None and self.lr_time_index is not None:
            src = np.asarray(src_ti.values)
            hr_times = np.repeat(np.asarray(self.lr_time_index.values),
                                 self.t_enhance)
            pos = np.clip(np.searchsorted(src, hr_times), 0, t_src - 1)
            left = np.clip(pos - 1, 0, t_src - 1)
            use_left = (np.abs(hr_times - src[left])
                        <= np.abs(src[pos] - hr_times))
            return np.where(use_left, left, pos)
        raise ValueError(
            f'Cannot align {t_src} observation timesteps with the '
            f'{n_t}-step enhanced output (no usable time indexes)')

    def get_data(self):
        """Mean of the observations that map to each (cell, step); NaN
        where none does (NN-filled per step only with ``fill_nans``)."""
        coords, values, src_ti = self._obs_source_series()
        if self.scale_factor != 1.0:
            values = np.asarray(values) * self.scale_factor
        grid = self.hr_lat_lon.reshape(-1, 2)
        dist, idx = cKDTree(grid).query(
            coords, distance_upper_bound=self.get_distance_upper_bound())
        valid = np.isfinite(dist)
        vals = np.asarray(values, np.float64)[valid]
        finite = np.isfinite(vals)
        sums = np.zeros((len(grid), vals.shape[1]))
        counts = np.zeros((len(grid), vals.shape[1]))
        np.add.at(sums, idx[valid], np.where(finite, vals, 0.0))
        np.add.at(counts, idx[valid], finite.astype(np.float64))
        with np.errstate(invalid='ignore'):
            agg = sums / counts
        cols = self._hr_time_columns(values, src_ti)
        out = agg[:, cols].reshape(*self.hr_shape[:2], len(cols))
        out = out.astype(np.float32)
        if self.fill_nans and np.isnan(out).any():
            for it in range(out.shape[2]):
                if np.isfinite(out[:, :, it]).any():
                    out[:, :, it] = nn_fill_array(out[:, :, it])
        return out[..., None]


class ExoDataHandler:
    """Build per-model-step exo rasters for a (multi-step) forward pass
    (reference: exo.py:280-498)."""

    RASTERIZERS = {'sza': SzaRasterizer}

    @classmethod
    def _rasterizer_class(cls, feature):
        """Rasterizer for a feature: sza -> analytic, ``*_obs`` -> sparse
        observations, else mean-agg."""
        if feature in cls.RASTERIZERS:
            return cls.RASTERIZERS[feature]
        if feature.endswith('_obs'):
            return ObsRasterizer
        return ExoRasterizer

    def __init__(self, file_paths, feature, model=None, steps=None,
                 source_file=None, input_handler_name=None,
                 input_handler_kwargs=None, cache_dir=None,
                 distance_upper_bound=None, scale_factor=1.0,
                 fill_nans=None, source_handler_kwargs=None):
        self.file_paths = file_paths
        self.feature = feature
        self.model = model
        self.source_file = source_file
        self.input_handler_name = input_handler_name
        self.input_handler_kwargs = input_handler_kwargs or {}
        self.cache_dir = cache_dir or _default_exo_cache_dir()
        self.distance_upper_bound = distance_upper_bound
        self.scale_factor = scale_factor
        self.fill_nans = fill_nans
        self.source_handler_kwargs = source_handler_kwargs
        models = getattr(model, 'models', [model]) if model else []
        self.steps = steps if steps is not None else self.get_exo_steps(
            feature, models)
        if models:
            self._add_enhancements(models)
        else:
            assert all('s_enhance' in s and 't_enhance' in s
                       for s in self.steps), (
                'Need s_enhance/t_enhance in each step or a model')
        self.data = self.get_all_step_data()

    @classmethod
    def get_exo_steps(cls, feature, models):
        """Infer (model, combine_type) steps from the models' feature
        lists (reference: exo.py:363)."""
        steps = []
        for i, model in enumerate(models):
            # the physics surface downscaler always consumes lr topo and
            # re-emits hr topo (reference: exo.py:370-382)
            is_sfc = type(model).__name__ == 'SurfaceSpatialMetModel'
            if feature in model.lr_features or is_sfc:
                steps.append({'model': i, 'combine_type': 'input'})
            if feature in getattr(model, 'hr_exo_features', []):
                steps.append({'model': i, 'combine_type': 'layer'})
            if feature in getattr(model, 'obs_features', []):
                steps.append({'model': i, 'combine_type': 'layer'})
            if feature in model.hr_out_features or is_sfc:
                steps.append({'model': i, 'combine_type': 'output'})
        return steps

    def _add_enhancements(self, models):
        """Cumulative s/t enhancement of each step: input steps up to
        (not including) their model, the others through it."""
        for step in self.steps:
            i = step['model']
            stop = i if step['combine_type'] == 'input' else i + 1
            step['s_enhance'] = int(
                np.prod([m.s_enhance for m in models[:stop]]) or 1)
            step['t_enhance'] = int(
                np.prod([m.t_enhance for m in models[:stop]]) or 1)

    def get_all_step_data(self):
        """ExoData with a raster for each step."""
        cls = self._rasterizer_class(self.feature)
        entry = {'steps': []}
        for step in self.steps:
            rasterizer = cls(
                file_paths=self.file_paths, source_file=self.source_file,
                feature=self.feature, s_enhance=step['s_enhance'],
                t_enhance=step['t_enhance'],
                input_handler_kwargs=self.input_handler_kwargs,
                input_handler_name=self.input_handler_name,
                cache_dir=self.cache_dir,
                distance_upper_bound=self.distance_upper_bound,
                scale_factor=self.scale_factor, fill_nans=self.fill_nans,
                source_handler_kwargs=self.source_handler_kwargs)
            entry['steps'].append({**step, 'data': rasterizer.data})
        return ExoData({self.feature: entry})
