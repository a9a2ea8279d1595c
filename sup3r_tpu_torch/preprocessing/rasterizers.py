"""Rasterizers: extract a (target, shape) spatiotemporal extent from
loaded data, including flattened-H5 -> 2D grid reconstruction.

Reference parity: sup3r/preprocessing/rasterizers/base.py:17 (gridded),
extended.py:17 (flattened H5 + raster_file cache). The port's copy of
the ``Rasterizer`` and ``DualRasterizer`` of
``sup3r_tpu/preprocessing/rasterizers.py``; ``lazy=True`` keeps every
variable a windowed-read view (``preprocessing/lazy.py``).
"""

import logging
import os
from warnings import warn

import numpy as np
from scipy.spatial import cKDTree

from sup3r_tpu_torch._native import idw_apply
from sup3r_tpu_torch.ops.coarsen import spatial_coarsening
from sup3r_tpu_torch.preprocessing.grid import GridDataset, PairedDataset
from sup3r_tpu_torch.preprocessing.loaders import (
    Loader,
    LoaderH5,
    LoaderNCFlat,
    RawDataset,
    check_host_ram_budget,
    get_source_type,
)

logger = logging.getLogger(__name__)


def _parse_time_slice(time_slice):
    if time_slice is None:
        return slice(None)
    if isinstance(time_slice, slice):
        return time_slice
    return slice(*time_slice)


def get_closest_row_col(lat_lon, target, threshold=None):
    """(row, col) of the grid point closest to a (lat, lon) target
    (reference: rasterizers/base.py:193)."""
    dist = np.hypot(lat_lon[..., 0] - target[0],
                    lat_lon[..., 1] - target[1])
    row, col = np.unravel_index(np.argmin(dist), dist.shape)
    if threshold is not None and dist.min() > threshold:
        raise RuntimeError(
            f'Closest coordinate {lat_lon[row, col]} to target {target} '
            f'is {dist.min():.4f} away, exceeding threshold {threshold}')
    return int(row), int(col)


def _walk_curvilinear_grid(lat_lon_flat, n_rows, n_cols):
    """Reconstruct a curvilinear grid's gid raster by a nearest-
    neighbor walk with parallelogram extrapolation (covers Lambert-
    projected WTK grids, where lat/lon are not separable).

    The northwest corner's two nearest neighbors seed the row/column
    directions; each further cell is predicted from its already-placed
    neighbors (expected = left + (above - above_left)) and snapped to
    the nearest UNUSED site."""
    pts = np.asarray(lat_lon_flat, dtype=np.float64)
    tree = cKDTree(pts)
    grid = np.full((n_rows, n_cols), -1, dtype=np.int64)
    used = np.zeros(len(pts), dtype=bool)
    lat, lon = pts[:, 0], pts[:, 1]
    score = ((lat - lat.min()) / max(np.ptp(lat), 1e-9)
             - (lon - lon.min()) / max(np.ptp(lon), 1e-9))
    start = int(np.argmax(score))
    grid[0, 0] = start
    used[start] = True

    def snap(expected):
        k = 4
        while True:
            # clamp the final query to the full point set: growing k
            # geometrically past len(pts) without ever querying ALL
            # points raised spuriously while unused sites remained
            k_eff = min(k, len(pts))
            _, idxs = tree.query(expected, k=k_eff)
            for idx in np.atleast_1d(idxs):
                if not used[int(idx)]:
                    used[int(idx)] = True
                    return int(idx)
            if k_eff == len(pts):
                raise RuntimeError('Ran out of unused grid sites')
            k *= 4

    # seed the two axis directions from the corner's nearest neighbors
    _, nn = tree.query(pts[start], k=3)
    cands = [int(i) for i in np.atleast_1d(nn) if int(i) != start]
    d0 = pts[cands[0]] - pts[start]
    d1 = pts[cands[1]] - pts[start]
    # column direction = more eastward; row direction = more southward
    col_dir, row_dir = ((d0, d1) if abs(d0[1]) >= abs(d1[1])
                        else (d1, d0))

    # first row
    for j in range(1, n_cols):
        prev = pts[grid[0, j - 1]]
        step = (col_dir if j == 1
                else prev - pts[grid[0, j - 2]])
        grid[0, j] = snap(prev + step)
    # remaining rows
    for i in range(1, n_rows):
        above = pts[grid[i - 1, 0]]
        step = (row_dir if i == 1
                else above - pts[grid[i - 2, 0]])
        grid[i, 0] = snap(above + step)
        for j in range(1, n_cols):
            # parallelogram: left + (above - above_left)
            expected = (pts[grid[i, j - 1]]
                        + pts[grid[i - 1, j]]
                        - pts[grid[i - 1, j - 1]])
            grid[i, j] = snap(expected)
    return grid


def infer_flat_grid(lat_lon_flat, grid_shape=None):
    """Reconstruct the 2D grid index array from flattened (sites, 2)
    coordinates: exact lexsort for regular lat/lon grids, nearest-
    neighbor walk for curvilinear (e.g. Lambert-projected WTK) grids.
    Returns (n_rows, n_cols) int gid array."""
    lat, lon = lat_lon_flat[:, 0], lat_lon_flat[:, 1]
    lats = np.unique(lat)[::-1]
    lons = np.unique(lon)
    n_rows, n_cols = len(lats), len(lons)
    if n_rows * n_cols == len(lat):
        order = np.lexsort((lon, -lat))
        grid = order.reshape(n_rows, n_cols)
        # verify regularity
        if (np.ptp(lat[grid], axis=1).max() < 1e-4
                and np.ptp(lon[grid], axis=0).max() < 1e-4):
            return grid
    # curvilinear: need the true (rows, cols); infer a square-ish
    # shape if not provided
    if grid_shape is None:
        n = len(lat)
        n_rows = int(np.sqrt(n))
        while n % n_rows:
            n_rows -= 1
        n_cols = n // n_rows
        warn('Flattened meta is not a regular lat/lon grid and no '
             f'grid shape was given; assuming ({n_rows}, {n_cols}) '
             'and reconstructing by nearest-neighbor walk')
    else:
        n_rows, n_cols = grid_shape
    return _walk_curvilinear_grid(lat_lon_flat, n_rows, n_cols)


class Rasterizer:
    """Extract a spatiotemporal extent as a RawDataset (gridded NC) or
    GridDataset-ready arrays (flattened H5)."""

    def __init__(self, file_paths=None, loader=None, features='all',
                 target=None, shape=None, time_slice=slice(None),
                 threshold=None, raster_file=None, max_delta=20,
                 res_kwargs=None, full_grid_shape=None, window=None,
                 lazy=False):
        """``window`` short-circuits extent matching with a precomputed
        raster index: an (s1_slice, s2_slice) pair for gridded NC input
        or a 2D gid array for flattened H5. Used by chunked streaming.
        ``max_delta`` is accepted for reference-config compatibility:
        the reference chunks its raster-index search by max_delta
        (rasterizers/extended.py), while the index here is computed
        exactly in one pass, so no chunking is needed. Still used by
        inference (ForwardPassStrategy(chunked_io=True)) so per-chunk
        reads skip the coordinate search entirely."""
        assert file_paths is not None or loader is not None
        self.lazy = lazy
        if (lazy and loader is None
                and get_source_type(file_paths) != 'h5'):
            res_kwargs = {**(res_kwargs or {}), 'lazy': True}
        self.loader = loader if loader is not None else Loader(
            file_paths, features=features, **(res_kwargs or {}))
        self.file_paths = file_paths
        self.full_grid_shape = full_grid_shape
        self._target = None if target is None else np.asarray(target)
        self._grid_shape = None if shape is None else tuple(shape)
        self.time_slice = _parse_time_slice(time_slice)
        self.threshold = threshold
        self.raster_file = raster_file
        # flattened site-list sources (rex-style H5 AND flattened NC)
        # share the sites interface -> raster reconstruction path
        self._is_flat = isinstance(self.loader, (LoaderH5, LoaderNCFlat))
        self.window = window
        self.raster_index = self._get_raster_index()
        self.data = self._rasterize()

    # ------------------------------------------------------------------
    @property
    def full_lat_lon(self):
        """Full-domain (s1, s2, 2) coordinates."""
        if self._is_flat:
            if not hasattr(self, '_full_grid'):
                self._full_grid = infer_flat_grid(
                    self.loader.lat_lon_flat, self.full_grid_shape)
            flat = self.loader.lat_lon_flat
            return flat[self._full_grid]
        return self.loader.data.lat_lon

    def _get_raster_index(self):
        if self.window is not None:
            if isinstance(self.window, np.ndarray):
                return self.window
            return tuple(self.window)
        if self.raster_file is not None and os.path.exists(
                self.raster_file):
            # ndmin=2: a single-row/column gid raster would otherwise
            # reload 1-D and break the (s1, s2) unpack downstream
            idx = np.loadtxt(self.raster_file, dtype=int, ndmin=2)
            logger.info('Loaded raster index from %s', self.raster_file)
            if self._is_flat:
                return idx
            rows, cols = idx
            return (slice(rows[0], rows[1]), slice(cols[0], cols[1]))

        full = self.full_lat_lon
        if self._target is None:
            self._target = full[-1, 0, :]
        if self._grid_shape is None:
            self._grid_shape = full.shape[:-1]
        row, col = get_closest_row_col(full, self._target, self.threshold)
        lat_slice = slice(max(row - self._grid_shape[0] + 1, 0), row + 1)
        lon_slice = slice(col, min(col + self._grid_shape[1],
                                   full.shape[1]))
        got = (lat_slice.stop - lat_slice.start,
               lon_slice.stop - lon_slice.start)
        if got != tuple(self._grid_shape):
            # the reference warns and proceeds with the clipped extent
            # (rasterizers/base.py:166-191 _check_raster_index) —
            # silent clipping would surface far away as a sampler /
            # forward-pass shape mismatch
            msg = (f'Requested raster shape {tuple(self._grid_shape)} '
                   f'at target {tuple(np.asarray(self._target))} '
                   f'exceeds the available domain {full.shape[:2]}; '
                   f'clipping to {got}')
            logger.warning(msg)
            warn(msg)
        if self._is_flat:
            idx = self._full_grid[lat_slice, lon_slice]
            if self.raster_file is not None:
                np.savetxt(self.raster_file, idx, fmt='%d')
            return idx
        if self.raster_file is not None:
            np.savetxt(self.raster_file, np.array(
                [[lat_slice.start, lat_slice.stop],
                 [lon_slice.start, lon_slice.stop]]), fmt='%d')
        return (lat_slice, lon_slice)

    @property
    def lat_lon(self):
        """Extracted (s1, s2, 2) coordinates."""
        if self._is_flat:
            return self.loader.lat_lon_flat[self.raster_index]
        return self.full_lat_lon[self.raster_index[0],
                                 self.raster_index[1]]

    @property
    def grid_shape(self):
        return self.lat_lon.shape[:2]

    def _rasterize(self):
        if self._is_flat:
            return self._rasterize_flat()
        return self.loader.data.isel(
            s1=self.raster_index[0], s2=self.raster_index[1],
            t=self.time_slice)

    def _rasterize_flat(self):
        """Flattened (time, sites) -> RawDataset on the reconstructed
        grid (reference: rasterizers/extended.py:128). With
        ``lazy=True`` each variable becomes a windowed-read view
        (``_LazyH5Raster``) instead of an eager block."""
        gids = self.raster_index.ravel()
        s1, s2 = self.raster_index.shape
        data_vars, var_dims = {}, {}
        n_t = (len(self.loader.time_index[self.time_slice])
               if self.loader.time_index is not None else 1)
        if not self.lazy:
            check_host_ram_budget(
                s1 * s2 * n_t * len(self.loader.features) * 4,
                'Eager H5 rasterization')
        for feat in self.loader.features:
            if self.lazy:
                from sup3r_tpu_torch.preprocessing.lazy import _LazyH5Raster

                data_vars[feat] = _LazyH5Raster(
                    self.loader, feat, self.raster_index, self.time_slice)
            else:
                block = self.loader.get(feat, self.time_slice, gids)
                data_vars[feat] = block.T.reshape(s1, s2, block.shape[0])
            var_dims[feat] = ('south_north', 'west_east', 'time')
        if ('topography' not in data_vars
                and self.loader.elevation is not None):
            elev = self.loader.elevation[gids].reshape(s1, s2)
            if self.lazy:
                # kept 2D: the deriver broadcasts it over the window's
                # time axis
                data_vars['topography'] = elev.astype(np.float32)
                var_dims['topography'] = ('south_north', 'west_east')
            else:
                data_vars['topography'] = np.repeat(
                    elev[:, :, None], n_t, axis=2).astype(np.float32)
                var_dims['topography'] = ('south_north', 'west_east',
                                          'time')
        ti = (self.loader.time_index[self.time_slice]
              if self.loader.time_index is not None else None)
        return RawDataset(data_vars, var_dims, self.lat_lon,
                          time_index=ti)


class DualRasterizer:
    """Pair LR / HR datasets for dual-resolution training: trim the HR
    data to an enhancement-divisible shape and regrid the LR data onto
    the coarsened HR grid by inverse-distance-weighted k-nearest
    neighbours (reference: rasterizers/dual.py:22, rex's Regridder)."""

    def __init__(self, data, s_enhance=1, t_enhance=1, regrid_workers=1,
                 regrid_lr=True):
        """``data``: a dict or tuple with 'low_res' and 'high_res'
        GridDatasets. ``regrid_workers`` is accepted for reference-config
        compatibility: the regrid is one vectorized pass."""
        if isinstance(data, (tuple, list)):
            lr, hr = data
        else:
            lr, hr = data['low_res'], data['high_res']
        self.s_enhance = s_enhance
        self.t_enhance = t_enhance

        hs1 = (hr.shape[0] // s_enhance) * s_enhance
        hs2 = (hr.shape[1] // s_enhance) * s_enhance
        ht = (hr.shape[2] // t_enhance) * t_enhance
        hr = hr.slice_dset(slice(0, hs1), slice(0, hs2), slice(0, ht))

        lr_lat_lon = spatial_coarsening(hr.lat_lon, s_enhance,
                                        obs_axis=False)
        lr_time = hr.time_index[::t_enhance]
        if regrid_lr:
            lr_data = self._regrid(lr, lr_lat_lon)
        else:
            lr_data = lr.data[:lr_lat_lon.shape[0], :lr_lat_lon.shape[1],
                              :len(lr_time)]
        lr_new = GridDataset(lr_data[:, :, :len(lr_time)], lr.features,
                             lat_lon=lr_lat_lon, time_index=lr_time)
        lr_new.interpolate_na()
        self.lr_data = lr_new
        self.hr_data = hr
        self.data = PairedDataset(low_res=self.lr_data,
                                  high_res=self.hr_data)

    @staticmethod
    def _regrid(lr, target_lat_lon, k=4):
        """IDW k-NN regrid of LR data onto target coordinates; a target
        that matches a source exactly takes that source's value."""
        src = lr.lat_lon.reshape(-1, 2)
        dst = target_lat_lon.reshape(-1, 2)
        dists, idx = cKDTree(src).query(dst, k=min(k, len(src)))
        if dists.ndim == 1:
            dists, idx = dists[:, None], idx[:, None]
        weights = 1.0 / np.maximum(dists, 1e-12)
        exact = dists[:, 0] < 1e-10
        weights[exact] = 0
        weights[exact, 0] = 1
        weights /= weights.sum(axis=1, keepdims=True)
        flat = lr.data.reshape(-1, *lr.data.shape[2:])
        out = idw_apply(flat, idx, weights.astype(np.float32))
        return out.reshape(*target_lat_lon.shape[:2],
                           *lr.data.shape[2:]).astype(np.float32)
