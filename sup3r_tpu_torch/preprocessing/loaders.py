"""File loaders: standardized eager access to H5 (rex-style flattened)
and NetCDF (gridded) resource files.

Replaces the reference's rex/xarray loader stack (reference:
sup3r/preprocessing/loaders/base.py:28, h5.py:24, nc.py:21) with direct
file access: NetCDF3 classic through scipy.io.netcdf_file, NetCDF4
(which IS HDF5) and rex-style H5 through h5py. The port's copy of
``sup3r_tpu/preprocessing/loaders.py``: h5py is imported only where an
HDF5 file is opened, so NetCDF3 input loads on machines without it, and
time indexes are the pandas-free ``TimeIndex``.

Standardization applied (matching the reference):
  * lowercase names; orog/hgt/elevation -> topography; ERA short names
    (u10 -> u_10m, ...) via ERA_NAME_MAP
  * float32 values with scale_factor decoding
  * descending latitudes (row 0 = northernmost)
  * descending pressure levels (level 0 = max pressure)
"""

import calendar as _cal
import logging
import os
import re
from glob import glob

import numpy as np

from sup3r_tpu_torch.names import (
    DIM_NAMES,
    ERA_NAME_MAP,
    FEATURE_NAMES,
    Dimension,
)
from sup3r_tpu_torch.utilities.times import TimeIndex, to_datetime64

logger = logging.getLogger(__name__)

_IGNORE_VARS = {
    'time_bnds', 'lat_bnds', 'lon_bnds', 'nbnd', 'bnds', 'time_index',
    'meta', 'coordinates', 'expver', 'number', 'crs',
}


def check_host_ram_budget(nbytes, what):
    """Enforce the optional ``SUP3R_TPU_HOST_RAM_GB`` host-memory
    budget: raise before an eager load that would exceed it, pointing
    the user at the streaming data plane (``DataHandler(mode='lazy')``)."""
    budget = os.environ.get('SUP3R_TPU_HOST_RAM_GB')
    if not budget:
        return
    limit = float(budget) * 1024 ** 3
    if nbytes > limit:
        raise MemoryError(
            f'{what} would load {nbytes / 1024 ** 3:.4g} GB eagerly, '
            f'exceeding the SUP3R_TPU_HOST_RAM_GB={budget} budget. '
            "Use DataHandler(mode='lazy') to stream sample windows "
            'from disk instead of loading the full extent.')


def expand_paths(file_paths):
    """Expand glob patterns / lists into a sorted unique path list."""
    if isinstance(file_paths, str):
        file_paths = [file_paths]
    out = []
    for pattern in file_paths:
        matches = sorted(glob(pattern)) if any(
            c in pattern for c in '*?[') else [pattern]
        out.extend(matches)
    out = list(dict.fromkeys(out))
    missing = [f for f in out if not os.path.exists(f)]
    if missing or not out:
        raise FileNotFoundError(f'Could not find files: {missing or file_paths}')
    return out


def get_source_type(file_paths):
    """'h5' or 'nc' from file extension(s)."""
    paths = file_paths if isinstance(file_paths, (list, tuple)) else [
        file_paths]
    exts = {os.path.splitext(str(p))[1].lower() for p in paths}
    if exts.issubset({'.h5', '.hdf5'}):
        return 'h5'
    return 'nc'


def standardize_var_name(name):
    """Map a raw variable name to the canonical feature name."""
    name = name.lower()
    name = FEATURE_NAMES.get(name, name)
    name = ERA_NAME_MAP.get(name, name)
    return name


def _origin_ns(date_part, time_part):
    """The CF origin as datetime64[ns], tz-naive UTC: a ``Z`` or
    ``+hh:mm`` suffix is folded into the value (every time index in the
    framework is tz-naive)."""
    m = re.search(r'([Zz])$|([+-])(\d{1,2}):?(\d{0,2})$', time_part)
    shift = np.timedelta64(0, 'm')
    if m is not None:
        if m.group(2):
            minutes = int(m.group(3)) * 60 + int(m.group(4) or 0)
            shift = np.timedelta64(minutes, 'm') * (
                1 if m.group(2) == '+' else -1)
        time_part = time_part[:m.start()].strip() or '00:00:00'
    hms = [int(x) for x in time_part.split(':') if x != ''] + [0, 0]
    y, mo, d = date_part
    origin = np.datetime64(f'{y:04d}-{mo:02d}-{d:02d}', 'ns') + (
        np.timedelta64(hms[0] * 3600 + hms[1] * 60 + hms[2], 's'))
    return origin - shift


def decode_cf_time(values, units, calendar='standard'):
    """Decode CF-convention numeric time into a ``TimeIndex``.

    Handles 'X since <date>' for seconds/minutes/hours/days, with
    'noleap'/'365_day' and '360_day' calendars decoded by explicit
    year/day arithmetic (datetime64 can't represent those natively, so
    the nearest proleptic-gregorian date is used — same behavior as the
    reference's ``to_datetimeindex`` conversion)."""
    units = units.decode() if isinstance(units, bytes) else str(units)
    calendar = (calendar.decode() if isinstance(calendar, bytes)
                else str(calendar or 'standard')).lower()
    parts = units.split(' since ')
    step, base = parts[0].strip().lower(), parts[1].strip()
    base = base.replace('T', ' ').split('.')[0]
    date_part = base.split(' ')[0]
    y, m, d = (int(x) for x in date_part.split('-'))
    time_part = base.split(' ')[1] if ' ' in base else '00:00:00'

    seconds_per = {'seconds': 1, 'second': 1, 's': 1, 'minutes': 60,
                   'hours': 3600, 'hour': 3600, 'h': 3600,
                   'days': 86400, 'day': 86400, 'd': 86400}[step]
    values = np.asarray(values, dtype=np.float64)

    if calendar in ('noleap', '365_day', '360_day'):
        dpy = 360 if calendar == '360_day' else 365
        # map through a fixed no-leap month table, folding the origin's
        # month AND day into a calendar day count so origins like
        # '2020-02-28' decode correctly
        if calendar == '360_day':
            month_len = [30] * 12
        else:
            month_len = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
        cum = np.cumsum([0, *month_len])
        clean = re.sub(r'[Zz]$|[+-]\d{1,2}:?\d{0,2}$', '',
                       time_part).strip() or '0:0:0'
        tparts = [int(x) for x in clean.split(':') if x != ''] + [0, 0]
        frac_day = (tparts[0] * 3600 + tparts[1] * 60
                    + tparts[2]) / 86400.0
        days = (values * seconds_per / 86400.0 + cum[m - 1]
                + (d - 1) + frac_day)
        years = y + (days // dpy).astype(int)
        doy = days % dpy
        out = []
        for yr, dy in zip(years, doy):
            mi = int(np.searchsorted(cum, dy, side='right')) - 1
            mi = min(mi, 11)
            day = int(dy - cum[mi]) + 1
            frac = dy - int(dy)
            # 360-day months have 30 days; clamp days that don't exist
            # in the proleptic Gregorian target month (Feb 29/30) to
            # that month's last real day
            greg_len = _cal.monthrange(int(yr), mi + 1)[1]
            day = min(day, month_len[mi], greg_len)
            out.append(np.datetime64(
                f'{int(yr):04d}-{mi + 1:02d}-{day:02d}', 'ns')
                + np.timedelta64(round(frac * 86400), 's'))
        return TimeIndex(np.asarray(out, dtype='datetime64[ns]'),
                         unit='us')

    origin = _origin_ns((y, m, d), time_part)
    seconds = values * seconds_per
    whole = np.floor(seconds)
    ns = (whole.astype(np.int64) * 10 ** 9
          + np.round((seconds - whole) * 1e9).astype(np.int64))
    return TimeIndex(origin + ns.astype('timedelta64[ns]'), unit='us')


class _LazyNCVar:
    """Deferred view of an on-disk NetCDF4 variable: slicing reads only
    the requested window from the h5py dataset, applying the dim
    reorder / scale / fill on the fly. This is what lets chunked
    inference stream continental inputs instead of loading them."""

    def __init__(self, dset, src_dims, canon_dims, scale=1.0, offset=0.0,
                 fill=None, flips=()):
        self._dset = dset
        self._src_dims = src_dims
        self.dims = canon_dims
        self._scale = scale
        self._offset = offset
        self._fill = fill
        #: canonical dims whose order is reversed vs on-disk (e.g.
        #: ascending-latitude files exposed with descending lats)
        self.flips = set(flips)
        # canonical shape
        size = dict(zip(canon_dims, [
            dset.shape[src_dims.index(d)] for d in canon_dims]))
        self.shape = tuple(size[d] for d in canon_dims)
        self.ndim = len(self.shape)
        self.dtype = np.float32

    def _decode(self, values):
        raw = np.asarray(values)
        values = raw.astype(np.float32)
        # fill comparison happens in PACKED space (before scale/offset)
        if self._fill is not None and not np.isnan(self._fill):
            values = np.where(raw == np.asarray(self._fill).astype(
                raw.dtype), np.nan, values)
        if self._scale != 1.0 or self._offset != 0.0:
            values = values * self._scale + self._offset
        return values

    def isel(self, sel):
        """Read a window; ``sel`` maps canonical dim name -> slice (in
        canonical orientation, flips applied transparently)."""
        size = dict(zip(self.dims, self.shape))
        src_idx, post = [], {}
        for d in self._src_dims:
            sl = sel.get(d, slice(None))
            step = sl.step or 1
            if step != 1:
                # strided/reversed window: read the full dim, apply the
                # canonical slice after reorder (h5py can't step < 0)
                post[d] = sl
                sl = slice(None)
            elif d in self.flips:
                n = size[d]
                start, stop, _ = sl.indices(n)
                sl = slice(n - stop, n - start)
            src_idx.append(sl)
        block = self._dset[tuple(src_idx)]
        order = [self._src_dims.index(d) for d in self.dims
                 if d in self._src_dims]
        block = np.transpose(block, order)
        for d in self.flips:
            block = np.flip(block, axis=self.dims.index(d))
        if post:
            block = block[tuple(post.get(d, slice(None))
                                for d in self.dims)]
        return self._decode(block)

    def __getitem__(self, idx):
        """Materialize fully then index (for API parity with arrays)."""
        return self.materialize()[idx]

    def __array__(self, dtype=None, copy=None):
        out = self.materialize()
        return out.astype(dtype) if dtype is not None else out

    def materialize(self):
        """Full read in canonical order."""
        return self.isel({})


class _LazyTimeConcat:
    """Lazy concatenation of per-file lazy variables along time (e.g.
    monthly/yearly NetCDF series). Window reads split the requested
    time slice across member files so only touched files hit disk —
    the TPU-native replacement for the reference's dask-backed
    ``xr.open_mfdataset`` laziness (sup3r/preprocessing/loaders/nc.py)."""

    def __init__(self, parts, dims):
        self.parts = list(parts)
        self.dims = dims
        self._t_ax = dims.index(Dimension.TIME)
        sizes = [p.shape[self._t_ax] for p in self.parts]
        self._offsets = np.cumsum([0, *sizes])
        shape = list(self.parts[0].shape)
        shape[self._t_ax] = int(self._offsets[-1])
        self.shape = tuple(shape)
        self.ndim = len(self.shape)
        self.dtype = np.float32

    def isel(self, sel):
        """Read a window; the time slice is routed to the member files
        that overlap it (contiguous step-1 slices only)."""
        tsl = sel.get(Dimension.TIME, slice(None))
        start, stop, step = tsl.indices(self.shape[self._t_ax])
        if step != 1:
            # read the contiguous envelope, stride afterwards
            env = dict(sel)
            lo, hi = (start, stop) if step > 0 else (stop + 1, start + 1)
            env[Dimension.TIME] = slice(lo, hi)
            out = self.isel(env)
            idx = [slice(None)] * out.ndim
            idx[self._t_ax] = slice(None, None, step)
            return out[tuple(idx)]
        blocks = []
        for i, part in enumerate(self.parts):
            lo = max(start, int(self._offsets[i])) - int(self._offsets[i])
            hi = min(stop, int(self._offsets[i + 1])) - int(
                self._offsets[i])
            if hi <= lo:
                continue
            psel = dict(sel)
            psel[Dimension.TIME] = slice(lo, hi)
            if hasattr(part, 'isel'):
                blocks.append(part.isel(psel))
            else:
                idx = tuple(psel.get(d, slice(None)) for d in self.dims)
                blocks.append(np.asarray(part[idx], dtype=np.float32))
        return np.concatenate(blocks, axis=self._t_ax)

    def __getitem__(self, idx):
        return self.materialize()[idx]

    def __array__(self, dtype=None, copy=None):
        out = self.materialize()
        return out.astype(dtype) if dtype is not None else out

    def materialize(self):
        """Full read in canonical order."""
        return self.isel({})


def compose_slice(outer, inner, n):
    """Compose two slices: the result selects, out of ``n`` elements,
    what ``inner`` selects within the extent ``outer`` selects. Handles
    arbitrary starts/stops/steps (range arithmetic)."""
    r = range(n)[outer][inner]
    if len(r) == 0:
        # an empty negative-step range can carry start=stop=-1, and
        # the stop<0 -> None rewrite below would turn "select nothing"
        # into "select from the last element down" (review finding)
        return slice(0, 0, 1)
    stop = r.stop
    if r.step < 0 and stop < 0:
        stop = None
    return slice(r.start, stop, r.step)


def _is_lazy(x):
    """Whether ``x`` reads from disk on demand (duck-typed on the
    ``materialize`` method all lazy variable classes implement)."""
    return hasattr(x, 'materialize')


class _LazyWindow:
    """A deferred window over another lazy variable: slicing composes
    instead of reading, so chained ``RawDataset.isel`` calls (full
    extent -> sample window) only touch disk when the innermost window
    is finally accessed. This is what lets the streaming training data
    plane sample from larger-than-RAM stores (reference ``mode='lazy'``,
    sup3r/preprocessing/batch_queues/abstract.py:135-141)."""

    def __init__(self, var, sel):
        if isinstance(var, _LazyWindow):
            sel = {d: compose_slice(
                var._sel.get(d, slice(None)), sel.get(d, slice(None)),
                dict(zip(var._var.dims, var._var.shape))[d])
                for d in var.dims}
            var = var._var
        self._var = var
        self._sel = {d: sel.get(d, slice(None)) for d in var.dims}
        self.dims = var.dims
        self.shape = tuple(
            len(range(n)[self._sel[d]])
            for d, n in zip(var.dims, var.shape))
        self.ndim = len(self.shape)
        self.dtype = np.float32

    def isel(self, sel):
        """Read a window (``sel`` relative to THIS window's extent)."""
        composed = {
            d: compose_slice(self._sel[d], sel.get(d, slice(None)), n)
            for d, n in zip(self._var.dims, self._var.shape)}
        return self._var.isel(composed)

    def __getitem__(self, idx):
        return self.materialize()[idx]

    def __array__(self, dtype=None, copy=None):
        out = self.materialize()
        return out.astype(dtype) if dtype is not None else out

    def materialize(self):
        """Full read of this window in canonical order."""
        return self._var.isel(self._sel)


#: duck-type tuple for "reads from disk on demand"
_LAZY_TYPES = (_LazyNCVar, _LazyTimeConcat, _LazyWindow)


class RawDataset:
    """Gridded variables with canonical dims (s1, s2, t[, level]) plus
    coords — the loader→rasterizer→deriver interchange container."""

    def __init__(self, data_vars, var_dims, lat_lon, time_index=None,
                 levels=None, attrs=None):
        """data_vars: {name: ndarray}; var_dims: {name: tuple of dim
        names}; lat_lon: (s1, s2, 2)."""
        self.data_vars = data_vars
        self.var_dims = var_dims
        self.lat_lon = np.asarray(lat_lon, dtype=np.float32)
        self.time_index = time_index
        self.levels = levels
        self.attrs = dict(attrs or {})

    @property
    def features(self):
        return list(self.data_vars)

    @property
    def grid_shape(self):
        return self.lat_lon.shape[:2]

    @property
    def shape(self):
        t = 0 if self.time_index is None else len(self.time_index)
        return (*self.grid_shape, t, len(self.data_vars))

    def __contains__(self, name):
        return str(name).lower() in self.data_vars

    def __getitem__(self, name):
        var = self.data_vars[str(name).lower()]
        if _is_lazy(var):
            var = var.materialize()
            self.data_vars[str(name).lower()] = var
        return var

    def dims(self, name):
        """Canonical dim names of a variable."""
        return self.var_dims[str(name).lower()]

    def isel(self, s1=slice(None), s2=slice(None), t=slice(None)):
        """Slice all variables spatially/temporally. Lazy variables
        stay lazy (the window composes); they read from disk only when
        accessed through ``__getitem__``/``materialize``."""
        sel = {Dimension.SOUTH_NORTH: s1, Dimension.WEST_EAST: s2,
               Dimension.TIME: t}
        new_vars, new_dims = {}, {}
        for name, arr in self.data_vars.items():
            dims = self.var_dims[name]
            if _is_lazy(arr):
                new_vars[name] = _LazyWindow(arr, sel)
            else:
                idx = tuple(sel.get(dim, slice(None)) for dim in dims)
                new_vars[name] = arr[idx]
            new_dims[name] = dims
        ti = None if self.time_index is None else self.time_index[t]
        return RawDataset(new_vars, new_dims, self.lat_lon[s1, s2],
                          time_index=ti, levels=self.levels,
                          attrs=self.attrs)

    def __repr__(self):
        return (f'RawDataset(grid={self.grid_shape}, '
                f'vars={list(self.data_vars)})')


def _decode_time_index(values, attrs):
    """Decode a NetCDF time variable into a ``TimeIndex``: CF 'units
    since' encodings (incl. noleap/360-day calendars), raw datetime64
    nanoseconds, or ISO date strings."""
    t_vals = np.asarray(values[:])
    if 'units' in attrs and 'since' in str(attrs['units']):
        return decode_cf_time(t_vals, attrs['units'],
                              attrs.get('calendar', 'standard'))
    if np.issubdtype(t_vals.dtype, np.integer) and t_vals.max() > 10**14:
        return TimeIndex(t_vals.astype('datetime64[ns]'))
    return TimeIndex(to_datetime64(t_vals))


_LAT_COORD_NAMES = ('latitude', 'lat', 'xlat')
_LON_COORD_NAMES = ('longitude', 'lon', 'xlong')


def _is_flat_layout(lat, lon):
    """THE flattened-layout predicate, shared by the ``Loader``
    factory probe and ``LoaderNC``'s misuse guard so they cannot
    drift: lat/lon are 1-D over one IDENTICAL dim (a site list) —
    on a regular grid their dims differ. Reference ``_is_flattened``:
    sup3r/preprocessing/loaders/nc.py:73-80. Checks metadata only
    (never reads coordinate values)."""
    lat_dims, lat_arr = lat[0], lat[1]
    lat_shape = tuple(getattr(lat_arr, 'shape', np.shape(lat_arr)))
    lon_shape = tuple(getattr(lon[1], 'shape', np.shape(lon[1])))
    return (len(lat_dims) == 1 and tuple(lat_dims) == tuple(lon[0])
            and len(lat_shape) == 1 and lat_shape == lon_shape)


def nc_is_flattened(path):
    """Whether a NetCDF file stores spatially FLATTENED data: 1-D
    latitude/longitude sharing one spatial dim (site list), rather
    than a lat x lon grid (see ``_is_flat_layout``)."""
    backend, handle = _nc_open(path)
    try:
        raw = _nc_vars(backend, handle)
        lower = {k.lower(): k for k in raw}
        lat = next((raw[lower[n]] for n in _LAT_COORD_NAMES
                    if n in lower), None)
        lon = next((raw[lower[n]] for n in _LON_COORD_NAMES
                    if n in lower), None)
        if lat is None or lon is None:
            return False
        return _is_flat_layout(lat, lon)
    finally:
        handle.close()


def _nc_open(path):
    """Open a NetCDF file: scipy for classic, h5py for NetCDF4/HDF5
    (imported here: only HDF5 input needs it)."""
    with open(path, 'rb') as f:
        magic = f.read(4)
    if magic.startswith(b'CDF'):
        from scipy.io import netcdf_file

        return ('scipy', netcdf_file(path, 'r', mmap=False))
    import h5py

    return ('h5py', h5py.File(path, 'r'))


def _nc_vars(backend, handle):
    """(name -> (dims, array_like, attrs)) for a NetCDF handle."""
    out = {}
    if backend == 'scipy':
        for name, var in handle.variables.items():
            attrs = {k: getattr(var, k) for k in var._attributes}
            out[name] = (tuple(var.dimensions), var.data, attrs)
    else:
        import h5py

        def is_dim_scale(ds):
            return ds.attrs.get('CLASS') == b'DIMENSION_SCALE'

        for name, ds in handle.items():
            if not isinstance(ds, h5py.Dataset):
                continue
            if 'DIMENSION_LIST' in ds.attrs:
                dims = []
                for i in range(ds.ndim):
                    refs = ds.attrs['DIMENSION_LIST'][i]
                    dims.append(handle[refs[0]].name.strip('/')
                                if len(refs) else f'dim_{i}')
                dims = tuple(dims)
            elif is_dim_scale(ds):
                dims = (name,)
            else:
                dims = tuple(f'dim_{i}' for i in range(ds.ndim))
            attrs = dict(ds.attrs)
            out[name] = (dims, ds, attrs)
    return out


class LoaderNC:
    """Load NetCDF file(s) into a standardized RawDataset.

    Multiple files merge variables on a common grid and/or concatenate
    along time (reference: xr_open_mfdataset usage at
    sup3r/preprocessing/loaders/nc.py:28)."""

    def __init__(self, file_paths, features='all', res_kwargs=None,
                 chunks=None, BaseLoader=None, lazy=False):
        """``res_kwargs``/``chunks``/``BaseLoader`` are accepted for
        reference-config compatibility (they configure xarray/dask in
        the reference; the data plane here is h5py/scipy and loads are
        eager or lazy-windowed). ``lazy=True`` defers variable reads
        (h5py-backed NetCDF4 files only): data is pulled from disk per
        requested window. NetCDF3 is read whole either way."""
        self.file_paths = expand_paths(file_paths)
        self._handles = []
        self.lazy = lazy
        #: requested-feature filter, applied BEFORE eager reads so an
        #: explicit features list neither pays I/O for nor counts the
        #: other variables against the host-RAM budget
        self._keep = (None if features in ('all', None)
                      else {standardize_var_name(f) for f in features})
        per_file = [self._load_one(p) for p in self.file_paths]
        self.data = self._merge(per_file)

    def _load_one(self, path):
        backend, handle = _nc_open(path)
        lazy = self.lazy and backend == 'h5py'
        try:
            return self._standardize(_nc_vars(backend, handle),
                                     lazy=lazy)
        finally:
            if lazy:
                self._handles.append(handle)  # kept open for reads
            else:
                # an eager load read everything: close the handle rather
                # than leak one fd per member file
                handle.close()

    def close(self):
        """Close any lazily-held file handles."""
        for h in self._handles:
            h.close()
        self._handles = []

    def _standardize(self, raw_vars, lazy=False):
        # resolve coordinate arrays
        lower = {k.lower(): k for k in raw_vars}

        def get_coord(*names):
            for n in names:
                if n in lower:
                    return raw_vars[lower[n]]
            return None

        lat = get_coord('latitude', 'lat', 'xlat', 'south_north')
        lon = get_coord('longitude', 'lon', 'xlong', 'west_east')
        time = get_coord('time', 'valid_time', 'xtime')
        level = get_coord('level', 'plev', 'isobaricinhpa',
                          'pressure_level')
        assert lat is not None and lon is not None, 'No lat/lon found'

        lat_vals = np.asarray(lat[1][:], dtype=np.float32)
        lon_vals = np.asarray(lon[1][:], dtype=np.float32)
        lat_dims, lon_dims = lat[0], lon[0]
        if _is_flat_layout(lat, lon):
            # a 1-D lat/lon PAIR over one shared dim is a flattened
            # site list, not a grid — meshgridding it would build a
            # wrong n x n grid and drop every data variable
            raise TypeError(
                'Spatially-flattened NetCDF input (1-D lat/lon over '
                'a shared spatial dim) — construct through Loader(), '
                'which routes it to LoaderNCFlat (reference '
                '_is_flattened: loaders/nc.py:73-80)')
        if lat_vals.ndim == 1:
            lon2d, lat2d = np.meshgrid(lon_vals, lat_vals)
        else:
            lat2d, lon2d = lat_vals, lon_vals
        if (lon2d > 180.0).any():
            # standardize 0-360 longitudes to [-180, 180] (reference:
            # loaders/utilities.py:28)
            lon2d = (lon2d + 180.0) % 360.0 - 180.0

        time_index = (None if time is None
                      else _decode_time_index(time[1], time[2]))

        levels = None if level is None else np.asarray(
            level[1][:], dtype=np.float32)

        # dim-name -> canonical mapping
        time_dim = None if time is None else time[0][0]
        level_dim = None if level is None else level[0][0]
        lat_dim = lat_dims[0] if len(lat_dims) else None
        lon_dim = (lon_dims[0] if lat_vals.ndim == 1
                   else (lat_dims[1] if len(lat_dims) > 1 else None))

        def canon_dims(dims):
            out = []
            for d in dims:
                if d == time_dim:
                    out.append(Dimension.TIME)
                elif d == level_dim:
                    out.append(Dimension.PRESSURE_LEVEL)
                elif d == lat_dim:
                    out.append(Dimension.SOUTH_NORTH)
                elif d == lon_dim:
                    out.append(Dimension.WEST_EAST)
                else:
                    out.append(DIM_NAMES.get(d.lower(), d))
            return tuple(out)

        coord_names = {lower.get(n) for n in (
            'latitude', 'lat', 'xlat', 'longitude', 'lon', 'xlong',
            'time', 'valid_time', 'xtime', 'level', 'plev',
            'isobaricinhpa', 'pressure_level', 'south_north', 'west_east')}

        target_order = (Dimension.SOUTH_NORTH, Dimension.WEST_EAST,
                        Dimension.TIME, Dimension.PRESSURE_LEVEL)
        data_vars, var_dims = {}, {}
        # the budget accumulates ACROSS member files on the instance —
        # a per-file counter let an n-file load exceed the cap n-fold
        # before _merge concatenated it all (review finding)
        if not hasattr(self, '_eager_bytes'):
            self._eager_bytes = 0
        for name, (dims, arr, attrs) in raw_vars.items():
            if name in coord_names or name.lower() in _IGNORE_VARS:
                continue
            if (self._keep is not None
                    and standardize_var_name(name) not in self._keep):
                continue
            cdims = canon_dims(dims)
            if Dimension.SOUTH_NORTH not in cdims or (
                    Dimension.WEST_EAST not in cdims):
                continue
            extra = [d for d in cdims if d not in target_order]
            if extra:
                # e.g. WRF soil-layer or bounds dims: not
                # representable on the (s1, s2, t[, level]) grid —
                # skip instead of crashing the whole load on a
                # variable nobody requested
                logger.debug(
                    'Skipping variable "%s" with non-canonical '
                    'dim(s) %s', name, extra)
                continue
            # CF packing: apply EITHER attribute when present —
            # add_offset is legal without scale_factor (scale
            # defaults to 1), and gating the offset on the scale
            # silently shifted such variables by -offset
            sf = float(np.asarray(
                attrs.get('scale_factor', 1.0)).ravel()[0])
            off = float(np.asarray(
                attrs.get('add_offset', 0.0)).ravel()[0])
            units = attrs.get('units')
            if isinstance(units, bytes):
                units = units.decode()
            if str(units) == 'K':
                # standardize temperatures to Celsius (reference:
                # loaders/utilities.py:23-25)
                off -= 273.15
            fill = attrs.get('_FillValue', attrs.get('missing_value'))
            fv = (float(np.asarray(fill).ravel()[0])
                  if fill is not None else None)
            canon = tuple(d for d in target_order if d in cdims)
            if lazy:
                values = _LazyNCVar(arr, cdims, canon, scale=sf,
                                    offset=off, fill=fv)
            else:
                # budget the CUMULATIVE eager load, not each variable in
                # isolation — many medium variables can blow the
                # host-RAM cap just as surely as one big one
                self._eager_bytes += int(np.prod(arr.shape)) * 4
                check_host_ram_budget(
                    self._eager_bytes,
                    f'Eager NetCDF load through variable "{name}"')
                raw = np.asarray(arr[:])
                values = raw.astype(np.float32)
                # fill comparison happens in PACKED space
                if fv is not None and not np.isnan(fv):
                    values = np.where(
                        raw == np.asarray(fv).astype(raw.dtype),
                        np.nan, values)
                if sf != 1.0 or off != 0.0:
                    values = values * sf + off
                order = [cdims.index(d) for d in target_order
                         if d in cdims]
                values = np.transpose(values, order)
            data_vars[standardize_var_name(name)] = values
            var_dims[standardize_var_name(name)] = canon

        dset = RawDataset(data_vars, var_dims, np.dstack([lat2d, lon2d]),
                          time_index=time_index, levels=levels)
        return self._enforce_descending(dset)

    @staticmethod
    def _enforce_descending(dset):
        """Descending lats (north first) + descending pressure levels."""
        if dset.lat_lon[-1, 0, 0] > dset.lat_lon[0, 0, 0]:
            dset.lat_lon = dset.lat_lon[::-1].copy()
            for name, arr in dset.data_vars.items():
                if Dimension.SOUTH_NORTH in dset.var_dims[name]:
                    if isinstance(arr, _LazyNCVar):
                        arr.flips.add(Dimension.SOUTH_NORTH)
                        continue
                    ax = dset.var_dims[name].index(Dimension.SOUTH_NORTH)
                    dset.data_vars[name] = np.flip(arr, axis=ax).copy()
        if dset.levels is not None and len(dset.levels) > 1 and (
                dset.levels[-1] > dset.levels[0]):
            dset.levels = dset.levels[::-1].copy()
            for name, arr in dset.data_vars.items():
                dims = dset.var_dims[name]
                if Dimension.PRESSURE_LEVEL in dims:
                    if isinstance(arr, _LazyNCVar):
                        arr.flips.add(Dimension.PRESSURE_LEVEL)
                        continue
                    ax = dims.index(Dimension.PRESSURE_LEVEL)
                    dset.data_vars[name] = np.flip(arr, axis=ax).copy()
        return dset

    @staticmethod
    def _merge(datasets):
        """Merge variable sets; concat along time when the same variable
        appears with disjoint time ranges."""
        if len(datasets) == 1:
            return datasets[0]
        base = datasets[0]
        for other in datasets[1:]:
            same_grid = base.grid_shape == other.grid_shape
            assert same_grid, 'Cannot merge NC files on different grids'
            overlap = set(base.data_vars) & set(other.data_vars)
            if overlap and base.time_index is not None and (
                    other.time_index is not None) and not (
                    base.time_index.equals(other.time_index)):
                # time concat
                order = np.argsort(
                    np.concatenate([base.time_index.values,
                                    other.time_index.values]))
                sorted_cat = bool(np.all(np.diff(order) > 0))
                for name in overlap:
                    if Dimension.TIME not in base.var_dims.get(
                            name, ()):
                        # time-invariant var (orography, landmask)
                        # present in every file: keep one copy rather
                        # than crashing on the missing time axis
                        continue
                    a, b = base.data_vars[name], other.data_vars[name]
                    lazy = isinstance(a, _LAZY_TYPES) or isinstance(
                        b, _LAZY_TYPES)
                    if lazy and sorted_cat:
                        parts = (a.parts if isinstance(a, _LazyTimeConcat)
                                 else [a])
                        parts = [*parts, *(
                            b.parts if isinstance(b, _LazyTimeConcat)
                            else [b])]
                        base.data_vars[name] = _LazyTimeConcat(
                            parts, base.var_dims[name])
                        continue
                    ax = base.var_dims[name].index(Dimension.TIME)
                    cat = np.concatenate([np.asarray(a), np.asarray(b)],
                                         axis=ax)
                    base.data_vars[name] = np.take(cat, order, axis=ax)
                base.time_index = TimeIndex(
                    np.concatenate([base.time_index.values,
                                    other.time_index.values])[order],
                    unit=base.time_index.unit)
                # a time-varying variable present in only ONE of the
                # files cannot ride the extended time axis — dropping
                # or keeping it short would silently misalign isel()
                # downstream, so fail loudly (time-independent vars
                # pass through unchanged)
                time_overlap = {
                    n for n in overlap
                    if Dimension.TIME in base.var_dims.get(n, ())}
                for name in set(base.data_vars) - time_overlap:
                    if Dimension.TIME in base.var_dims.get(name, ()):
                        raise ValueError(
                            f'Variable "{name}" is missing from part '
                            'of a multi-file time-concat load; all '
                            'time-varying variables must appear in '
                            'every file')
                for name in set(other.data_vars) - overlap:
                    if Dimension.TIME in other.var_dims.get(name, ()):
                        raise ValueError(
                            f'Variable "{name}" is missing from part '
                            'of a multi-file time-concat load; all '
                            'time-varying variables must appear in '
                            'every file')
                    base.data_vars[name] = other.data_vars[name]
                    base.var_dims[name] = other.var_dims[name]
            else:
                # no shared time-varying variables: the files must
                # agree on the time axis, or a variable unique to one
                # file would silently ride the OTHER file's timestamps
                mismatched = (base.time_index is not None
                              and other.time_index is not None
                              and not base.time_index.equals(
                                  other.time_index))
                for name in other.data_vars:
                    if name not in base.data_vars:
                        if mismatched and Dimension.TIME in (
                                other.var_dims.get(name, ())):
                            raise ValueError(
                                f'Variable "{name}" comes from a file '
                                'whose time index differs from the '
                                'other files and shares no variables '
                                'with them — merging would silently '
                                'misalign its timestamps')
                        base.data_vars[name] = other.data_vars[name]
                        base.var_dims[name] = other.var_dims[name]
                if base.time_index is None:
                    base.time_index = other.time_index
                if base.levels is None:
                    base.levels = other.levels
        return base


def _static_rows(n_t_total, time_slice):
    """How many time rows a SITE-STATIC variable must produce for a
    global time slice: the sliced length of the store's time axis, so
    static rasters line up with time-varying features when stacked
    (a 1-row result crashed the Deriver for any T>1 window)."""
    return len(range(max(int(n_t_total or 1), 1))[time_slice])


def _route_time_reads(lens, time_slice, read_block, n_cols):
    """Route a GLOBAL time slice across per-file row blocks.

    ``lens`` are the per-file time lengths (concatenation order);
    ``read_block(part_index, sel)`` reads that file's rows for a
    local, evenly-spaced ascending slice and returns (rows, n_cols)
    data. Handles negative-step slices by reading ascending and
    flipping the assembled result (per-file descending slices dropped
    rows and ordered blocks by file instead of by the slice — a
    round-4 review finding), and returns an empty (0, n_cols) block
    when the slice selects nothing. Shared by ``_H5Var`` and
    ``_FlatNCVar`` so the routing logic cannot diverge between the
    two flattened-source paths."""
    idx = np.arange(sum(lens))[time_slice]
    reverse = idx.size > 1 and idx[1] < idx[0]
    if reverse:
        idx = idx[::-1]
    blocks = []
    start = 0
    for k, n in enumerate(lens):
        local = idx[(idx >= start) & (idx < start + n)] - start
        start += n
        if local.size == 0:
            continue
        # a global slice restricted to one file is evenly spaced, so
        # a plain (fast) slice read suffices
        step = int(local[1] - local[0]) if local.size > 1 else 1
        blocks.append(read_block(
            k, slice(int(local[0]), int(local[-1]) + 1, step)))
    if not blocks:
        out = np.zeros((0, n_cols), np.float32)
    elif len(blocks) == 1:
        out = blocks[0]
    else:
        out = np.concatenate(blocks, axis=0)
    if reverse:
        out = out[::-1]
    return out.astype(np.float32)


class _H5Var:
    """Lazy handle for one (time, sites) H5 dataset with scale decode.

    ``n_t_total`` (the store's full time length) sizes the broadcast
    of site-static 1-D datasets so they stack against time-varying
    features."""

    def __init__(self, datasets, scale, n_t_total=1):
        self._datasets = datasets  # list of h5py datasets (time concat)
        self._scale = scale
        self._n_t = int(n_t_total or 1)

    def get(self, time_slice=slice(None), gids=None):
        """Read (time, sites) float32 data for a time slice + gid set.

        The time slice addresses the CONCATENATED time axis across
        member files and is routed into each file's local range —
        slicing each file with the global slice would return wrong
        (and wrongly-sized) data for any multi-file load with a
        non-trivial time_slice."""
        if all(ds.ndim == 1 for ds in self._datasets):
            # site-static var (e.g. elevation): identical in every
            # member file, broadcast over the sliced time length
            ds = self._datasets[0]
            arr = ds[:] if gids is None else ds[:][np.asarray(gids)]
            row = arr.astype(np.float32) / self._scale
            # zero-copy view: materializing (T_total, n_sites) via
            # np.repeat for a multi-year store is a many-GB
            # allocation just to read one static row (callers that
            # mutate must copy; np.stack/astype downstream already do)
            return np.broadcast_to(
                row[None],
                (_static_rows(self._n_t, time_slice), row.size))

        def read_block(k, sel):
            ds = self._datasets[k]
            if gids is not None:
                # restrict the read to the [min, max] gid range — for
                # spatially compact windows this is far smaller than
                # the full site extent, and a contiguous h5py slice
                # is fast where fancy indexing is not
                g = np.asarray(gids)
                lo, hi = int(g.min()), int(g.max()) + 1
                return ds[sel, lo:hi][:, g - lo]
            return ds[sel, :]

        n_cols = (len(np.asarray(gids)) if gids is not None
                  else self._datasets[0].shape[-1])
        out = _route_time_reads(
            [ds.shape[0] for ds in self._datasets], time_slice,
            read_block, n_cols)
        return out / self._scale


class LoaderH5:
    """rex-style flattened H5 loader: 'meta' table + (time, sites)
    datasets + byte-string time_index (reference:
    sup3r/preprocessing/loaders/h5.py:24)."""

    def __init__(self, file_paths, features='all', res_kwargs=None,
                 chunks=None, BaseLoader=None):
        """``self.meta`` is a ``{column: array}`` dict of the 'meta'
        table (a structured dataset or a group of columns)."""
        import h5py

        self.file_paths = expand_paths(file_paths)
        self._handles = [h5py.File(p, 'r') for p in self.file_paths]
        h0 = self._handles[0]
        meta_src = h0['meta']
        if isinstance(meta_src, h5py.Group):
            self.meta = {k: meta_src[k][:] for k in meta_src}
        else:
            table = meta_src[:]
            self.meta = {k: table[k] for k in table.dtype.names}

        tis = []
        for h in self._handles:
            if 'time_index' in h:
                ti = h['time_index'][:]
                ti = TimeIndex(
                    [t.decode()[:19] if isinstance(t, bytes) else str(t)
                     for t in ti])
                tis.append(ti)
        if tis and len(tis) != len(self._handles):
            raise ValueError(
                'Some H5 member files lack a time_index — cannot '
                'concatenate a mixed time-varying/time-independent '
                'file set along time')
        if len(tis) > 1:
            # member files arrive in FILENAME order (expand_paths
            # sorts lexically; 'wtk_10.h5' sorts before 'wtk_2.h5') —
            # reorder files to CHRONOLOGICAL order, same contract as
            # LoaderNCFlat._init_members
            order = sorted(range(len(tis)), key=lambda i: tis[i][0])
            tis = [tis[i] for i in order]
            self._handles = [self._handles[i] for i in order]
            self.file_paths = [self.file_paths[i] for i in order]
            h0 = self._handles[0]
        self.time_index = (TimeIndex(
            np.concatenate([t.values for t in tis]), unit=tis[0].unit)
            if tis else None)
        if self.time_index is not None and len(self.time_index) > 1:
            if (np.diff(self.time_index.values)
                    <= np.timedelta64(0)).any():
                raise ValueError(
                    'H5 member files have overlapping or '
                    'non-monotonic time ranges')

        self._vars = {}
        skip = {'meta', 'time_index', 'coordinates'}
        for name in h0:
            if name in skip or isinstance(h0[name], h5py.Group):
                continue
            dsets = [h[name] for h in self._handles if name in h]
            if h0[name].ndim >= 2 and len(dsets) != len(self._handles):
                # a time-varying dataset missing from some members
                # would be silently short along the concatenated time
                # axis (temporal misalignment); site-static 1D
                # datasets legitimately use a single copy
                raise ValueError(
                    f'Time-varying dataset "{name}" is missing in '
                    'some H5 member files — every member must carry '
                    'it for a time concatenation')
            scale = float(h0[name].attrs.get('scale_factor', 1.0))
            self._vars[standardize_var_name(name)] = _H5Var(
                dsets, scale,
                n_t_total=(len(self.time_index)
                           if self.time_index is not None else 1))
        if features != 'all' and features is not None:
            keep = {standardize_var_name(f) for f in features}
            self._vars = {k: v for k, v in self._vars.items()
                          if k in keep}

    @property
    def features(self):
        return list(self._vars)

    @property
    def lat_lon_flat(self):
        """(sites, 2) coordinates."""
        return np.column_stack([
            np.asarray(self.meta['latitude'], dtype=np.float32),
            np.asarray(self.meta['longitude'], dtype=np.float32)])

    @property
    def elevation(self):
        """(sites,) elevation if present in meta."""
        if 'elevation' in self.meta:
            return np.asarray(self.meta['elevation'], dtype=np.float32)
        return None

    def get(self, feature, time_slice=slice(None), gids=None):
        """(time, sites) float32 block for a feature."""
        f = standardize_var_name(feature)
        if f not in self._vars:
            raise KeyError(f'"{feature}" not in {self.features}')
        return self._vars[f].get(time_slice, gids)

    def close(self):
        for h in self._handles:
            h.close()


class _FlatNCVar:
    """Lazy (time, sites) accessor for one spatially-flattened NetCDF
    variable: per-file parts concatenated along time, with CF decode
    (scale_factor/add_offset, _FillValue -> NaN, K -> C) applied at
    read time. The NetCDF counterpart of ``_H5Var`` (which decodes
    rex-H5 scale-division semantics)."""

    def __init__(self, n_sites):
        self.n_sites = int(n_sites)
        #: (arr, time_first, scale, offset, fill, n_t) per member file
        self._parts = []
        #: the STORE's total time length (set by the loader once all
        #: member files are read) — sizes the site-static broadcast
        self.n_t_total = 1

    def add_part(self, arr, time_first, scale, offset, fill):
        n_t = 1 if arr.ndim == 1 else (
            arr.shape[0] if time_first else arr.shape[1])
        self._parts.append((arr, time_first, scale, offset, fill, n_t))

    @staticmethod
    def _decode(raw, scale, offset, fill):
        raw = np.asarray(raw)
        values = raw.astype(np.float32)
        # fill comparison happens in PACKED space (before scale/offset)
        if fill is not None and not np.isnan(fill):
            values = np.where(
                raw == np.asarray(fill).astype(raw.dtype), np.nan,
                values)
        if scale != 1.0 or offset != 0.0:
            values = values * np.float32(scale) + np.float32(offset)
        return values

    def get(self, time_slice=slice(None), gids=None):
        """(time, sites) float32 window — same contract (and the same
        multi-file time routing / gid-range read restriction) as
        ``_H5Var.get``, through the shared ``_route_time_reads``."""
        if all(p[0].ndim == 1 for p in self._parts):
            # site-static var: identical in every member file,
            # broadcast over the sliced time length
            arr, _, scale, offset, fill, _ = self._parts[0]
            raw = arr[:] if gids is None else arr[:][np.asarray(gids)]
            row = self._decode(raw, scale, offset, fill)
            # zero-copy broadcast view (see _H5Var.get)
            return np.broadcast_to(
                row[None],
                (_static_rows(self.n_t_total, time_slice), row.size))
        parts = [p for p in self._parts if p[0].ndim == 2]

        def read_block(k, sel):
            arr, time_first, scale, offset, fill, _ = parts[k]
            if gids is not None:
                # restrict the read to the [min, max] gid range (fast
                # contiguous slice; fancy-index only the local block)
                g = np.asarray(gids)
                lo, hi = int(g.min()), int(g.max()) + 1
                raw = (arr[sel, lo:hi][:, g - lo] if time_first
                       else arr[lo:hi, sel][g - lo, :].T)
            else:
                raw = arr[sel, :] if time_first else arr[:, sel].T
            return self._decode(raw, scale, offset, fill)

        n_cols = (len(np.asarray(gids)) if gids is not None
                  else self.n_sites)
        return _route_time_reads([p[5] for p in parts], time_slice,
                                 read_block, n_cols)


class LoaderNCFlat:
    """Spatially-flattened NetCDF loader: 1-D latitude/longitude over
    one shared spatial dim (a site list, e.g. station or unstructured
    output), per the reference's ``_is_flattened`` NC branch
    (reference sup3r/preprocessing/loaders/nc.py:73-80 loads these
    with a ``Dimension.FLATTENED_SPATIAL`` dim; tests/loaders/
    test_file_loading.py:181 ``test_load_flattened_nc``).

    Exposes the same sites interface as ``LoaderH5`` (``features`` /
    ``lat_lon_flat`` / ``elevation`` / ``get(feature, time_slice,
    gids)``), so the whole flattened-H5 machinery — raster-grid
    reconstruction (``infer_flat_grid``), gid-window reads, lazy
    training windows — applies to flattened NC unchanged, which goes
    beyond the reference (its standard rasterizer rejects flattened
    NC; rasterizers/base.py:2)."""

    def __init__(self, file_paths, features='all', res_kwargs=None,
                 chunks=None, BaseLoader=None, lazy=False):
        """``res_kwargs``/``chunks``/``BaseLoader`` are reference-
        config compat no-ops; ``lazy`` is accepted for interface
        parity (reads are windowed on demand either way)."""
        self.file_paths = expand_paths(file_paths)
        self._handles = []
        self._keep = (None if features in ('all', None)
                      else {standardize_var_name(f) for f in features})
        self._vars = {}
        self._lat_lon = None
        tis = []
        try:
            self._init_members(tis)
        except Exception:
            # any validation failure below must not leak the handles
            # already opened (retried loads in long-lived CLI node
            # processes would accumulate fds)
            self.close()
            raise

    def _init_members(self, tis):
        for path in self.file_paths:
            backend, handle = _nc_open(path)
            self._handles.append(handle)
            self._load_one(backend, handle, tis)
        n_files = len(self.file_paths)
        if tis and len(tis) != n_files:
            raise ValueError(
                'Some flattened NetCDF member files lack a time '
                'variable — cannot concatenate a mixed time-varying/'
                'time-independent file set along time')
        if len(tis) > 1:
            # member files arrive in FILENAME order (expand_paths
            # sorts lexically) — reorder to CHRONOLOGICAL order and
            # fail loudly on overlap, like LoaderNC._merge does for
            # gridded multi-file loads
            order = sorted(range(n_files), key=lambda i: tis[i][0])
            tis = [tis[i] for i in order]
            for name, var in self._vars.items():
                if all(p[0].ndim == 1 for p in var._parts):
                    continue  # site-static: first file's copy
                if (len(var._parts) != n_files
                        or any(p[0].ndim != 2 for p in var._parts)):
                    raise ValueError(
                        f'Time-varying variable "{name}" is missing '
                        '(or site-static) in some flattened member '
                        'files — every member must carry it for a '
                        'time concatenation')
                var._parts = [var._parts[i] for i in order]
        self.time_index = (TimeIndex(
            np.concatenate([t.values for t in tis]), unit=tis[0].unit)
            if tis else None)
        if self.time_index is not None and len(self.time_index) > 1:
            if (np.diff(self.time_index.values)
                    <= np.timedelta64(0)).any():
                raise ValueError(
                    'Flattened NetCDF member files have overlapping '
                    'or non-monotonic time ranges')
        for var in self._vars.values():
            var.n_t_total = (len(self.time_index)
                             if self.time_index is not None else 1)

    def _load_one(self, backend, handle, tis):
        raw = _nc_vars(backend, handle)
        lower = {k.lower(): k for k in raw}

        def get_coord(*names):
            for n in names:
                if n in lower:
                    return raw[lower[n]]
            return None

        lat = get_coord(*_LAT_COORD_NAMES)
        lon = get_coord(*_LON_COORD_NAMES)
        time = get_coord('time', 'valid_time', 'xtime')
        assert lat is not None and lon is not None, 'No lat/lon found'
        space_dim = lat[0][0]
        lat_vals = np.asarray(lat[1][:], dtype=np.float32)
        lon_vals = np.asarray(lon[1][:], dtype=np.float32)
        if (lon_vals > 180.0).any():
            lon_vals = (lon_vals + 180.0) % 360.0 - 180.0
        ll = np.column_stack([lat_vals, lon_vals])
        if self._lat_lon is None:
            self._lat_lon = ll
        elif not np.array_equal(self._lat_lon, ll):
            raise ValueError(
                'Flattened NetCDF member files have mismatched site '
                'lists — multi-file loads concatenate along time on '
                'ONE site list')
        if time is not None:
            tis.append(_decode_time_index(time[1], time[2]))
        time_dim = None if time is None else time[0][0]
        coord_names = {lower.get(n) for n in (
            *_LAT_COORD_NAMES, *_LON_COORD_NAMES, 'time', 'valid_time',
            'xtime')}
        for name, (dims, arr, attrs) in raw.items():
            if name in coord_names or name.lower() in _IGNORE_VARS:
                continue
            if name == space_dim:
                # the spatial dim's own coordinate/scale dataset (a
                # site index, or netCDF's "dimension but not a
                # variable" placeholder) is not a feature
                continue
            if space_dim not in dims:
                continue
            extra = [d for d in dims if d not in (space_dim, time_dim)]
            if extra:
                logger.debug(
                    'Skipping flattened variable "%s" with '
                    'non-canonical dim(s) %s', name, extra)
                continue
            std = standardize_var_name(name)
            if self._keep is not None and std not in self._keep:
                continue
            # CF packing: apply EITHER attribute when present (see
            # the gridded loader above — add_offset is legal alone)
            scale = float(np.asarray(
                attrs.get('scale_factor', 1.0)).ravel()[0])
            offset = float(np.asarray(
                attrs.get('add_offset', 0.0)).ravel()[0])
            units = attrs.get('units')
            if isinstance(units, bytes):
                units = units.decode()
            if str(units) == 'K':
                # standardize temperatures to Celsius (reference:
                # loaders/utilities.py:23-25)
                offset -= 273.15
            fill = attrs.get('_FillValue', attrs.get('missing_value'))
            fv = (float(np.asarray(fill).ravel()[0])
                  if fill is not None else None)
            time_first = arr.ndim == 2 and dims[0] == time_dim
            var = self._vars.setdefault(std, _FlatNCVar(len(ll)))
            if arr.ndim == 1 and any(
                    p[0].ndim == 1 for p in var._parts):
                continue  # site-static var: first file's copy wins
            var.add_part(arr, time_first, scale, offset, fv)

    @property
    def features(self):
        return list(self._vars)

    @property
    def lat_lon_flat(self):
        """(sites, 2) coordinates."""
        return self._lat_lon

    @property
    def elevation(self):
        """(sites,) elevation when a site-static topography variable
        is present (the NC analogue of the H5 meta elevation column)."""
        var = self._vars.get('topography')
        if var is not None and any(p[0].ndim == 1 for p in var._parts):
            return var.get()[0]
        return None

    def get(self, feature, time_slice=slice(None), gids=None):
        """(time, sites) float32 block for a feature."""
        f = standardize_var_name(feature)
        if f not in self._vars:
            raise KeyError(f'"{feature}" not in {self.features}')
        return self._vars[f].get(time_slice, gids)

    def close(self):
        for h in self._handles:
            h.close()
        self._handles = []


def Loader(file_paths, features='all', **kwargs):
    """Factory: pick LoaderH5/LoaderNC/LoaderNCFlat by file type and
    spatial layout (reference: sup3r/preprocessing/loaders/__init__.py;
    flattened detection per nc.py:73-80)."""
    if get_source_type(file_paths) == 'h5':
        return LoaderH5(file_paths, features=features, **kwargs)
    paths = expand_paths(file_paths)
    if paths and nc_is_flattened(paths[0]):
        return LoaderNCFlat(file_paths, features=features, **kwargs)
    return LoaderNC(file_paths, features=features, **kwargs)
