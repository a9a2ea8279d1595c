"""Fake data for tests and on-card runs of the port (the counterparts
of ``make_fake_dset`` and ``make_fake_nc_file`` in
``sup3r_tpu/utilities/test_helpers.py``): an in-memory GridDataset, and
NetCDF3 through scipy, without pandas, so the card's machine can make its
own input."""

import numpy as np

from sup3r_tpu_torch.preprocessing.grid import GridDataset
from sup3r_tpu_torch.utilities import RANDOM_GENERATOR
from sup3r_tpu_torch.utilities.times import (
    date_range,
    seconds_since,
    timestamp,
)


def _time_index(start, freq, t):
    """``t`` timestamps from ``start`` every ``freq`` (a numpy timedelta
    unit such as 'h', or a ``timedelta64``)."""
    step = (freq if isinstance(freq, np.timedelta64)
            else np.timedelta64(1, freq))
    t0 = timestamp(start)
    return date_range(t0, t0 + (t - 1) * step, step)


def make_fake_dset(shape, features, start='2023-01-01', freq='h',
                   smooth=True, lat_range=(40.0, 39.0),
                   lon_range=(-105.5, -104.3)):
    """Random-but-smooth GridDataset of the given (s1, s2, t) shape,
    drawn from ``RANDOM_GENERATOR`` as the JAX package's helper draws
    it (the same seed gives the same data)."""
    s1, s2, t = shape
    lat = np.linspace(lat_range[0], lat_range[1], s1)
    lon = np.linspace(lon_range[0], lon_range[1], s2)
    lat_lon = np.dstack(np.meshgrid(lat, lon, indexing='ij'))
    data = RANDOM_GENERATOR.random((s1, s2, t, len(features))).astype(
        np.float32)
    if smooth:
        # cheap spatial smoothing so derivatives/coarsening are non-trivial
        for _ in range(2):
            data = 0.5 * data + 0.25 * (
                np.roll(data, 1, axis=0) + np.roll(data, 1, axis=1))
    return GridDataset(data, features, lat_lon=lat_lon,
                       time_index=_time_index(start, freq, t))


def make_fake_nc_file(path, shape, features, start='2023-01-01',
                      freq='h', levels=None, ascending_lats=False,
                      lat_range=(40.0, 39.0), lon_range=(-105.5, -104.3),
                      data=None):
    """Write a NetCDF3 file (via scipy) with (time[, level], lat, lon)
    variables — the shape convention of raw ERA5/GCM files. ``freq`` is
    a numpy timedelta unit ('h' hourly) or a ``timedelta64``. Values
    come from ``RANDOM_GENERATOR`` in U(0, 1), as the JAX package's
    helper draws them, unless ``data`` maps a feature to its array of
    the variable's shape."""
    from scipy.io import netcdf_file

    s1, s2, t = shape
    lat0, lat1 = lat_range if not ascending_lats else lat_range[::-1]
    lat = np.linspace(lat0, lat1, s1)
    lon = np.linspace(*lon_range, s2)
    time_index = _time_index(start, freq, t)
    hours = seconds_since(time_index, '1900-01-01') / 3600

    with netcdf_file(path, 'w') as f:
        f.createDimension('time', t)
        f.createDimension('lat', s1)
        f.createDimension('lon', s2)
        dims = ('time', 'lat', 'lon')
        if levels is not None:
            f.createDimension('level', len(levels))
            dims = ('time', 'level', 'lat', 'lon')
        v = f.createVariable('time', 'f8', ('time',))
        v[:] = hours
        v.units = b'hours since 1900-01-01'
        v.calendar = b'standard'
        f.createVariable('lat', 'f4', ('lat',))[:] = lat
        f.createVariable('lon', 'f4', ('lon',))[:] = lon
        if levels is not None:
            f.createVariable('level', 'f4', ('level',))[:] = np.asarray(
                levels, dtype=np.float32)
        for feat in features:
            shape_full = ((t, s1, s2) if levels is None
                          else (t, len(levels), s1, s2))
            arr = (data[feat] if data is not None and feat in data
                   else RANDOM_GENERATOR.random(shape_full))
            var = f.createVariable(feat, 'f4', dims)
            var[:] = np.asarray(arr, dtype=np.float32)
    return path
