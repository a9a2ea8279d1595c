"""Output handlers: high-res grid/time synthesis, u/v inversion,
physical limits, atomic chunk-file writes.

Reference parity: sup3r/writers/base.py (pad_lat_lon :348, get_lat_lon
:434, get_times :510, invert_uv handling :232-346), h5.py, nc.py. The
port's copy of ``sup3r_tpu/postprocessing/writers.py``: NetCDF through
scipy, H5 through h5py imported where an H5 file is written, times on
the pandas-free ``TimeIndex``.
"""

import logging
import os

import numpy as np
from scipy.interpolate import griddata

import sup3r_tpu_torch
from sup3r_tpu_torch.names import uv_height_pairs
from sup3r_tpu_torch.ops.wind import invert_uv
from sup3r_tpu_torch.utilities import (
    TimeIndex,
    enforce_limits,
    get_dset_attrs,
    safe_serialize,
)
from sup3r_tpu_torch.utilities.times import (
    date_range,
    floor_step,
    format_timestamps,
    seconds_since,
)

logger = logging.getLogger(__name__)


def write_nc_file(out_file, times, lat2d, lon2d, feature_arrays,
                  meta_attr=None):
    """Atomic tmp+rename write of ``{feature: (time, south_north,
    west_east)}`` cubes with 2D coords to a classic NetCDF file — the
    ONE NetCDF writing path, shared by ``OutputHandlerNC`` and
    ``CollectorNC`` (scipy netcdf_file; this image has no netCDF4)."""
    from scipy.io import netcdf_file

    tmp = out_file + '.tmp'
    os.makedirs(os.path.dirname(os.path.abspath(out_file)),
                exist_ok=True)
    lat2d = np.asarray(lat2d)
    # version=2 (64-bit offset): the classic-format ~2 GiB
    # per-variable limit would fail a year-of-hourly collected cube
    # at the very end of the pipeline
    with netcdf_file(tmp, 'w', version=2) as f:
        f.createDimension('time', len(times))
        f.createDimension('south_north', lat2d.shape[0])
        f.createDimension('west_east', lat2d.shape[1])
        v = f.createVariable('time', 'f8', ('time',))
        v[:] = seconds_since(times, '1970-01-01') / 3600.0
        v.units = b'hours since 1970-01-01'
        f.createVariable('latitude', 'f4',
                         ('south_north', 'west_east'))[:] = lat2d
        f.createVariable('longitude', 'f4',
                         ('south_north', 'west_east'))[:] = lon2d
        for feat, arr in feature_arrays.items():
            var = f.createVariable(
                feat, 'f4', ('time', 'south_north', 'west_east'))
            var[:] = arr
        if meta_attr is not None:
            f.gan_meta = (meta_attr.encode()
                          if isinstance(meta_attr, str) else meta_attr)
    os.replace(tmp, out_file)
    return out_file


class OutputHandler:
    """Base output handler: grid/time synthesis + feature transforms."""

    @staticmethod
    def pad_lat_lon(lat_lon):
        """Pad a lat/lon grid by one extrapolated ring (reference:
        writers/base.py:348)."""
        padded = np.zeros((lat_lon.shape[0] + 2, lat_lon.shape[1] + 2, 2))
        padded[1:-1, 1:-1] = lat_lon

        left = padded[:, 2, 1] - padded[:, 1, 1]
        right = padded[:, -2, 1] - padded[:, -3, 1]
        top = padded[1, :, 0] - padded[2, :, 0]
        bottom = padded[-3, :, 0] - padded[-2, :, 0]

        padded[:, 0, 1] = padded[:, 1, 1] - left
        padded[:, 0, 0] = padded[:, 1, 0]
        padded[:, -1, 1] = padded[:, -2, 1] + right
        padded[:, -1, 0] = padded[:, -2, 0]
        padded[0, :, 0] = padded[1, :, 0] + top
        padded[0, :, 1] = padded[1, :, 1]
        padded[-1, :, 0] = padded[-2, :, 0] - bottom
        padded[-1, :, 1] = padded[-2, :, 1]

        padded[0, 0] = (padded[0, 1, 0], padded[1, 0, 1])
        padded[0, -1] = (padded[0, -2, 0], padded[1, -1, 1])
        padded[-1, 0] = (padded[-1, 1, 0], padded[-2, 0, 1])
        padded[-1, -1] = (padded[-1, -2, 0], padded[-2, -1, 1])
        return padded

    @staticmethod
    def is_increasing_lons(lat_lon):
        """False if any row's longitudes wrap through 180 -> -180."""
        return not bool(
            (lat_lon[:, -1, 1] < lat_lon[:, 0, 1]).any())

    @classmethod
    def get_lat_lon(cls, low_res_lat_lon, shape, method='bilinear'):
        """Remesh of the (padded) low-res grid onto the high-res grid,
        handling the 180-degree wrap (reference: writers/base.py:434).

        method='bilinear' (default) exploits that the padded source
        grid is REGULAR in index space, so separable bilinear
        interpolation replaces the reference's O(N log N) Delaunay
        griddata — orders of magnitude faster on continental grids
        and equal to griddata wherever the coordinate fields are
        locally planar (they are, away from strong map-projection
        curvature). method='griddata' reproduces the reference
        exactly."""
        low_res_lat_lon = np.array(low_res_lat_lon, dtype=np.float64)
        assert low_res_lat_lon.shape[0] > 1 and (
            low_res_lat_lon.shape[1] > 1), (
            'low res lat/lon needs >= 2 rows and columns')
        low_res_lat_lon[..., 1] = (low_res_lat_lon[..., 1] + 180) % 360 \
            - 180
        if not cls.is_increasing_lons(low_res_lat_lon):
            low_res_lat_lon[..., 1] = (low_res_lat_lon[..., 1] + 360) \
                % 360
        padded = cls.pad_lat_lon(low_res_lat_lon)

        lr_y, lr_x = low_res_lat_lon.shape[:2]
        hr_y, hr_x = shape

        def cells(n):
            # arange(0, 10, 10/n) returns n+1 points when 10/n rounds
            # down (n = 61, 77, 122, ...) — same float-arange bug
            # fixed in ops/interp._axis_points; the reference crashes
            # loudly on those grid sizes
            return np.arange(n) * (10 / n) + 5 / n

        y = cells(lr_y)
        x = cells(lr_x)
        y = np.concatenate([[y[0] - 10 / lr_y], y, [y[-1] + 10 / lr_y]])
        x = np.concatenate([[x[0] - 10 / lr_x], x, [x[-1] + 10 / lr_x]])
        new_y = cells(hr_y)
        new_x = cells(hr_x)

        if method == 'bilinear':
            from scipy.interpolate import RegularGridInterpolator

            pts_y, pts_x = np.meshgrid(new_y, new_x, indexing='ij')
            query = np.column_stack([pts_y.ravel(), pts_x.ravel()])
            lat_i = RegularGridInterpolator((y, x), padded[..., 0])
            lon_i = RegularGridInterpolator((y, x), padded[..., 1])
            new_lats = lat_i(query)
            new_lons = lon_i(query)
        else:
            lats = padded[..., 0].ravel()
            lons = padded[..., 1].ravel()
            X, Y = np.meshgrid(x, y, copy=False)
            old = np.column_stack([Y.ravel(), X.ravel()]).astype(
                np.float32)
            X, Y = np.meshgrid(new_x, new_y, copy=False)
            new = np.column_stack([Y.ravel(), X.ravel()]).astype(
                np.float32)
            new_lons = griddata(old, lons, new)
            new_lats = griddata(old, lats, new)
        new_lons = (new_lons + 180) % 360 - 180
        return np.dstack([new_lats.reshape(shape),
                          new_lons.reshape(shape)])

    @staticmethod
    def get_times(low_res_times, shape):
        """Synthesize the high-res time index, dropping leap days when
        the low-res index has none (reference: writers/base.py:510)."""
        low_res_times = TimeIndex(low_res_times)
        if len(low_res_times) > 1:
            offset = low_res_times[1] - low_res_times[0]
        else:
            offset = np.timedelta64(1, 'D').astype('timedelta64[ns]')
        t_enhance = int(shape / len(low_res_times))
        # the step floors at the input's resolution, as pandas' Timedelta
        # division does (microseconds for a decoded or parsed index)
        freq = floor_step(offset // t_enhance, low_res_times.unit)
        times = date_range(low_res_times[0], low_res_times[-1] + offset,
                           freq=freq, unit=low_res_times.unit)[:-1]
        has_leap = bool(((low_res_times.month == 2)
                         & (low_res_times.day == 29)).any())
        if not has_leap:
            mask = (times.month == 2) & (times.day == 29)
            times = times[~mask]
        assert len(times) == shape, (
            f'Synthesized {len(times)} high-res times, expected {shape}')
        return times

    @classmethod
    def get_renamed_features(cls, features):
        """u_Xm/v_Xm pairs become windspeed_Xm/winddirection_Xm in output
        files (reference: writers/base.py:195). Raises ValueError for
        u-like features with no canonical pair (same loud outcome as the
        reference's ``features.index``)."""
        out = list(features)
        for h, ui, vi in uv_height_pairs(features):
            out[ui] = f'windspeed_{h}m'
            out[vi] = f'winddirection_{h}m'
        return out

    @classmethod
    def invert_uv_features(cls, data, features, lat_lon,
                           max_workers=None):
        """In-place u/v -> ws/wd inversion for all height pairs.

        data: (s1, s2, t, f)."""
        pairs = uv_height_pairs(features)

        def one(pair):
            _, ui, vi = pair
            ws, wd = invert_uv(data[..., ui], data[..., vi], lat_lon)
            data[..., ui] = ws
            data[..., vi] = wd

        if max_workers == 1 or len(pairs) <= 1:
            for p in pairs:
                one(p)
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=max_workers) as pool:
                list(pool.map(one, pairs))
        return cls.get_renamed_features(features)

    @classmethod
    def _transform_output(cls, data, features, lat_lon,
                          max_workers=None, invert_uv=True,
                          nn_fill=False):
        """Full output transform: invert winds + enforce limits.
        ``invert_uv=False`` writes raw u/v; ``nn_fill=True`` NN-fills
        out-of-range values instead of clipping (reference:
        strategy.py invert_uv/nn_fill options).

        Mutates ``data`` in place; read-only views are copied first so
        the shared write entry point never crashes on an unwritable
        buffer."""
        data = np.asarray(data, dtype=np.float32)
        if not data.flags.writeable:
            data = data.copy()
        if invert_uv:
            features = cls.invert_uv_features(data, features, lat_lon,
                                              max_workers)
        data = enforce_limits(features, data, nn_fill=nn_fill)
        return data, features

    @classmethod
    def write_output(cls, data, features, low_res_lat_lon,
                     low_res_times, out_file, meta_data=None,
                     max_workers=None, gids=None):
        """Synthesize HR coords + transform + write (reference:
        writers/base.py:303-346)."""
        lat_lon = cls.get_lat_lon(low_res_lat_lon, data.shape[:2])
        times = cls.get_times(low_res_times, data.shape[2])
        cls._write_output(data, features, lat_lon, times, out_file,
                          meta_data=meta_data, max_workers=max_workers,
                          gids=gids)

    @classmethod
    def _write_output(cls, data, features, lat_lon, times, out_file,
                      meta_data=None, max_workers=None, gids=None):
        raise NotImplementedError


class OutputHandlerH5(OutputHandler):
    """Write chunk output to a rex-style flattened H5 file (needs
    h5py)."""

    @classmethod
    def _write_output(cls, data, features, lat_lon, times, out_file,
                      meta_data=None, max_workers=None, gids=None,
                      invert_uv=True, nn_fill=False):
        data, features = cls._transform_output(
            np.asarray(data, dtype=np.float32), list(features), lat_lon,
            max_workers, invert_uv=invert_uv, nn_fill=nn_fill)
        s1, s2, t = data.shape[:3]
        arrays = []
        for i, feat in enumerate(features):
            attrs, dtype = get_dset_attrs(feat)
            flat = data[..., i].reshape(s1 * s2, t).T
            scale = attrs.get('scale_factor', 1.0)
            arrays.append(np.round(flat * scale).astype(dtype)
                          if 'int' in str(dtype) else flat.astype(dtype))
        cls._write_h5(arrays, features, lat_lon, times, out_file,
                      meta_data=meta_data, gids=gids)

    @classmethod
    def _write_packed(cls, arrays, features, lat_lon, times, out_file,
                      meta_data=None, gids=None):
        """Write ALREADY storage-quantized per-feature ``(t, n_sites)``
        arrays (device-packed by ops/output_pack.py: u/v inversion,
        limits, round(x*scale) and dtype conversion all done on
        device). ``features`` are the FINAL storage names (windspeed/
        winddirection after inversion)."""
        for feat, arr in zip(features, arrays):
            _, dtype = get_dset_attrs(feat)
            if str(arr.dtype) != str(np.dtype(dtype)):
                raise TypeError(
                    f'Packed array for "{feat}" is {arr.dtype}; its '
                    f'storage dtype is {dtype}')
        cls._write_h5(list(arrays), list(features), lat_lon, times,
                      out_file, meta_data=meta_data, gids=gids)

    @classmethod
    def _write_h5(cls, arrays, features, lat_lon, times, out_file,
                  meta_data=None, gids=None):
        """Assemble the rex-style H5 from final ``(t, n_sites)``
        storage arrays (atomic tmp+rename)."""
        s1, s2 = np.asarray(lat_lon).shape[:2]
        if gids is None:
            gids = np.arange(s1 * s2).reshape(s1, s2)
        import h5py

        tmp = out_file + '.tmp'
        os.makedirs(os.path.dirname(os.path.abspath(out_file)),
                    exist_ok=True)
        with h5py.File(tmp, 'w') as f:
            meta = np.zeros(s1 * s2, dtype=[('latitude', 'f4'),
                                            ('longitude', 'f4'),
                                            ('gid', 'i4')])
            meta['latitude'] = lat_lon[..., 0].ravel()
            meta['longitude'] = lat_lon[..., 1].ravel()
            meta['gid'] = np.asarray(gids).ravel()
            f.create_dataset('meta', data=meta)
            f.create_dataset('time_index', data=np.array(
                [ts.encode() for ts in format_timestamps(times)]))
            for feat, arr in zip(features, arrays):
                attrs, _ = get_dset_attrs(feat)
                ds = f.create_dataset(feat, data=arr)
                for k, v in attrs.items():
                    ds.attrs[k] = v
            f.attrs['version_record'] = safe_serialize(
                {'sup3r_tpu_torch': sup3r_tpu_torch.__version__})
            if meta_data is not None:
                f.attrs['gan_meta'] = safe_serialize(meta_data)
        os.replace(tmp, out_file)
        logger.info('Wrote output file %s', out_file)


class OutputHandlerNC(OutputHandler):
    """Write chunk output to a NetCDF3 file (scipy backend; gridded
    (time, lat, lon) variables)."""

    @classmethod
    def _write_output(cls, data, features, lat_lon, times, out_file,
                      meta_data=None, max_workers=None, gids=None,
                      invert_uv=False, nn_fill=False):
        # NC output keeps raw u/v by default (gridded intermediate
        # chunks feed downstream models, not rex consumers) but still
        # enforces physical limits like the reference NC writer
        # (reference: tests/output/test_output_handling.py:240-259
        # caps clearsky_ratio to [0, 1] through _write_output)
        data, features = cls._transform_output(
            np.asarray(data, dtype=np.float32), list(features),
            lat_lon, max_workers, invert_uv=invert_uv,
            nn_fill=nn_fill)
        data = np.asarray(data, dtype=np.float32)
        write_nc_file(
            out_file, TimeIndex(times), lat_lon[..., 0],
            lat_lon[..., 1],
            {feat: np.transpose(data[..., i], (2, 0, 1))
             for i, feat in enumerate(features)},
            meta_attr=(safe_serialize(meta_data)
                       if meta_data is not None else None))
        logger.info('Wrote output file %s', out_file)
