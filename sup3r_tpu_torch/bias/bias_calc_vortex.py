"""Vortex monthly-mean preparation + monthly bias factor application.

The port's copy of ``sup3r_tpu/bias/bias_calc_vortex.py`` on the
pandas-free ``TimeIndex``. It reads TIFs through PIL and writes H5
through h5py, both imported where used: it runs on a machine that has
them, and the rest of the package imports without them.
Reference parity: sup3r/bias/bias_calc_vortex.py:27-538
(VortexMeanPrepper: monthly Vortex TIF mean windspeeds -> h5 of monthly
means with height interpolation; BiasCorrectUpdate: apply monthly
scalar factors to final output h5 files). TIFs are read with PIL
(instead of rasterio, which is not a dependency here).
"""

import calendar
import logging
import os

import numpy as np

from sup3r_tpu_torch.ops.interp import interp_to_level
from sup3r_tpu_torch.utilities.times import (
    TimeIndex,
    format_timestamps,
    timestamp,
)

logger = logging.getLogger(__name__)


class VortexMeanPrepper:
    """Convert monthly Vortex mean-windspeed TIFs (per height) into one
    h5 of monthly means, interpolating to requested output heights."""

    def __init__(self, path_pattern, in_heights, out_heights,
                 overwrite=False):
        """path_pattern: like './{month}/vortex_{height}m.tif' with
        {month} (full month name) and {height} format keys."""
        self.path_pattern = path_pattern
        self.in_heights = list(in_heights)
        self.out_heights = list(out_heights)
        self.overwrite = overwrite
        self._lat_lon = None
        self._nodata = None

    @property
    def in_features(self):
        return [f'windspeed_{h}m' for h in self.in_heights]

    @property
    def out_features(self):
        return [f'windspeed_{h}m' for h in self.out_heights]

    def get_input_file(self, month, height):
        """TIF path for a month name + height."""
        return self.path_pattern.format(month=month, height=height)

    @staticmethod
    def read_tif(fp, with_geo=False):
        """(rows, cols) float32 array from a TIF file (PIL). With
        ``with_geo``, also returns (lat_grid, lon_grid, nodata) built
        from the GeoTIFF ModelTiepoint/ModelPixelScale tags, a .tfw
        world file, or None when neither exists (reference reads these
        through rioxarray, bias_calc_vortex.py:124-155)."""
        from PIL import Image

        with Image.open(fp) as im:
            arr = np.array(im, dtype=np.float32)
            if not with_geo:
                return arr
            tags = getattr(im, 'tag_v2', {}) or {}
        nodata = None
        if 42113 in tags:  # GDAL_NODATA ascii tag
            try:
                nodata = float(str(tags[42113]).strip('\x00 '))
            except ValueError:
                nodata = None
        geo = None
        if 33550 in tags and 33922 in tags:
            # ModelPixelScale (sx, sy, _) + ModelTiepoint
            # (i, j, _, x, y, _): pixel (col, row) -> x0 + col*sx,
            # y0 - row*sy (north-up rasters)
            sx, sy = float(tags[33550][0]), float(tags[33550][1])
            tp = tags[33922]
            x0, y0 = float(tp[3]) - float(tp[0]) * sx, \
                float(tp[4]) + float(tp[1]) * sy
            geo = (x0, sx, 0.0, y0, 0.0, -sy)
        else:
            tfw = os.path.splitext(fp)[0] + '.tfw'
            if os.path.exists(tfw):
                with open(tfw) as f:
                    a, d, b, e, c, fy = [float(x)
                                         for x in f.read().split()[:6]]
                # world files anchor the CENTER of the top-left pixel;
                # shift to the corner so the shared +0.5 pixel-center
                # offset below applies uniformly
                geo = (c - 0.5 * (a + b), a, b,
                       fy - 0.5 * (d + e), d, e)
        if geo is None:
            return arr, None, None, nodata
        x0, dx, rx, y0, ry, dy = geo
        rows, cols = arr.shape
        cc, rr = np.meshgrid(np.arange(cols), np.arange(rows))
        # pixel centers (the +0.5 cell offset matches GDAL convention)
        lon = x0 + (cc + 0.5) * dx + (rr + 0.5) * rx
        lat = y0 + (cc + 0.5) * ry + (rr + 0.5) * dy
        return arr, lat.astype(np.float32), lon.astype(np.float32), \
            nodata

    def get_month(self, month):
        """(rows, cols, n_in_heights) stack of monthly means; the
        first read also captures the grid's lat/lon + nodata mask."""
        stack = []
        for h in self.in_heights:
            fp = self.get_input_file(month, h)
            if self._lat_lon is None:
                arr, lat, lon, nodata = self.read_tif(fp, with_geo=True)
                if lat is not None:
                    self._lat_lon = np.dstack([lat, lon])
                self._nodata = nodata
            else:
                arr = self.read_tif(fp)
            if self._nodata is not None:
                arr = np.where(arr == self._nodata, np.nan, arr)
            stack.append(arr)
        return np.stack(stack, axis=-1)

    def interp(self, data):
        """Interpolate (rows, cols, n_in) to the out heights by linear
        level interpolation (log-law consistent for wind means)."""
        lev = np.broadcast_to(
            np.asarray(self.in_heights, dtype=np.float32), data.shape)
        out = []
        for h in self.out_heights:
            if h in self.in_heights:
                out.append(data[..., self.in_heights.index(h)])
            else:
                out.append(np.asarray(interp_to_level(
                    lev, data, np.float32(h), method='log')))
        return np.stack(out, axis=-1)

    def get_all_data(self):
        """{feature: (12, rows, cols)} monthly mean stacks."""
        months = [calendar.month_name[m] for m in range(1, 13)]
        per_month = [self.interp(self.get_month(m)) for m in months]
        out = {}
        for i, feat in enumerate(self.out_features):
            out[feat] = np.stack([pm[..., i] for pm in per_month])
        return out

    def write_data(self, fp_out, out):
        """Write monthly means to a rex-style h5: (12, sites) datasets
        + a 'meta' latitude/longitude table (from the TIF GeoTIFF tags
        or world file) so the file serves directly as ``base_fps`` for
        the bias calculators (reference: bias_calc_vortex.py:301-316
        writes through RexOutputs). Fill-value sites are dropped like
        the reference's mask (:144-157)."""
        if os.path.exists(fp_out) and not self.overwrite:
            logger.info('%s exists, skipping', fp_out)
            return fp_out
        tmp = fp_out + '.tmp'
        os.makedirs(os.path.dirname(os.path.abspath(fp_out)),
                    exist_ok=True)
        flat = {feat: arr.reshape(12, -1).astype(np.float32)
                for feat, arr in out.items()}
        valid = np.ones(next(iter(flat.values())).shape[1], dtype=bool)
        for arr in flat.values():
            valid &= np.isfinite(arr).all(axis=0)
        import h5py

        with h5py.File(tmp, 'w') as f:
            f.create_dataset('time_index', data=np.array([
                t.encode() for t in format_timestamps(
                    [timestamp(f'2000-{m:02d}-15') for m in range(1, 13)])]))
            if self._lat_lon is not None:
                ll = self._lat_lon.reshape(-1, 2)[valid]
                meta = np.rec.fromarrays(
                    [ll[:, 0].astype(np.float32),
                     ll[:, 1].astype(np.float32)],
                    names='latitude,longitude')
                f.create_dataset('meta', data=meta)
            else:
                logger.warning(
                    'No geo-referencing found in the vortex TIFs '
                    '(GeoTIFF tags or .tfw world files); writing '
                    'without a meta table')
                valid[:] = True
            for feat, arr in flat.items():
                f.create_dataset(feat, data=arr[:, valid])
                f[feat].attrs['shape'] = out[feat].shape[1:]
        os.replace(tmp, fp_out)
        logger.info('Wrote vortex monthly means to %s (%d/%d valid '
                    'sites)', fp_out, int(valid.sum()), valid.size)
        return fp_out

    @classmethod
    def run(cls, path_pattern, in_heights, out_heights, fp_out,
            overwrite=False):
        """Full TIF -> monthly-mean h5 conversion."""
        prepper = cls(path_pattern, in_heights, out_heights,
                      overwrite=overwrite)
        return prepper.write_data(fp_out, prepper.get_all_data())


class BiasCorrectUpdate:
    """Apply monthly scalar bias factors to a final output h5 file
    (reference: bias_calc_vortex.py:352-538)."""

    @classmethod
    def get_bc_factors(cls, bc_file, dset, month, global_scalar=1):
        """(sites,) factors for one month from a bc factor file with a
        '{dset}_scalar' dataset shaped (..., 12)."""
        import h5py

        with h5py.File(bc_file, 'r') as f:
            arr = f[f'{dset}_scalar'][:]
        if arr.ndim == 3:
            arr = arr.reshape(-1, arr.shape[-1])
        return global_scalar * arr[:, month - 1]

    @classmethod
    def update_file(cls, in_file, out_file, dset, bc_file,
                    global_scalar=1, max_workers=None):
        """Copy in_file to out_file with monthly factors applied to
        ``dset`` (stored scaled ints handled transparently).
        ``max_workers`` is accepted for reference-config compatibility
        — the monthly update here is one vectorized in-memory pass,
        not the reference's per-month dask graph."""
        import shutil

        import h5py

        tmp = out_file + '.tmp'
        shutil.copyfile(in_file, tmp)
        with h5py.File(tmp, 'r+') as f:
            ti = TimeIndex([t.decode()[:26] for t in f['time_index'][:]])
            scale = float(f[dset].attrs.get('scale_factor', 1.0))
            data = f[dset][:].astype(np.float32) / scale
            for month in range(1, 13):
                mask = ti.month == month
                if not mask.any():
                    continue
                factors = cls.get_bc_factors(bc_file, dset, month,
                                             global_scalar)
                data[mask] = data[mask] * factors[None, :]
            dtype = f[dset].dtype
            if np.issubdtype(dtype, np.integer):
                f[dset][:] = np.round(data * scale).astype(dtype)
            else:
                f[dset][:] = data.astype(dtype)
        os.replace(tmp, out_file)
        logger.info('Wrote bias-corrected %s to %s', dset, out_file)
        return out_file

    @classmethod
    def run(cls, in_file, out_file, dset, bc_file, global_scalar=1,
            max_workers=None, overwrite=False):
        """Idempotent update_file."""
        if os.path.exists(out_file) and not overwrite:
            logger.info('%s exists, skipping', out_file)
            return out_file
        return cls.update_file(in_file, out_file, dset, bc_file,
                               global_scalar=global_scalar,
                               max_workers=max_workers)
