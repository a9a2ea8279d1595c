"""Feature cache: write derived GridDatasets to per-feature H5 or
NetCDF files with atomic tmp+rename, reload on cache hit.

Reference parity: sup3r/writers/cachers.py:35-592 (Cacher incl.
write_h5/write_netcdf, per-feature chunk specs, scale_factor attrs,
max_workers threaded writes, overwrite), sup3r/writers/utilities.py:9
(_check_for_cache). The port's copy of
``sup3r_tpu/postprocessing/cachers.py`` on the pandas-free
``TimeIndex``. Both cache formats are HDF5 files written through h5py
(the NetCDF one NetCDF4-style, with dimension scales), so caching runs
where h5py is installed: h5py is imported when a cache is written or
read. Features live in separate files (the cache_pattern contract), so
``max_workers`` parallelizes across feature FILES with independent
h5py handles.
"""

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from glob import glob

import numpy as np

from sup3r_tpu_torch.names import get_feature_basename
from sup3r_tpu_torch.preprocessing.grid import GridDataset
from sup3r_tpu_torch.utilities.times import (
    TimeIndex,
    seconds_since,
    to_datetime64,
)

logger = logging.getLogger(__name__)

#: canonical on-disk dim order for cached 3D feature blocks
DIM_ORDER = ('south_north', 'west_east', 'time')


def parse_chunks(feature, chunks, shape):
    """Resolve a user chunk spec to an h5py ``chunks`` argument.

    Accepts a global tuple, a global dims-dict, or a per-feature dict
    of dims-dicts (reference: cachers.py:221-236). Dims-dicts use the
    canonical (south_north, west_east, time) names; missing dims fall
    back to h5py auto-chunking (``True``). Chunk sizes are clipped to
    the array shape.
    """
    if chunks is None:
        return None  # h5py contiguous layout
    if chunks == 'auto':
        return True  # h5py auto-chunking (the documented contract)
    fchunks = chunks
    if isinstance(chunks, dict):
        lowered = {str(k).lower(): v for k, v in chunks.items()}
        fchunks = lowered.get(feature.lower(), lowered)
        if isinstance(fchunks, dict):
            spec = tuple(fchunks.get(d) for d in DIM_ORDER[:len(shape)])
            if any(v is None for v in spec):
                return True  # auto-chunk
            fchunks = spec
    return tuple(int(min(c, s)) for c, s in zip(fchunks, shape))


def _encode(arr, fattrs):
    """Apply optional scale_factor/add_offset integer encoding
    (decoded = stored * scale_factor + add_offset)."""
    scale = fattrs.get('scale_factor')
    if scale is None:
        return np.asarray(arr, dtype=np.float32), {}
    offset = float(fattrs.get('add_offset', 0.0))
    dtype = np.dtype(fattrs.get('dtype', 'int16'))
    stored = np.round((np.asarray(arr) - offset) / scale).astype(dtype)
    enc_attrs = {'scale_factor': np.float64(scale),
                 'add_offset': np.float64(offset)}
    return stored, enc_attrs


def _decode(ds):
    """Inverse of :func:`_encode` for an h5py dataset."""
    arr = ds[:]
    if 'scale_factor' in ds.attrs:
        arr = (arr.astype(np.float32) * np.float32(ds.attrs['scale_factor'])
               + np.float32(ds.attrs.get('add_offset', 0.0)))
    return arr.astype(np.float32)


class Cacher:
    """Write each feature of a GridDataset to its own H5 or NetCDF
    file; the ``cache_pattern`` extension picks the format."""

    def __init__(self, data, cache_kwargs):
        """cache_kwargs must include 'cache_pattern' with a '{feature}'
        placeholder and a .h5 or .nc extension; optional 'chunks',
        'max_workers', 'attrs', and 'overwrite'."""
        ck = dict(cache_kwargs)
        self.out_files = self.cache_data(data, ck.pop('cache_pattern'),
                                         **ck)

    @classmethod
    def cache_data(cls, data, cache_pattern, chunks=None,
                   max_workers=None, attrs=None, overwrite=False):
        """Write all features; returns the file list (existing files
        are kept unless ``overwrite``)."""
        assert '{feature}' in cache_pattern, (
            'cache_pattern must contain "{feature}"')
        ext = os.path.splitext(cache_pattern)[1].lower()
        assert ext in ('.h5', '.nc'), (
            f'cache_pattern must end in .h5 or .nc, got "{ext}"')
        os.makedirs(os.path.dirname(os.path.abspath(cache_pattern)),
                    exist_ok=True)
        write = cls.write_h5 if ext == '.h5' else cls.write_netcdf

        out_files, jobs = [], []
        for i, feature in enumerate(data.features):
            fp = cache_pattern.format(feature=feature)
            out_files.append(fp)
            if os.path.exists(fp) and not overwrite:
                logger.info('%s exists; skipping (overwrite=False)', fp)
                continue
            jobs.append((i, feature, fp))

        from sup3r_tpu_torch.utilities import OUTPUT_ATTRS

        def _run(job):
            i, feature, fp = job
            # OUTPUT_ATTRS provide units metadata only; scale_factor
            # integer encoding is opt-in via user attrs (matching the
            # reference, which caches float unless attrs say otherwise)
            base = OUTPUT_ATTRS.get(get_feature_basename(feature), {})
            fattrs = {k: base[k] for k in ('units',) if k in base}
            fattrs.update((attrs or {}).get(feature, {}))
            chunk_spec = parse_chunks(feature, chunks,
                                      data.data.shape[:3])
            tmp = fp + '.tmp'
            write(tmp, feature, data.data[..., i], data.lat_lon,
                  data.time_index, chunks=chunk_spec, attrs=fattrs)
            os.replace(tmp, fp)
            logger.debug('Cached %s to %s', feature, fp)

        if max_workers in (None, 0, 1) or len(jobs) <= 1:
            for job in jobs:
                _run(job)
        else:
            with ThreadPoolExecutor(max_workers=max_workers) as pool:
                list(pool.map(_run, jobs))
        return out_files

    @staticmethod
    def write_h5(out_file, feature, arr, lat_lon, time_index,
                 chunks=None, attrs=None):
        """One feature block -> H5 with latitude/longitude/time_index
        coord datasets (reference: cachers.py:350-439)."""
        import h5py

        attrs = attrs or {}
        stored, enc = _encode(arr, attrs)
        with h5py.File(out_file, 'w') as f:
            ds = f.create_dataset(feature, data=stored, chunks=chunks)
            for k, v in enc.items():
                ds.attrs[k] = v
            for k in ('units', 'dtype'):
                if k in attrs:
                    ds.attrs[k] = str(attrs[k])
            if lat_lon is not None:
                f.create_dataset('latitude', data=lat_lon[..., 0])
                f.create_dataset('longitude', data=lat_lon[..., 1])
            if time_index is not None:
                f.create_dataset('time_index', data=to_datetime64(
                    time_index).astype('int64'))

    @staticmethod
    def write_netcdf(out_file, feature, arr, lat_lon, time_index,
                     chunks=None, attrs=None):
        """One feature block -> NetCDF4-style HDF5 file with dimension
        scales, readable by LoaderNC and any netCDF4 reader
        (reference: cachers.py:518-592). Regular grids only (the cache
        write path always has a regular rasterized grid)."""
        import h5py

        attrs = attrs or {}
        stored, enc = _encode(arr, attrs)
        with h5py.File(out_file, 'w') as f:
            lat = f.create_dataset(
                'latitude', data=lat_lon[:, 0, 0].astype(np.float32))
            lon = f.create_dataset(
                'longitude', data=lat_lon[0, :, 1].astype(np.float32))
            scales = [lat, lon]
            if time_index is not None:
                times = to_datetime64(time_index)
                hours = seconds_since(times, times[0]) / 3600
                tv = f.create_dataset('time', data=hours.astype('float64'))
                start = np.datetime_as_string(times[0], unit='s').replace(
                    'T', ' ')
                tv.attrs['units'] = np.bytes_(f'hours since {start}')
                tv.attrs['calendar'] = np.bytes_('standard')
                scales.append(tv)
            for sc in scales:
                sc.make_scale(sc.name.strip('/'))
            ds = f.create_dataset(feature, data=stored, chunks=chunks)
            for k, v in enc.items():
                ds.attrs[k] = v
            if 'units' in attrs:
                ds.attrs['units'] = np.bytes_(str(attrs['units']))
            for i, sc in enumerate(scales[:stored.ndim]):
                ds.dims[i].attach_scale(sc)


def load_cached(cache_pattern, features):
    """Reload a GridDataset from cache files if ALL requested features
    are present; returns None on any miss. Handles both .h5 and .nc
    caches and scale_factor decoding."""
    ext = os.path.splitext(cache_pattern)[1].lower()
    if features in ('all', None):
        fps = sorted(glob(cache_pattern.format(feature='*')))
        if not fps:
            return None
        import h5py

        features = []
        for fp in fps:
            with h5py.File(fp, 'r') as f:
                features.extend(
                    k for k in f
                    if k not in ('latitude', 'longitude', 'time',
                                 'time_index')
                    and isinstance(f[k], h5py.Dataset))
    features = [f.lower() for f in features]
    fps = [cache_pattern.format(feature=f) for f in features]
    if not all(os.path.exists(fp) for fp in fps):
        return None
    if ext == '.nc':
        from sup3r_tpu_torch.preprocessing.loaders import LoaderNC

        dset = LoaderNC(fps).data
        arrs = [np.asarray(dset[f], dtype=np.float32) for f in features]
        logger.info('Loaded cached features %s', features)
        return GridDataset(np.stack(arrs, axis=-1), features,
                           lat_lon=dset.lat_lon,
                           time_index=dset.time_index)
    import h5py

    arrs, lat_lon, ti = [], None, None
    for f, fp in zip(features, fps):
        with h5py.File(fp, 'r') as h:
            arrs.append(_decode(h[f]))
            if lat_lon is None:
                lat_lon = np.dstack([h['latitude'][:],
                                     h['longitude'][:]])
                if 'time_index' in h:
                    ti = TimeIndex(
                        h['time_index'][:].astype('datetime64[ns]'))
    logger.info('Loaded cached features %s', features)
    return GridDataset(np.stack(arrs, axis=-1), features,
                       lat_lon=lat_lon, time_index=ti)
