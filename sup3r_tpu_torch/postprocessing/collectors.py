"""Collect per-chunk output files into a single final file.

Reference parity: sup3r/postprocessing/collectors/h5.py:83-833
(CollectorH5 with filename-encoded chunk ids + meta alignment),
nc.py:25-141 (CollectorNC combine-by-coords). The port's copy of
``sup3r_tpu/postprocessing/collectors.py`` on the pandas-free
``TimeIndex``. ``CollectorNC`` reads and writes NetCDF through scipy and
runs wherever the port does; ``CollectorH5`` imports h5py when it runs.
"""

import csv
import logging
import os
import re
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from warnings import warn as _warn

import numpy as np

from sup3r_tpu_torch.utilities import get_dset_attrs
from sup3r_tpu_torch.utilities.times import (
    TimeIndex,
    format_timestamps,
    to_datetime64,
)

logger = logging.getLogger(__name__)

#: greedy prefix anchors on the LAST two index tokens, exactly like
#: the reference (collectors/base.py:53) — a date or job id earlier in
#: the name (e.g. ``era5_202401_..._000000_000003.h5``) must not be
#: mistaken for the chunk ids
_CHUNK_ID_PATTERN = re.compile(r'.*_(\d+)_(\d+).*\w+$')


def get_chunk_indices(file):
    """(temporal_idx, spatial_idx) parsed from a chunk file name
    (reference: collectors/base.py:43)."""
    m = _CHUNK_ID_PATTERN.match(os.path.basename(file))
    if not m:
        raise ValueError(f'Could not parse chunk ids from {file}')
    return int(m.group(1)), int(m.group(2))


def get_unique_chunk_files(file_paths):
    """Drop duplicate chunk files: if two files carry the same
    ``_tttttt_ssssss`` suffix (e.g. the same chunk written under two
    job names), keep the first (reference: collectors/h5.py:235-264)."""
    seen, unique = set(), []
    for fp in sorted(file_paths, key=get_chunk_indices):
        key = get_chunk_indices(fp)
        if key in seen:
            logger.warning('Skipping duplicate chunk file %s '
                           '(chunk id %s already collected)', fp, key)
            continue
        seen.add(key)
        unique.append(fp)
    return unique


def _ns(times):
    """int64 nanoseconds of each timestamp (hashable lookup keys)."""
    return to_datetime64(times).astype(np.int64)


def _read_h5_times(f):
    """The byte-string ``time_index`` of an open chunk file."""
    return TimeIndex([t.decode()[:26] for t in f['time_index'][:]])


def _read_meta_csv(path):
    """``{column: float array}`` of a meta CSV (the columns a target
    meta needs: latitude, longitude)."""
    with open(path, newline='') as f:
        rows = list(csv.DictReader(f))
    return {k: np.asarray([float(r[k]) for r in rows])
            for k in ('latitude', 'longitude')}


class CollectorH5:
    """Stitch flattened-H5 chunk files into one H5 by gid + time
    alignment.

    Scale machinery mirroring the reference collector
    (collectors/h5.py:83-833): threaded per-file reads honoring
    ``max_workers``, ``n_writes`` memory-bounded write groups of
    temporal chunks, KDTree threshold masking against a target meta,
    per-file scale-factor harmonization, and duplicate-chunk-file
    dedup."""

    def __init__(self, file_paths):
        if isinstance(file_paths, str):
            file_paths = sorted(glob(file_paths))
        self.flist = get_unique_chunk_files(file_paths)
        assert self.flist, 'No chunk files to collect'

    @classmethod
    def collect(cls, file_paths, out_file, features='all',
                max_workers=None, n_writes=None, target_meta_file=None,
                threshold=1e-4, overwrite=True):
        """Collect chunk files into ``out_file``.
        ``overwrite=False`` skips the collection when the output file
        already exists (reference: collectors/h5.py:729 overwrite).

        Each write group is gathered into one in-memory slab
        (threaded reads) then written in a single H5 write (reference:
        collectors/h5.py:590-718). ``n_writes=None`` (default) uses
        one group per temporal chunk — peak memory is ONE temporal
        chunk's rows; an explicit ``n_writes`` merges temporal chunks
        into that many (larger) groups. ``max_workers`` bounds the read
        thread pool (1 = serial). ``target_meta_file`` (a CSV path, or
        a table with ``latitude`` / ``longitude`` columns) masks the
        output meta to coordinates within ``threshold`` degrees of the
        target coordinates (reference: collectors/h5.py:83-104)."""
        if not overwrite and os.path.exists(out_file):
            logger.info('%s exists and overwrite=False; skipping '
                        'collection.', out_file)
            return out_file
        collector = cls(file_paths)
        collector._collect(out_file, features=features,
                           target_meta_file=target_meta_file,
                           n_writes=n_writes, max_workers=max_workers,
                           threshold=threshold)
        return out_file

    @staticmethod
    def _file_attrs(fp):
        """(gids, lat, lon, time_index) for one chunk file."""
        import h5py

        with h5py.File(fp, 'r') as f:
            meta = f['meta'][:]
            gid = (meta['gid'] if 'gid' in meta.dtype.names
                   else np.arange(len(meta)))
            return (np.asarray(gid), np.asarray(meta['latitude']),
                    np.asarray(meta['longitude']), _read_h5_times(f))

    def _read_meta(self, max_workers=None):
        """Union meta (sorted by gid) + union time index, gathering
        per-file attributes in a thread pool (reference:
        collectors/h5.py:266-305)."""
        if max_workers == 1:
            results = [self._file_attrs(fp) for fp in self.flist]
        else:
            with ThreadPoolExecutor(max_workers=max_workers) as pool:
                results = list(pool.map(self._file_attrs, self.flist))
        all_gids = np.concatenate([r[0] for r in results])
        order = np.argsort(all_gids)
        uniq, first = np.unique(all_gids[order], return_index=True)
        lat = np.concatenate([r[1] for r in results])[order][first]
        lon = np.concatenate([r[2] for r in results])[order][first]
        all_times = TimeIndex(
            np.unique(np.concatenate([r[3].values for r in results])))
        return uniq, lat, lon, all_times

    @staticmethod
    def get_coordinate_indices(target_meta, lat, lon, threshold=1e-4):
        """Indices in (lat, lon) within ``threshold`` of any target
        coordinate (reference: collectors/h5.py:83-104)."""
        from scipy.spatial import cKDTree

        tree = cKDTree(np.column_stack([lat, lon]))
        target = np.column_stack([np.asarray(target_meta['latitude']),
                                  np.asarray(target_meta['longitude'])])
        _, idx = tree.query(target, distance_upper_bound=threshold)
        return np.unique(idx[idx < len(lat)])

    def get_flist_chunks(self, n_writes=None):
        """Group chunk files by temporal chunk index, combined into at
        most ``n_writes`` write groups (reference:
        collectors/h5.py:590-633).

        ``n_writes=None`` (default) uses ONE GROUP PER TEMPORAL CHUNK,
        so peak memory is a single temporal chunk's slab — smaller
        ``n_writes`` values trade memory for fewer, larger H5 writes."""
        by_t = {}
        for fp in self.flist:
            t_chunk, _ = get_chunk_indices(fp)
            by_t.setdefault(t_chunk, []).append(fp)
        t_ids = sorted(by_t)
        if n_writes is not None and n_writes > len(t_ids):
            logger.info('n_writes (%s) too big; using the number of '
                        'temporal chunks (%s).', n_writes, len(t_ids))
        n_groups = (min(n_writes, len(t_ids)) if n_writes
                    else len(t_ids))
        groups = np.array_split(np.asarray(t_ids), n_groups)
        return [[fp for t in g for fp in by_t[int(t)]] for g in groups]

    def _file_alignment(self, fp, gid_pos, time_pos):
        """(keep_cols, cols, r0) for a chunk file — feature
        independent, so cached per file: re-parsing the byte-string
        time index per (feature x file) costs thousands of parses per
        file per feature."""
        import h5py

        cache = getattr(self, '_align_cache', None)
        if cache is None:
            cache = self._align_cache = {}
        if fp in cache:
            return cache[fp]
        with h5py.File(fp, 'r') as f:
            fmeta = f['meta'][:]
            fgids = (fmeta['gid'] if 'gid' in fmeta.dtype.names
                     else np.arange(len(fmeta)))
            ftimes = _read_h5_times(f)
        keep_cols = np.array([i for i, g in enumerate(fgids)
                              if g in gid_pos], dtype=int)
        if keep_cols.size == 0:
            cache[fp] = None
            return None
        cols = np.array([gid_pos[g] for g in fgids[keep_cols]])
        rows = np.array([time_pos[t] for t in _ns(ftimes)])
        r0, r1 = rows.min(), rows.max() + 1
        if not np.array_equal(rows, np.arange(r0, r1)):
            raise ValueError(
                f'Non-contiguous time rows in chunk file {fp}')
        cache[fp] = (keep_cols, cols, int(r0))
        return cache[fp]

    def _read_file_block(self, fp, feat, gid_pos, time_pos,
                         dest_scale, dest_dtype):
        """Read one chunk file's feature block, harmonizing its scale
        factor to the destination's (reference: collectors/h5.py:106-
        200). Returns (r0, cols, block) or None if no kept columns."""
        import h5py

        align = self._file_alignment(fp, gid_pos, time_pos)
        if align is None:
            msg = (f'No target coordinates found in masked meta; '
                   f'skipping collection for {fp}.')
            logger.warning(msg)
            _warn(msg)
            return None
        keep_cols, cols, r0 = align
        with h5py.File(fp, 'r') as f:
            src_scale = dict(f[feat].attrs).get('scale_factor',
                                                dest_scale)
            block = f[feat][:][:, keep_cols]
        if src_scale != dest_scale:
            block = block.astype(np.float32)
            block *= dest_scale / src_scale
            if np.issubdtype(np.dtype(dest_dtype), np.integer):
                block = np.round(block)
            block = block.astype(dest_dtype)
        return r0, cols, block

    def _collect(self, out_file, features='all', target_meta_file=None,
                 n_writes=None, max_workers=None, threshold=1e-4):
        import h5py

        gids, lat, lon, times = self._read_meta(max_workers=max_workers)
        if target_meta_file is not None:
            target = (_read_meta_csv(target_meta_file)
                      if isinstance(target_meta_file, str)
                      else target_meta_file)
            keep = self.get_coordinate_indices(target, lat, lon,
                                               threshold=threshold)
            if keep.size == 0:
                raise RuntimeError(
                    'No target coordinates found within threshold '
                    f'{threshold} of the collected meta '
                    f'({target_meta_file})')
            gids, lat, lon = gids[keep], lat[keep], lon[keep]

        gid_pos = {g: i for i, g in enumerate(gids)}
        time_pos = {t: i for i, t in enumerate(_ns(times))}

        with h5py.File(self.flist[0], 'r') as f:
            if features in ('all', None):
                features = [k for k in f
                            if k not in ('meta', 'time_index')]
            attrs = dict(f.attrs)

        flist_chunks = self.get_flist_chunks(n_writes)
        tmp = out_file + '.tmp'
        os.makedirs(os.path.dirname(os.path.abspath(out_file)),
                    exist_ok=True)
        with h5py.File(tmp, 'w') as out:
            meta = np.zeros(len(gids), dtype=[('latitude', 'f4'),
                                              ('longitude', 'f4'),
                                              ('gid', 'i4')])
            meta['latitude'] = lat
            meta['longitude'] = lon
            meta['gid'] = gids
            out.create_dataset('meta', data=meta)
            out.create_dataset('time_index', data=np.array(
                [t.encode() for t in format_timestamps(times)]))
            for k, v in attrs.items():
                out.attrs[k] = v
            for feat in features:
                dset_attrs, dtype = get_dset_attrs(feat)
                dest_scale = dset_attrs.get('scale_factor', 1)
                full = out.create_dataset(
                    feat, shape=(len(times), len(gids)), dtype=dtype)
                for key, val in dset_attrs.items():
                    full.attrs[key] = val

                def read(fp, feat=feat, dest_scale=dest_scale,
                         dtype=dtype):
                    return self._read_file_block(
                        fp, feat, gid_pos, time_pos, dest_scale, dtype)

                for fps in flist_chunks:
                    # gather this write group into one in-memory slab
                    # (threaded reads), then write it in one H5 call
                    if max_workers == 1:
                        blocks = [read(fp) for fp in fps]
                    else:
                        with ThreadPoolExecutor(
                                max_workers=max_workers) as pool:
                            blocks = list(pool.map(read, fps))
                    blocks = [b for b in blocks if b is not None]
                    if not blocks:
                        continue
                    g0 = min(b[0] for b in blocks)
                    g1 = max(b[0] + len(b[2]) for b in blocks)
                    slab = np.zeros((g1 - g0, len(gids)), dtype=dtype)
                    for r0, cols, block in blocks:
                        slab[r0 - g0:r0 - g0 + len(block), cols] = block
                    logger.debug(
                        'Writing "%s" rows [%d:%d) (%.1f MB slab, %d '
                        'files)', feat, g0, g1, slab.nbytes / 1e6,
                        len(fps))
                    full[g0:g1, :] = slab
        os.replace(tmp, out_file)
        logger.info('Collected %d chunk files into %s', len(self.flist),
                    out_file)
        return out_file


class CollectorNC:
    """Combine gridded NC chunk files by coordinates.

    Regular (separable lat/lon) grids combine across both spatial axes
    (reference nc.py:109-115 ``xr.combine_by_coords``); curvilinear
    grids are supported for chunks split by LATITUDE only via
    ``is_regular_grid=False`` (reference nc.py:117-120 ``xr.concat``
    along south_north), matching the reference's documented limitation
    (nc.py:39-45)."""

    @classmethod
    def collect(cls, file_paths, out_file, features='all',
                max_workers=None, res_kwargs=None,
                is_regular_grid=True):
        """Combine chunk nc files into one nc file. ``max_workers``
        bounds the thread pool loading chunk files (1 = serial);
        ``res_kwargs`` is forwarded to the NC loader.
        ``is_regular_grid=False`` collects curvilinear chunks that are
        split by latitude: same-footprint chunks concatenate over
        time, then footprints stack along south_north in spatial-chunk
        -id order (reference nc.py:117-120)."""
        from sup3r_tpu_torch.preprocessing.loaders import LoaderNC

        if isinstance(file_paths, str):
            pattern = file_paths
            file_paths = sorted(glob(file_paths))
            assert file_paths, (
                f'No chunk files to collect for {pattern!r}')
        assert file_paths, 'No chunk files to collect'
        file_paths = sorted(file_paths, key=get_chunk_indices)

        def load(fp):
            return LoaderNC(fp, **(res_kwargs or {})).data

        if max_workers == 1:
            dsets = [load(fp) for fp in file_paths]
        else:
            with ThreadPoolExecutor(max_workers=max_workers) as pool:
                dsets = list(pool.map(load, file_paths))

        if features in ('all', None):
            features = dsets[0].features

        if not is_regular_grid:
            return cls._collect_curvilinear(
                file_paths, dsets, out_file, features)

        lats = np.unique(np.concatenate(
            [d.lat_lon[..., 0].ravel() for d in dsets]))[::-1]
        lons = np.unique(np.concatenate(
            [d.lat_lon[..., 1].ravel() for d in dsets]))
        times = TimeIndex(np.unique(np.concatenate(
            [d.time_index.values for d in dsets])))

        lat_pos = {v: i for i, v in enumerate(lats)}
        lon_pos = {v: i for i, v in enumerate(lons)}
        time_pos = {t: i for i, t in enumerate(_ns(times))}

        full = {f: np.full((len(times), len(lats), len(lons)), np.nan,
                           dtype=np.float32) for f in features}
        for d in dsets:
            # regular-grid gate, matching the reference's limitation
            # (collectors/nc.py combine_by_coords requires separable
            # coords): curvilinear chunk grids would scatter data to
            # wrong (lat, lon) pairs and allocate an O(N^2) cube
            ll = d.lat_lon
            if not (np.allclose(ll[..., 0], ll[:, :1, 0])
                    and np.allclose(ll[..., 1], ll[:1, :, 1])):
                raise NotImplementedError(
                    'CollectorNC(is_regular_grid=True) requires '
                    'regular (separable) lat/lon grids; got a '
                    'curvilinear chunk grid. Pass '
                    'is_regular_grid=False for latitude-split '
                    'curvilinear chunks, or collect to H5 '
                    '(CollectorH5).')
            rows = [lat_pos[v] for v in d.lat_lon[:, 0, 0]]
            cols = [lon_pos[v] for v in d.lat_lon[0, :, 1]]
            t_rows = [time_pos[t] for t in _ns(d.time_index)]
            for f in features:
                arr = np.transpose(d[f], (2, 0, 1))
                full[f][np.ix_(t_rows, rows, cols)] = arr

        lat2d, lon2d = np.meshgrid(lats, lons, indexing='ij')
        cls._write_nc(out_file, times, lat2d, lon2d, full, features)
        logger.info('Collected %d nc chunk files into %s',
                    len(file_paths), out_file)
        return out_file

    @classmethod
    def _collect_curvilinear(cls, file_paths, dsets, out_file,
                             features):
        """Collect curvilinear chunks split by latitude: group files
        by spatial chunk id, concat each footprint over time, then
        stack footprints along south_north in spatial-id order
        (reference nc.py:117-120 ``xr.concat(..., dim=SOUTH_NORTH)``
        after nc.py:132-141 ``group_spatial_chunks``)."""
        groups = {}
        for fp, d in zip(file_paths, dsets):
            _, s_idx = get_chunk_indices(fp)
            groups.setdefault(s_idx, []).append(d)

        stitched = {}  # s_idx -> (lat_lon, times, {feat: (t, sn, we)})
        for s_idx in sorted(groups):
            parts = groups[s_idx]
            ll = parts[0].lat_lon
            for p in parts[1:]:
                if not np.allclose(p.lat_lon, ll):
                    raise ValueError(
                        'Chunk files sharing spatial id %d have '
                        'different lat/lon grids' % s_idx)
            order = np.argsort([p.time_index[0] for p in parts])
            parts = [parts[i] for i in order]
            times = TimeIndex(np.concatenate(
                [p.time_index.values for p in parts]))
            if len(np.unique(times.values)) != len(times):
                raise ValueError(
                    'Overlapping time indices across temporal chunks '
                    'for spatial id %d' % s_idx)
            data = {f: np.concatenate(
                [np.transpose(np.asarray(p[f]), (2, 0, 1))
                 for p in parts], axis=0) for f in features}
            stitched[s_idx] = (ll, times, data)

        s_ids = sorted(stitched)
        ll0, times0, _ = stitched[s_ids[0]]
        for s_idx in s_ids[1:]:
            ll, times, _ = stitched[s_idx]
            if ll.shape[1] != ll0.shape[1]:
                raise NotImplementedError(
                    'Curvilinear collection supports chunks split by '
                    'latitude only (reference nc.py:39-45): spatial '
                    'chunks %d and %d have different west_east '
                    'extents (%d vs %d)'
                    % (s_ids[0], s_idx, ll0.shape[1], ll.shape[1]))
            if not times.equals(times0):
                raise ValueError(
                    'Spatial chunks %d and %d cover different time '
                    'indices' % (s_ids[0], s_idx))

        lat_lon = np.concatenate(
            [stitched[s][0] for s in s_ids], axis=0)
        # latitude-split sanity beyond the width check: an EQUAL-width
        # longitude split passes the west_east-extent test but stacks
        # longitude-adjacent footprints vertically. On a latitude
        # split, latitude runs monotonically down (or up) every column
        # of the stitched grid; a longitude split jumps back to the
        # top of the band at the stitch boundary. (The reference
        # xr.concat's silently garbles this case — nc.py:117-120; we
        # promise a loud error instead.)
        dlat = np.diff(lat_lon[..., 0], axis=0)
        if dlat.size and not (np.all(dlat > 0) or np.all(dlat < 0)):
            raise NotImplementedError(
                'Curvilinear collection supports chunks split by '
                'latitude only: stitching spatial chunks %s along '
                'south_north does not give per-column monotonic '
                'latitudes — these look like longitude-split (or '
                'both-axis-split) chunks' % (s_ids,))
        full = {f: np.concatenate(
            [stitched[s][2][f] for s in s_ids], axis=1)
            for f in features}
        cls._write_nc(out_file, times0, lat_lon[..., 0],
                      lat_lon[..., 1], full, features)
        logger.info('Collected %d curvilinear nc chunk files into %s',
                    len(file_paths), out_file)
        return out_file

    @staticmethod
    def _write_nc(out_file, times, lat2d, lon2d, full, features):
        """Atomic NetCDF write via the shared writer helper (one
        NetCDF path for collectors AND OutputHandlerNC)."""
        from sup3r_tpu_torch.postprocessing.writers import write_nc_file

        return write_nc_file(out_file, times, lat2d, lon2d,
                             {feat: full[feat] for feat in features})
