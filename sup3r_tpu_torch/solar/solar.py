"""Solar module: GAN clearsky_ratio chunks + NSRDB clearsky data ->
GHI / DNI / DHI irradiance files.

Reference parity: sup3r/solar/solar.py:29-650 (KDTree agg :156,
tz roll :215, GHI :298, DNI via DISC :315, DHI closure :340,
get_sup3r_fps padded file triplets :404, run_temporal_chunks :584).
The port's copy of ``sup3r_tpu/solar/solar.py`` on the port's
``LoaderH5`` and its pandas-free ``TimeIndex``. It reads and writes H5
only, so it needs h5py, which it imports where it writes.
"""

import logging
import os
import re

import numpy as np
from scipy.spatial import cKDTree

from sup3r_tpu_torch.preprocessing.loaders import LoaderH5, expand_paths
from sup3r_tpu_torch.solar.disc import calc_dhi, dark_night, disc
from sup3r_tpu_torch.utilities import get_dset_attrs
from sup3r_tpu_torch.utilities.times import format_timestamps

logger = logging.getLogger(__name__)

#: the chunk ids of a forward-pass output file name: the greedy prefix
#: anchors on the LAST two index tokens (the collectors' pattern,
#: reference collectors/base.py:53), so a date or job id earlier in the
#: name is not taken for them
_CHUNK_ID_PATTERN = re.compile(r'.*_(\d+)_(\d+).*\w+$')


def _is_leap_year(time_index):
    """Per timestamp, whether its year is a leap year."""
    years = np.asarray(time_index).astype('datetime64[Y]').astype(
        np.int64) + 1970
    return (years % 4 == 0) & ((years % 100 != 0) | (years % 400 == 0))


def _meta_records(meta):
    """The ``{column: array}`` meta of the port's ``LoaderH5`` as the
    structured array an H5 'meta' table stores."""
    cols = {k: np.asarray(v) for k, v in meta.items()}
    out = np.zeros(len(next(iter(cols.values()))),
                   dtype=[(k, v.dtype) for k, v in cols.items()])
    for k, v in cols.items():
        out[k] = v
    return out


class Solar:
    """Compute irradiance for one spatiotemporal chunk of GAN csr
    output."""

    def __init__(self, sup3r_fps, nsrdb_fp, t_slice=slice(None), tz=-7,
                 agg_factor=1, nn_threshold=0.5, cloud_threshold=0.99):
        """
        Parameters
        ----------
        sup3r_fps : str | list
            One or more (temporally sequential, same spatial chunk) GAN
            output h5 files with a clearsky_ratio dataset.
        nsrdb_fp : str
            NSRDB file with clearsky_ghi/clearsky_dni,
            solar_zenith_angle and surface_pressure.
        t_slice : slice
            Temporal slice applied AFTER the tz roll (pads the UTC
            conversion when 3 daily files are passed).
        tz : int
            Timezone offset of the (local-time) GAN output.
        agg_factor : int
            Number of NSRDB neighbors to average per GAN site.
        nn_threshold : float
            Max degree distance to an NSRDB neighbor; farther sites
            output zero irradiance.
        cloud_threshold : float
            clearsky_ratio below this is considered cloudy (DISC DNI).
        """
        self.sup3r_fps = ([sup3r_fps] if isinstance(sup3r_fps, str)
                          else list(sup3r_fps))
        self.nsrdb_fp = nsrdb_fp
        self.t_slice = t_slice
        self.tz = tz
        self.agg_factor = agg_factor
        self.nn_threshold = nn_threshold
        self.cloud_threshold = cloud_threshold

        self.gan_data = LoaderH5(self.sup3r_fps)
        self.nsrdb = LoaderH5(nsrdb_fp)
        self._cache = {}
        self._compute_nn()

    def close(self):
        """Close file handles."""
        self.gan_data.close()
        self.nsrdb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def _compute_nn(self):
        tree = cKDTree(self.nsrdb.lat_lon_flat)
        dist, idnn = tree.query(self.gan_data.lat_lon_flat,
                                k=self.agg_factor)
        if idnn.ndim == 1:
            dist, idnn = dist[:, None], idnn[:, None]
        self.dist = dist
        self.idnn = idnn

    @property
    def out_of_bounds(self):
        """Sites too far from any NSRDB neighbor."""
        return (self.dist > self.nn_threshold).any(axis=1)

    @property
    def gan_time_index(self):
        """Full GAN output time index (pre slice)."""
        return self.gan_data.time_index

    @property
    def time_index(self):
        """Output (sliced) time index."""
        return self.gan_time_index[self.t_slice]

    @property
    def nsrdb_tslice(self):
        """NSRDB time rows matching the GAN output days at hourly step
        (reference: solar.py:228)."""
        if 'nsrdb_tslice' not in self._cache:
            doy_n = self.nsrdb.time_index.dayofyear
            doy_g = self.time_index.dayofyear
            # reference parity: matching is by day-of-year
            # (reference solar.py:220-222). That silently shifts every
            # post-February day by one when exactly one of the two
            # years is a leap year — warn loudly (same bug class as
            # the NCforCC '%m.%d' day matching, nc_cc.py:231-240).
            leap_n = bool(_is_leap_year(self.nsrdb.time_index).any())
            leap_g = bool(_is_leap_year(self.time_index).any())
            if leap_n != leap_g:
                logger.warning(
                    'NSRDB (leap=%s) and GAN output (leap=%s) years '
                    'differ in leap status; day-of-year matching '
                    'shifts all post-Feb-28 days by one. Use an '
                    'NSRDB file from a year with matching leap '
                    'status.', leap_n, leap_g)
            mask = np.isin(doy_n, doy_g)
            if mask.sum() == 0:
                raise RuntimeError(
                    'No common days between NSRDB and GAN time index')
            ilocs = np.where(mask)[0]
            t0, t1 = ilocs[0], ilocs[-1] + 1
            ti = self.nsrdb.time_index
            delta = (ti[1] - ti[0]) / np.timedelta64(1, 's')
            step = int(3600 / delta)
            self._cache['nsrdb_tslice'] = slice(t0, t1, step)
        return self._cache['nsrdb_tslice']

    def get_nsrdb_data(self, dset):
        """(time, gan_sites) NSRDB data agg'd over neighbors.

        The full-spatial slab is read ONCE and column-indexed per
        aggregation neighbor (reading it inside the neighbor loop cost
        agg_factor full-domain reads per dataset)."""
        slab = self.nsrdb.get(dset, self.nsrdb_tslice, None)
        out = None
        for i in range(self.idnn.shape[1]):
            temp = slab[:, self.idnn[:, i]]
            out = temp if out is None else out + temp
        return out / self.idnn.shape[1]

    # ------------------------------------------------------------------
    @property
    def clearsky_ratio(self):
        """(time, sites) csr rolled from local time to UTC and sliced."""
        if 'csr' not in self._cache:
            csr = self.gan_data.get('clearsky_ratio')
            csr = np.roll(csr, -self.tz, axis=0)
            # np.roll wraps: backfill the wrapped rows from the
            # nearest valid row on both signs (western tz<0 wraps the
            # head; eastern tz>0 wraps the tail)
            if self.tz < 0:
                csr[:-self.tz, :] = csr[-self.tz, :]
            elif self.tz > 0:
                csr[-self.tz:, :] = csr[-self.tz - 1, :]
            self._cache['csr'] = csr[self.t_slice, :]
        return self._cache['csr']

    @property
    def solar_zenith_angle(self):
        """(time, sites) zenith from NSRDB."""
        if 'sza' not in self._cache:
            self._cache['sza'] = self.get_nsrdb_data(
                'solar_zenith_angle')
        return self._cache['sza']

    @property
    def cloud_mask(self):
        """True where the GAN says cloudy."""
        return self.clearsky_ratio < self.cloud_threshold

    @property
    def ghi(self):
        """GHI = csr * clearsky GHI (reference: solar.py:298)."""
        if 'ghi' not in self._cache:
            ghi = self.get_nsrdb_data('clearsky_ghi') \
                * self.clearsky_ratio
            ghi[:, self.out_of_bounds] = 0
            self._cache['ghi'] = ghi
        return self._cache['ghi']

    @property
    def dni(self):
        """Clearsky DNI where clear; DISC-model DNI where cloudy."""
        if 'dni' not in self._cache:
            dni = self.get_nsrdb_data('clearsky_dni')
            if 'surface_pressure' in self.nsrdb.features:
                pressure = self.get_nsrdb_data('surface_pressure')
            else:
                # the reference REQUIRES surface_pressure in the NSRDB
                # file (solar.py:139); sea-level pressure biases DISC
                # airmass ~18% at 1.6 km elevation — never silent
                logger.warning(
                    'NSRDB file has no surface_pressure dataset; '
                    'using sea-level 101325 Pa for the DISC model. '
                    'Cloudy-sky DNI will be biased at elevation.')
                pressure = 101325.0
            doy = self.time_index.dayofyear
            cloudy = disc(self.ghi, self.solar_zenith_angle, doy,
                          pressure=pressure)
            cloudy = np.minimum(dni, cloudy)
            mask = self.cloud_mask
            dni = np.where(mask, cloudy, dni)
            dni = dark_night(dni, self.solar_zenith_angle)
            dni[:, self.out_of_bounds] = 0
            self._cache['dni'] = dni
        return self._cache['dni']

    @property
    def dhi(self):
        """DHI from the GHI/DNI/zenith closure."""
        if 'dhi' not in self._cache:
            dhi, dni = calc_dhi(self.dni, self.ghi,
                                self.solar_zenith_angle)
            dhi = dark_night(dhi, self.solar_zenith_angle)
            dhi[:, self.out_of_bounds] = 0
            self._cache['dhi'] = dhi
            self._cache['dni'] = dni
        return self._cache['dhi']

    # ------------------------------------------------------------------
    def write(self, fp_out, features=('ghi', 'dni', 'dhi')):
        """Write irradiance h5 with meta + time index.

        The DHI closure is evaluated FIRST when dni is requested:
        ``calc_dhi`` reduces DNI where the closure would go negative,
        and writing dni before dhi would store the uncorrected value
        (the reference writes features in order and has exactly that
        inconsistency, solar.py:537-559 — here the stored file always
        satisfies ghi = dhi + dni*cos(sza))."""
        import h5py

        if 'dni' in features and 'dhi' in features:
            _ = self.dhi  # caches the closure-corrected dni
        os.makedirs(os.path.dirname(os.path.abspath(fp_out)),
                    exist_ok=True)
        tmp = fp_out + '.tmp'
        with h5py.File(tmp, 'w') as f:
            f.create_dataset('meta', data=_meta_records(self.gan_data.meta))
            f.create_dataset('time_index', data=np.array(
                [t.encode() for t in format_timestamps(self.time_index)]))
            for feat in features:
                attrs, dtype = get_dset_attrs(feat)
                arr = getattr(self, feat)
                scale = attrs.get('scale_factor', 1.0)
                ds = f.create_dataset(
                    feat, data=np.round(arr * scale).astype(dtype)
                    if 'int' in str(dtype) else arr.astype(dtype))
                for k, v in attrs.items():
                    ds.attrs[k] = v
        os.replace(tmp, fp_out)
        logger.info('Wrote solar irradiance file %s', fp_out)

    # ------------------------------------------------------------------
    @staticmethod
    def get_sup3r_fps(fp_pattern, ignore=None):
        """Group chunk files into overlapping temporal triplets per
        spatial chunk (reference: solar.py:404-498)."""
        all_fps = [fp for fp in expand_paths(fp_pattern)
                   if fp.endswith('.h5')]
        if ignore is not None:
            all_fps = [fp for fp in all_fps
                       if ignore not in os.path.basename(fp)]
        all_fps = sorted(all_fps)
        source_dir = os.path.dirname(all_fps[0])
        # one chunk-id convention: the collectors' anchored pattern

        def _parse(fp):
            name = os.path.basename(fp)
            m = _CHUNK_ID_PATTERN.match(name)
            if not m:
                raise ValueError(
                    f'Could not parse chunk ids from {name}')
            return name[:m.start(1) - 1], m.group(1), m.group(2)

        parsed = [_parse(fp) for fp in all_fps]
        bases = {p[0] for p in parsed}
        if len(bases) != 1:
            raise ValueError(
                f'Chunk files mix basenames {sorted(bases)} under '
                f'{fp_pattern}')
        base = bases.pop()
        t_ids = sorted({p[1] for p in parsed})
        s_ids = sorted({p[2] for p in parsed})
        # (t_id, s_id) -> the ACTUAL file, so filenames with content
        # after the ids (which the regex tolerates) still resolve
        by_ids = {(t, s): fp for fp, (_, t, s) in zip(all_fps, parsed)}

        fp_sets, t_slices, temporal_ids, spatial_ids, target_fps = (
            [], [], [], [], [])
        for idt, id_t in enumerate(t_ids):
            start = 0
            chunk_t_ids = [id_t]
            if idt > 0:
                start = 24
                chunk_t_ids.insert(0, t_ids[idt - 1])
            if idt < len(t_ids) - 1:
                chunk_t_ids.append(t_ids[idt + 1])
            for id_s in s_ids:
                fp_set = [
                    by_ids.get(
                        (t, id_s),
                        os.path.join(source_dir,
                                     f'{base}_{t}_{id_s}.h5'))
                    for t in chunk_t_ids]
                fp_sets.append(fp_set)
                t_slices.append(slice(start, start + 24))
                temporal_ids.append(id_t)
                spatial_ids.append(id_s)
                target_fps.append(os.path.join(
                    source_dir, f'{base}_{id_t}_{id_s}.h5'))
        return fp_sets, t_slices, temporal_ids, spatial_ids, target_fps

    @classmethod
    def run_temporal_chunks(cls, fp_pattern, nsrdb_fp,
                            fp_out_suffix='irradiance', tz=-7,
                            agg_factor=1, nn_threshold=0.5,
                            cloud_threshold=0.99, features=('ghi',
                                                            'dni',
                                                            'dhi'),
                            temporal_ids=None, max_nodes=1,
                            node_index=0):
        """Run irradiance for all (or this node's share of) temporal
        chunks (reference: solar.py:584 distributes temporal chunks
        over <= max_nodes jobs)."""
        out = cls.get_sup3r_fps(fp_pattern, ignore=f'_{fp_out_suffix}')
        fp_sets, t_slices, t_ids, _, target_fps = out
        if temporal_ids is not None:
            # normalize JSON-config spellings: integer ids match the
            # zero-padded string ids encoded in the chunk file names
            temporal_ids = [t if isinstance(t, str) else
                            str(int(t)).zfill(6) for t in temporal_ids]
        if max_nodes and max_nodes > 1:
            # an explicit temporal_ids list restricts the universe but
            # must STILL split across nodes, or every node would
            # process (and double-write) every listed chunk
            uniq = sorted(set(t_ids) if temporal_ids is None
                          else set(t_ids) & set(temporal_ids))
            splits = np.array_split(uniq, min(max_nodes,
                                              max(len(uniq), 1)))
            if node_index >= len(splits) or not uniq:
                # more nodes than temporal chunks: surplus nodes no-op
                logger.info('Node %d has no temporal chunks '
                            '(%d chunk splits)', node_index,
                            len(splits))
                return []
            temporal_ids = list(splits[node_index])
        written = []
        for fp_set, t_slice, t_id, target in zip(fp_sets, t_slices,
                                                 t_ids, target_fps):
            if temporal_ids is not None and t_id not in temporal_ids:
                continue
            fp_out = target.replace('.h5', f'_{fp_out_suffix}.h5')
            if os.path.exists(fp_out):
                continue
            with cls(fp_set, nsrdb_fp, t_slice=t_slice, tz=tz,
                     agg_factor=agg_factor, nn_threshold=nn_threshold,
                     cloud_threshold=cloud_threshold) as solar:
                solar.write(fp_out, features=features)
            written.append(fp_out)
        return written
