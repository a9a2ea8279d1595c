"""Fake data for tests and on-card runs of the port (the counterparts
of the helpers in ``sup3r_tpu/utilities/test_helpers.py``): an
in-memory GridDataset and its (low_res, high_res) pair, NetCDF3 input
through scipy, a NetCDF3 topography source and the NetCDF3 form of a
bias factor file, without pandas or h5py, so a machine without them can
make its own input; NetCDF4-style, flattened NetCDF4 and rex-style H5
files through h5py, imported in the function (CPU machines only); ``spawn_ranks``, which starts a group of
rank processes for the multi-rank tests and runs; and
``expected_exchange_bytes``, the analytic count of the rows a dp x sp
train step's sharded layers exchange."""

import os
import re
import subprocess
import time

import numpy as np

from sup3r_tpu_torch.preprocessing.grid import GridDataset, PairedDataset
from sup3r_tpu_torch.utilities import RANDOM_GENERATOR, safe_serialize
from sup3r_tpu_torch.utilities.times import (
    date_range,
    format_timestamps,
    infer_unit,
    seconds_since,
    timestamp,
)


#: pandas frequency units numpy names otherwise
_PANDAS_UNITS = {'min': 'm', 'T': 'm', 'H': 'h', 'd': 'D', 'S': 's',
                 'L': 'ms', 'U': 'us', 'N': 'ns'}


def _freq_step(freq):
    """A ``timedelta64`` step from a ``timedelta64``, a numpy unit ('h')
    or a fixed pandas frequency string ('30min', '2h', 'D')."""
    if isinstance(freq, np.timedelta64):
        return freq
    match = re.fullmatch(r'(\d*)([A-Za-z]+)', str(freq))
    if match is None:
        raise ValueError(f'not a fixed frequency: {freq!r}')
    count, unit = match.groups()
    return np.timedelta64(int(count or 1), _PANDAS_UNITS.get(unit, unit))


def _time_index(start, freq, t):
    """``t`` timestamps from ``start`` every ``freq`` (see
    ``_freq_step``)."""
    step = _freq_step(freq)
    t0 = timestamp(start)
    return date_range(t0, t0 + (t - 1) * step, step,
                      unit=infer_unit([start]))


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


def make_fake_nc4_file(path, shape, features, start='2023-01-01',
                       freq='h', ascending_lats=False, scale_factor=None,
                       lat_range=(40.0, 39.0),
                       lon_range=(-105.5, -104.3), levels=None,
                       include_time=True, var_attrs=None,
                       calendar='standard', fill_value=None):
    """Write an HDF5-backed NetCDF4-style file via h5py (imported here:
    CPU machines only), with dimension scales attached so
    DIMENSION_LIST resolves: the JAX package's helper of the same name,
    drawing the same values from ``RANDOM_GENERATOR``. With ``levels``,
    variables get a (time, level, lat, lon) shape. ``var_attrs`` maps
    feature -> extra dataset attrs; ``include_time=False`` writes a
    time-independent file; ``fill_value`` stamps that PACKED value into
    the first element of each variable plus a ``_FillValue`` attr."""
    s1, s2, t = shape
    lat0, lat1 = lat_range if not ascending_lats else lat_range[::-1]
    lat = np.linspace(lat0, lat1, s1).astype(np.float32)
    lon = np.linspace(*lon_range, s2).astype(np.float32)
    time_index = _time_index(start, freq, t)
    local = calendar in ('noleap', '365_day', '360_day')
    if local:
        # offsets from `start` (the units attr says so for these
        # calendars), honoring freq
        step_h = (_freq_step(freq) / np.timedelta64(1, 'h')
                  if t > 1 else 1.0)
        hours = np.arange(t, dtype='float64') * step_h
    else:
        hours = seconds_since(time_index, '1900-01-01') / 3600

    import h5py

    with h5py.File(path, 'w') as f:
        tv = None
        if include_time:
            tv = f.create_dataset('time', data=hours)
            tv.attrs['units'] = np.bytes_(
                f'hours since {start}' if local
                else 'hours since 1900-01-01')
            tv.attrs['calendar'] = np.bytes_(calendar)
            tv.make_scale('time')
        latv = f.create_dataset('lat', data=lat)
        lonv = f.create_dataset('lon', data=lon)
        latv.make_scale('lat')
        lonv.make_scale('lon')
        lvlv = None
        if levels is not None:
            lvlv = f.create_dataset(
                'level', data=np.asarray(levels, np.float32))
            lvlv.make_scale('level')
        for feat in features:
            full_shape = (s1, s2)
            if levels is not None:
                full_shape = (len(levels), *full_shape)
            if include_time:
                full_shape = (t, *full_shape)
            arr = RANDOM_GENERATOR.random(full_shape).astype(np.float32)
            if scale_factor is not None:
                stored = np.round(arr / scale_factor).astype(np.int16)
                if fill_value is not None:
                    stored.flat[0] = fill_value
                v = f.create_dataset(feat, data=stored)
                v.attrs['scale_factor'] = np.float64(scale_factor)
                v.attrs['add_offset'] = np.float64(0.0)
            else:
                if fill_value is not None:
                    arr.flat[0] = fill_value
                v = f.create_dataset(feat, data=arr)
            if fill_value is not None:
                v.attrs['_FillValue'] = (
                    np.int16(fill_value) if scale_factor is not None
                    else np.float32(fill_value))
            for k, val in (var_attrs or {}).get(feat, {}).items():
                v.attrs[k] = val
            scales = [sc for sc in (tv, lvlv, latv, lonv)
                      if sc is not None]
            for i, sc in enumerate(scales):
                v.dims[i].attach_scale(sc)
    return path


def make_fake_flat_nc_file(path, shape, features, start='2023-01-01',
                           freq='h', lat_range=(40.0, 39.0),
                           lon_range=(-105.5, -104.3), data=None,
                           var_attrs=None, space_first=False,
                           with_topography=False):
    """Spatially-flattened NetCDF4-style file via h5py (CPU machines
    only): 1-D lat/lon over one shared 'points' dim plus (time, points)
    variables, the sites the row-major flattening of an (s1, s2) grid,
    as the JAX package's helper writes it. ``data`` maps feature -> (t,
    s1, s2) values to flatten (``RANDOM_GENERATOR`` draws otherwise);
    ``space_first`` writes (points, time) variables;
    ``with_topography`` adds a site-static topography variable."""
    import h5py

    s1, s2, t = shape
    lat = np.linspace(*lat_range, s1)
    lon = np.linspace(*lon_range, s2)
    lat2d, lon2d = np.meshgrid(lat, lon, indexing='ij')
    hours = seconds_since(_time_index(start, freq, t), '1900-01-01') / 3600
    n = s1 * s2
    with h5py.File(path, 'w') as f:
        tv = f.create_dataset('time', data=hours)
        tv.attrs['units'] = np.bytes_('hours since 1900-01-01')
        tv.make_scale('time')
        pts = f.create_dataset('points', data=np.arange(n, dtype='f8'))
        pts.make_scale('points')
        latv = f.create_dataset(
            'latitude', data=lat2d.ravel().astype(np.float32))
        lonv = f.create_dataset(
            'longitude', data=lon2d.ravel().astype(np.float32))
        for d in (latv, lonv):
            d.dims[0].attach_scale(pts)
        for feat in features:
            arr = (np.asarray(data[feat], dtype=np.float32)
                   if data is not None and feat in data
                   else RANDOM_GENERATOR.random((t, s1, s2)).astype(
                       np.float32))
            flat = arr.reshape(t, n)
            if space_first:
                ds = f.create_dataset(feat, data=flat.T)
                ds.dims[0].attach_scale(pts)
                ds.dims[1].attach_scale(tv)
            else:
                ds = f.create_dataset(feat, data=flat)
                ds.dims[0].attach_scale(tv)
                ds.dims[1].attach_scale(pts)
            for k, v in ((var_attrs or {}).get(feat, {})).items():
                ds.attrs[k] = v
        if with_topography:
            topo = f.create_dataset(
                'topography',
                data=(RANDOM_GENERATOR.random(n) * 1000).astype(
                    np.float32))
            topo.dims[0].attach_scale(pts)
    return path


def make_fake_h5_file(path, shape, features, start='2023-01-01',
                      freq='h', scale_factor=100.0,
                      lat_range=(40.0, 39.0), lon_range=(-105.5, -104.3),
                      value_range=(0, 20)):
    """Write a rex-style flattened H5 via h5py (CPU machines only):
    structured 'meta', byte-string 'time_index' in pandas' string form,
    scaled uint16 (time, sites) datasets, drawn from
    ``RANDOM_GENERATOR`` as the JAX package's helper draws them."""
    import h5py

    s1, s2, t = shape
    lat = np.linspace(*lat_range, s1)
    lon = np.linspace(*lon_range, s2)
    lat2d, lon2d = np.meshgrid(lat, lon, indexing='ij')
    meta = np.zeros(s1 * s2, dtype=[('latitude', 'f4'),
                                    ('longitude', 'f4'),
                                    ('elevation', 'f4')])
    meta['latitude'] = lat2d.ravel()
    meta['longitude'] = lon2d.ravel()
    meta['elevation'] = RANDOM_GENERATOR.random(s1 * s2) * 1000
    time_index = _time_index(start, freq, t)

    with h5py.File(path, 'w') as f:
        f.create_dataset('meta', data=meta)
        f.create_dataset('time_index', data=np.array(
            [ts.encode() for ts in format_timestamps(time_index)]))
        for feat in features:
            lo, hi = value_range
            arr = lo + (hi - lo) * RANDOM_GENERATOR.random((t, s1 * s2))
            ds = f.create_dataset(
                feat, data=(arr * scale_factor).astype(np.uint16))
            ds.attrs['scale_factor'] = scale_factor
    return path


def make_fake_dual(shape_lr, s_enhance, t_enhance, features,
                   with_obs=False):
    """(low_res, high_res[, obs]) PairedDataset where low_res is an
    exact coarsening of high_res (the JAX package's helper)."""
    from sup3r_tpu_torch.ops.coarsen import (
        spatial_coarsening,
        temporal_coarsening,
    )

    s1, s2, t = shape_lr
    hr = make_fake_dset((s1 * s_enhance, s2 * s_enhance, t * t_enhance),
                        features)
    lr_data = temporal_coarsening(
        spatial_coarsening(hr.data[None], s_enhance)[0][None],
        t_enhance, 'average')[0]
    lr = GridDataset(
        lr_data, features,
        lat_lon=hr.lat_lon[::s_enhance, ::s_enhance],
        time_index=hr.time_index[::t_enhance])
    if with_obs:
        obs_data = hr.data.copy()
        mask = RANDOM_GENERATOR.random(obs_data.shape) > 0.1
        obs_data[mask] = np.nan
        obs = GridDataset(obs_data, [f'{f}_obs' for f in features],
                          lat_lon=hr.lat_lon, time_index=hr.time_index)
        return PairedDataset(low_res=lr, high_res=hr, obs=obs)
    return PairedDataset(low_res=lr, high_res=hr)


def make_fake_topo_nc_file(path, shape, lat_range=(40.2, 38.8),
                           lon_range=(-105.7, -104.1), data=None):
    """Write a NetCDF3 topography source (via scipy): one static
    ``topography`` variable on a (lat, lon) grid of ``shape`` (s1, s2),
    finer than the low-res input it serves, with no time axis. Values
    are ``RANDOM_GENERATOR`` draws in U(0, 1000) (metres, as the H5
    helper's ``elevation``) unless ``data`` gives the (s1, s2) array."""
    from scipy.io import netcdf_file

    s1, s2 = shape
    if data is None:
        data = RANDOM_GENERATOR.random((s1, s2)) * 1000
    with netcdf_file(path, 'w') as f:
        f.createDimension('lat', s1)
        f.createDimension('lon', s2)
        f.createVariable('lat', 'f4', ('lat',))[:] = np.linspace(
            *lat_range, s1)
        f.createVariable('lon', 'f4', ('lon',))[:] = np.linspace(
            *lon_range, s2)
        var = f.createVariable('topography', 'f4', ('lat', 'lon'))
        var[:] = np.asarray(data, dtype=np.float32)
        var.units = b'm'
    return path


def write_nc_factor_file(path, lat_lon, rasters, cfg=None):
    """Write a bias factor file as NetCDF3 (via scipy): 2D ``latitude``
    / ``longitude`` from ``lat_lon`` (s1, s2, 2), one float32 variable
    per ``rasters`` entry (``{name: (s1, s2, ...) array}``, the dict a
    calibration's ``run`` returns) and ``cfg`` as the JSON ``cfg``
    attribute (a calibration's ``factor_cfg()``). The runtime
    transforms read it as they read the H5 form ``write_outputs``
    writes."""
    from scipy.io import netcdf_file

    lat_lon = np.asarray(lat_lon, dtype=np.float32)
    with netcdf_file(path, 'w') as f:
        f.createDimension('south_north', lat_lon.shape[0])
        f.createDimension('west_east', lat_lon.shape[1])
        grid = ('south_north', 'west_east')
        f.createVariable('latitude', 'f4', grid)[:] = lat_lon[..., 0]
        f.createVariable('longitude', 'f4', grid)[:] = lat_lon[..., 1]
        for name, arr in rasters.items():
            arr = np.asarray(arr, dtype=np.float32)
            dims = []
            for size in arr.shape[2:]:
                dim = f'n{size}'
                if dim not in f.dimensions:
                    f.createDimension(dim, size)
                dims.append(dim)
            f.createVariable(name, 'f4', grid + tuple(dims))[:] = arr
        f.cfg = safe_serialize(cfg or {})
    return path


def spawn_ranks(argv, world, run_dir, timeout=120.0, attempts=2, env=None):
    """Run ``world`` processes ``argv + [rank, world, store]``, the ranks
    of one process group: each joins it with
    ``parallel.init_multihost(f'file://{store}', world, rank,
    backend='gloo')`` (a FileStore under ``run_dir``, fresh for every
    attempt: no port to collide on). They run gloo on the loopback with
    one thread, and the directory holding ``sup3r_tpu_torch`` leads
    ``PYTHONPATH``. Returns each rank's standard output.

    A group that times out or has a failed rank is killed (by handle) and
    started again, with twice the timeout, up to ``attempts`` times;
    then RuntimeError with the last attempt's output."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ if env is None else env)
    env.update(GLOO_SOCKET_IFNAME='lo', OMP_NUM_THREADS='1',
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in env.get('PYTHONPATH', '').split(
                       os.pathsep) if p]))
    last = ''
    for attempt in range(attempts):
        store = os.path.join(run_dir, f'store_{attempt}')
        procs = [subprocess.Popen(
            [*argv, str(rank), str(world), store], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env)
            for rank in range(world)]
        outs, timed_out = [], False
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                outs.append(p.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))[0])
            except subprocess.TimeoutExpired:
                timed_out = True
                outs.append('')
        if timed_out:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
            last = f'attempt {attempt}: timed out after {timeout} s'
        elif any(p.returncode for p in procs):
            last = '\n'.join(f'--- rank {r} (exit {p.returncode}):\n'
                             f'{o[-3000:]}' for r, (p, o) in enumerate(
                                 zip(procs, outs)))
        else:
            return outs
        timeout *= 2
    raise RuntimeError(f'rank group of {world} failed after {attempts} '
                       f'attempt(s):\n{last}')


def run_rank_scenarios(scenarios, out_dir, rank, world, store):
    """The body of a rank process of ``spawn_ranks``: join the group
    (gloo, the FileStore ``store``), run ``scenarios`` (``{name:
    fn(rank, world, out_dir)}``) in order and pickle ``{name: result}`` to
    ``<out_dir>/rank<rank>.pkl``; a scenario that raises gives ``{'error':
    its traceback}`` instead, and the next ones still run. The ranks
    leave the group together (a barrier, then ``destroy_process_group``):
    a rank that exits while another still talks to it aborts."""
    import pickle
    import traceback

    import torch
    import torch.distributed as dist

    from sup3r_tpu_torch.parallel import init_multihost

    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    init_multihost(f'file://{store}', world, rank, backend='gloo')
    results = {}
    for name, fn in scenarios.items():
        try:
            results[name] = fn(rank, world, out_dir)
        except Exception:  # noqa: BLE001 - reported to the test
            results[name] = {'error': traceback.format_exc()}
    with open(os.path.join(out_dir, f'rank{rank}.pkl'), 'wb') as f:
        pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


def rank_results(out_dir, world):
    """Each rank's ``run_rank_scenarios`` results, in rank order."""
    import pickle

    out = []
    for rank in range(world):
        with open(os.path.join(out_dir, f'rank{rank}.pkl'), 'rb') as f:
            out.append(pickle.load(f))
    return out


def _exchanges(layers, in_shape, gather_small=False, dtype=None):
    """[(kind, geometry, channels-last input shape, whether the input
    needs a gradient)] of a network's layers (a fused layer list, as
    ``train_fuse`` runs the generator) that move rows between ranks on a
    block of s1 rows: 'halo' ((before, after) rows) for a fused reflect
    block or a stride-1 'same' conv, 'rows' ((k, stride, padding)) for
    any other conv, and ('rows', 'whole') for a fused block whose route
    (``FusedReflectConv.route``, on an input of ``dtype``, float32 by
    default) under a shard with ``gather_small`` is the small kernel's
    gather (``SpatialShard.gather``). Stops at the row-parallel head
    (``Network.row_parallel_index``): the layers from it on run whole."""
    from types import SimpleNamespace

    import torch

    from sup3r_tpu_torch.models.fuse import FusedReflectConv
    from sup3r_tpu_torch.models.layers import Conv2D, Conv3D
    from sup3r_tpu_torch.models.network import Network

    ctx = {'spatial': SimpleNamespace(gather_small=gather_small)}
    head = Network(layers).row_parallel_index()
    out, shape, grad = [], tuple(in_shape), False
    for lyr in layers[:None if head is None else head - 1]:
        if isinstance(lyr, FusedReflectConv):
            x = SimpleNamespace(shape=(shape[0], shape[-1], *shape[1:-1]),
                                dtype=dtype or torch.float32)
            gathered = lyr.route(x, ctx) == 'gather_small'
            out.append(('rows', 'whole', shape, grad) if gathered
                       else ('halo', (1, 1), shape, grad))
            nxt = (*shape[:-1], lyr.conv.filters)
        else:
            if isinstance(lyr, (Conv2D, Conv3D)):
                k, stride = lyr.kernel_size[0], lyr.strides[0]
                if stride == 1 and lyr.padding == 'SAME':
                    out.append(('halo', ((k - 1) // 2, k // 2), shape,
                                grad))
                else:
                    out.append(('rows', (k, stride, lyr.padding), shape,
                                grad))
            nxt = lyr.out_shape(shape)
        # a layer with params (made at init) makes its output need a
        # gradient
        grad = grad or isinstance(lyr, FusedReflectConv) or any(
            hasattr(lyr, a) for a in ('filters', 'units'))
        shape = nxt
    return out


def _split(n, parts):
    base, extra = divmod(n, parts)
    starts = np.cumsum([0] + [base + (i < extra) for i in range(parts)])
    return [(int(starts[i]), int(starts[i + 1] - starts[i]))
            for i in range(parts)]


def _sent_rows(kind, geometry, n, sp, i, backward):
    """Rows rank ``i`` of ``sp`` sends in one exchange of a tensor of
    ``n`` global s1 rows (forward, or the backward's transpose)."""
    if kind == 'halo':
        before, after = geometry
        if backward:  # the halo rows' gradients go back to their owners
            return before * (i > 0) + after * (i < sp - 1)
        return after * (i > 0) + before * (i < sp - 1)
    if geometry == 'whole':  # every block to every rank, and the transpose
        count = _split(n, sp)[i][1]
        return n - count if backward else count * (sp - 1)
    k, stride, padding = geometry
    if padding == 'SAME':
        n_out = -(-n // stride)
        before = max((n_out - 1) * stride + k - n, 0) // 2
    else:
        n_out, before = (n - k) // stride + 1, 0
    needs = []
    for start, count in _split(n_out, sp):
        lo = start * stride - before
        hi = lo + (count - 1) * stride + k if count else lo
        needs.append((min(max(lo, 0), n), max(min(hi, n), 0)))
    owned = _split(n, sp)
    pairs = ([(owned[i], needs[j]) for j in range(sp) if j != i]
             if not backward else
             [(owned[j], needs[i]) for j in range(sp) if j != i])
    return sum(max(0, min(a + c, hi) - max(a, lo))
               for (a, c), (lo, hi) in pairs)


def expected_exchange_bytes(model, lr_shape, hr_shape, dp, sp, index,
                            do_gen=True, do_disc=True, itemsize=4):
    """{'halo': bytes, 'rows': bytes} that rank ``index`` of a ``space``
    axis ``sp`` wide sends in one ``run_gradient_descent`` of a
    ``Sup3rGan`` on a dp x sp mesh, counted from the layer configs and
    the global channels-last shapes alone: every exchange of the
    generator (fused, as ``train_fuse`` runs it) and of the
    discriminator's layers before its Flatten, once in each forward, and
    once more in each backward that needs the gradient of the layer's
    input. The generator's forward and the discriminator's on the true
    and the generated batch run once each; the generator's loss
    differentiates the discriminator on the generated batch through to
    its input, and the discriminator's loss differentiates both of its
    calls down to its first layer with params. Below the shard-aligned
    gate (``Sup3rGan.train_shard_aligned``) the generator's blocks that
    the small kernel takes gather their input instead of exchanging
    halo rows. Networks with Dropout run the discriminator more often:
    they are not counted here."""
    if model.generator.has_dropout or model.discriminator.has_dropout:
        raise ValueError('expected_exchange_bytes counts networks without '
                         'Dropout')
    lr_shape, hr_shape = (dp * (lr_shape[0] // dp), *lr_shape[1:]), (
        dp * (hr_shape[0] // dp), *hr_shape[1:])
    import torch

    from sup3r_tpu_torch.models.fuse import fuse_network
    from sup3r_tpu_torch.ops.conv_ad import shard_aligned_worthwhile

    aligned = model.train_shard_aligned
    if aligned is None:
        aligned = shard_aligned_worthwhile(sp)
    gen_layers = list(model.generator.layers)
    gen = _exchanges(fuse_network(gen_layers) if model.train_fuse
                     else gen_layers, lr_shape, gather_small=not aligned,
                     dtype=torch.float32 if itemsize == 4 else torch.bfloat16)
    disc = _exchanges(model.discriminator.layers, hr_shape)
    calls = [  # (exchanges, backward passes through each one's input)
        (gen, lambda e: int(do_gen and e[3])),
        (disc, lambda e: int(do_disc and e[3])),  # on the true batch
        (disc, lambda e: int(do_gen) + int(do_disc and e[3])),  # generated
    ]
    total = {'halo': 0, 'rows': 0}
    for exchanges, backward in calls:
        for e in exchanges:
            kind, geometry, shape, _ = e
            row = (shape[0] // dp) * int(np.prod(shape[2:])) * itemsize
            rows = _sent_rows(kind, geometry, shape[1], sp, index, False)
            back = _sent_rows(kind, geometry, shape[1], sp, index, True)
            total[kind] += row * (rows + int(backward(e)) * back)
    return total
