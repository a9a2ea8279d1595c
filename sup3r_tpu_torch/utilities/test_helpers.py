"""Fake data for tests and on-card runs of the port (the counterparts
of ``make_fake_dset`` and ``make_fake_nc_file`` in
``sup3r_tpu/utilities/test_helpers.py``): an in-memory GridDataset,
NetCDF3 input through scipy, a NetCDF3 topography source and the NetCDF3
form of a bias factor file, without pandas or h5py, so a machine without
them can make its own input; ``spawn_ranks``, which starts a group of
rank processes for the multi-rank tests and runs; and
``expected_exchange_bytes``, the analytic count of the rows a dp x sp
train step's sharded layers exchange."""

import os
import subprocess
import time

import numpy as np

from sup3r_tpu_torch.preprocessing.grid import GridDataset
from sup3r_tpu_torch.utilities import RANDOM_GENERATOR, safe_serialize
from sup3r_tpu_torch.utilities.times import (
    date_range,
    infer_unit,
    seconds_since,
    timestamp,
)


def _time_index(start, freq, t):
    """``t`` timestamps from ``start`` every ``freq`` (a numpy timedelta
    unit such as 'h', or a ``timedelta64``)."""
    step = (freq if isinstance(freq, np.timedelta64)
            else np.timedelta64(1, freq))
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


def _exchanges(layers, in_shape, gather_small=False):
    """[(kind, geometry, channels-last input shape, whether the input
    needs a gradient)] of a network's layers (a fused layer list, as
    ``train_fuse`` runs the generator) that move rows between ranks on a
    block of s1 rows: 'halo' ((before, after) rows) for a fused reflect
    block or a stride-1 'same' conv, 'rows' ((k, stride, padding)) for
    any other conv, and ('rows', 'whole') for a fused block that the
    small kernel takes under ``gather_small`` (the gather of
    ``SpatialShard.gather``). Stops at the row-parallel head
    (``Network.row_parallel_index``): the layers from it on run whole."""
    from sup3r_tpu_torch.models.fuse import FusedReflectConv
    from sup3r_tpu_torch.models.layers import Conv2D, Conv3D
    from sup3r_tpu_torch.models.network import Network

    head = Network(layers).row_parallel_index()
    out, shape, grad = [], tuple(in_shape), False
    for lyr in layers[:None if head is None else head - 1]:
        if isinstance(lyr, FusedReflectConv):
            small = (gather_small and lyr.small_channel_kernel
                     and lyr.n_spatial == 3 and len(shape) == 5
                     and shape[-1] * lyr.conv.filters <= 32)
            out.append(('rows', 'whole', shape, grad) if small
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
    from sup3r_tpu_torch.models.fuse import fuse_network
    from sup3r_tpu_torch.ops.conv_ad import shard_aligned_worthwhile

    aligned = model.train_shard_aligned
    if aligned is None:
        aligned = shard_aligned_worthwhile(sp)
    gen_layers = list(model.generator.layers)
    gen = _exchanges(fuse_network(gen_layers) if model.train_fuse
                     else gen_layers, lr_shape,
                     gather_small=not aligned and itemsize == 4)
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
