"""Meshes of ranks and the port's own collectives (the port of
``sup3r_tpu/parallel/mesh.py``).

One process per device, PyTorch's own idiom. A torch rank is a JAX host
with one device, so the port follows the JAX package's MULTI-HOST
convention:

  * training (``Sup3rGan.attach_mesh``): each rank feeds its local rows
    of the batch; params and optimizer state are the same on every rank
    (``replicate`` broadcasts the first rank's); the losses are computed
    on gathered tensors (``all_gather_rows``), so every rank reports the
    global batch's losses, and the gradients are summed over the ranks
    (``all_reduce_``) before each update;
  * dp x sp training (``get_mesh_2d``): each rank also holds a block of
    each sample's s1 rows, and the networks' exchanges between ranks
    are differentiable: ``halo_exchange``'s backward sends each halo
    row's gradient to its owner, ``redistribute_rows`` (a strided or
    'valid' conv's input rows) has its exact transpose, the ``space``
    gather's backward is the rank's own block and ``sum_over_ranks``'s
    (a row-parallel Dense) is the identity;
  * inference, chunk fan-out (``use_mesh=True``): each rank runs its
    share of every device batch of chunks;
  * inference, spatial (``use_mesh='spatial'``): each rank holds a
    block of s1 rows of every chunk (``shard_spatial``) and every conv
    exchanges its boundary rows with the neighbouring ranks
    (``halo_exchange``) before it convolves.

torch has no SPMD partitioner, so every collective is explicit and this
module counts what each one sends (``Mesh.counters``). Backends: NCCL on
the card, gloo on the CPU and for ranks that share one card (NCCL cannot
put two ranks on one device). Where the backend is gloo and a tensor is
on the card, a collective stages it through host memory: that is
transport, the compute stays on the card.

A mesh joins the process group a launcher describes (torchrun's
``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``) if there
is none yet. Without a process group and without a launcher a mesh is a
world of one rank on this process's device, and its collectives do
nothing.
"""

import logging
import os
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

from sup3r_tpu_torch.utilities import resolve_device

logger = logging.getLogger(__name__)

#: the variables a launcher (torchrun) sets for ``init_multihost()``
LAUNCHER_ENV = ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')


class Mesh:
    """A mesh of ranks, one device each: the port's counterpart of
    ``jax.sharding.Mesh`` (torch's ``DeviceMesh`` needs a process group
    even for a world of one, which this mesh does not).

    ``devices`` is the array of global ranks, shaped like the mesh;
    ``shape`` maps each axis name to its size; ``device`` is this rank's
    device. ``group(axis)`` is the process group of the ranks along
    ``axis`` through this rank (of all the mesh's ranks for
    ``axis=None``), None without a process group.
    ``counters`` holds the bytes this rank sent and the number of calls
    of each kind of collective ('halo', 'allreduce', 'gather',
    'broadcast'), as ``<kind>_bytes`` / ``<kind>_ops``."""

    def __init__(self, ranks, axis_names, device, groups, rank):
        self.devices = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        self.device = device
        self.rank = rank
        self._groups = dict(groups)
        self.coords = tuple(int(c) for c in
                            np.argwhere(self.devices == rank)[0])
        self.backend = dist.get_backend() if dist.is_initialized() else None
        self.counters = Counter()

    def __repr__(self):
        return (f'Mesh({self.shape}, rank={self.rank}, '
                f'device={self.device}, backend={self.backend})')

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def group(self, axis=None):
        return self._groups[axis]

    def axis_index(self, axis):
        """This rank's position along ``axis``."""
        return self.coords[self.axis_names.index(axis)]

    def axis_ranks(self, axis):
        """The global ranks along ``axis`` through this rank, in order."""
        idx = list(self.coords)
        idx[self.axis_names.index(axis)] = slice(None)
        return [int(r) for r in self.devices[tuple(idx)]]

    def count(self, kind, nbytes):
        self.counters[f'{kind}_bytes'] += int(nbytes)
        self.counters[f'{kind}_ops'] += 1

    def reset_counters(self):
        self.counters.clear()

    def staged(self, tensor):
        """Whether a collective must take ``tensor`` through host
        memory (gloo and a tensor on the card)."""
        return self.backend == 'gloo' and tensor.is_cuda


def _world(devices):
    """(this rank, world size) of the default process group, joined
    first from a launcher's environment when there is one and no group
    yet (gloo for a CPU mesh); (0, 1) without either."""
    if not dist.is_initialized() and all(v in os.environ
                                         for v in LAUNCHER_ENV):
        cpu = devices is not None and torch.device(devices).type == 'cpu'
        init_multihost(backend='gloo' if cpu else None)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _rank_device(devices):
    """This rank's device: ``devices`` (a device or its name), else the
    rank's card (the current CUDA device, which ``init_multihost`` sets);
    a card that is not there raises."""
    if devices is not None:
        return resolve_device(devices)
    resolve_device('cuda')
    return torch.device('cuda', torch.cuda.current_device())


def _new_group(ranks):
    """The process group of ``ranks`` (every rank of the world must call
    this, members or not), or None without a process group."""
    if not dist.is_initialized():
        return None
    if list(ranks) == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group([int(r) for r in ranks])


def get_mesh(n_devices=None, axis='data', devices=None):
    """A 1D mesh over the first ``n_devices`` ranks of the world (all by
    default); ``devices`` is this rank's device (default: its card).

    Raises if the world has fewer than ``n_devices`` ranks: a caller
    asking for an n-wide mesh must not silently get a narrower one.
    Every rank of the world must call this (a mesh over some of them
    makes a process group); a rank outside the mesh gets None. Without a
    process group it joins the one a launcher's environment describes;
    without either the mesh is a world of one rank on this process's
    device."""
    rank, world = _world(devices)
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(
            f'get_mesh: requested a {n}-device mesh but only {world} '
            f'rank(s) are available')
    ranks = list(range(n))
    group = _new_group(ranks)
    if rank not in ranks:
        return None
    return Mesh(ranks, (axis,), _rank_device(devices),
                {axis: group, None: group}, rank)


def get_mesh_2d(dp, sp, axes=('data', 'space'), devices=None):
    """A 2D (dp x sp) mesh over the first dp * sp ranks: the layout of
    data parallelism composed with spatial decomposition, with its
    per-axis groups (``shard_batch_spatial`` cuts a rank's block;
    ``Sup3rGan.attach_mesh`` trains on it). Raises when the world has
    fewer than dp * sp ranks."""
    rank, world = _world(devices)
    dp, sp = int(dp), int(sp)
    if dp * sp > world:
        raise ValueError(
            f'get_mesh_2d: requested a {dp}x{sp} mesh but only {world} '
            f'rank(s) are available')
    ranks = np.arange(dp * sp).reshape(dp, sp)
    groups = {None: _new_group(ranks.ravel())}
    # every rank creates every group, in one order
    for j in range(sp):
        g = _new_group(ranks[:, j])
        if rank in ranks[:, j]:
            groups[axes[0]] = g
    for i in range(dp):
        g = _new_group(ranks[i])
        if rank in ranks[i]:
            groups[axes[1]] = g
    if rank >= dp * sp:
        return None
    return Mesh(ranks, axes, _rank_device(devices), groups, rank)


def is_multihost(mesh):
    """Whether the mesh spans other processes: every rank is its own
    process, so any mesh of more than one rank does."""
    return mesh.size > 1


def _block(array, dim, n, index, what):
    """Block ``index`` of ``n`` equal blocks of ``array`` along
    ``dim``."""
    size = array.shape[dim]
    if size % n:
        raise ValueError(
            f'{what}: dim {dim} of size {size} is not divisible by the '
            f'{n}-rank mesh axis')
    step = size // n
    if isinstance(array, torch.Tensor):
        return array.narrow(dim, index * step, step)
    return np.take(array, range(index * step, (index + 1) * step),
                   axis=dim)


def _place(mesh, array):
    return torch.as_tensor(np.ascontiguousarray(array), dtype=torch.float32,
                           device=mesh.device)


def shard_batch(mesh, *arrays, axis='data'):
    """This rank's rows of each array's leading (batch / chunk) dim,
    split in equal blocks over the mesh's ``axis``, as float32 tensors on
    the rank's device. Every rank passes the same global arrays; a
    leading dim the axis does not divide raises. (A training step takes
    a rank's own rows directly: ``Sup3rGan.run_gradient_descent``.)"""
    n, index = mesh.shape[axis], mesh.axis_index(axis)
    out = tuple(_place(mesh, _block(np.asarray(a), 0, n, index,
                                    'shard_batch')) for a in arrays)
    return out[0] if len(out) == 1 else out


def shard_batch_spatial(mesh, *arrays, batch_axis='data',
                        space_axis='space', spatial_dim=1):
    """This rank's block of each array: the leading (batch) dim split
    over ``batch_axis`` and ``spatial_dim`` over ``space_axis`` (dp x sp
    on a :func:`get_mesh_2d` mesh). Arrays of rank <= ``spatial_dim``
    (per-sample weights) split on the batch dim only. A dim its axis
    does not divide raises: an uneven split would change each block's
    halo geometry."""
    dp, sp = mesh.shape[batch_axis], mesh.shape[space_axis]
    out = []
    for a in arrays:
        a = _block(np.asarray(a), 0, dp, mesh.axis_index(batch_axis),
                   'shard_batch_spatial')
        if a.ndim > spatial_dim:
            a = _block(a, spatial_dim, sp, mesh.axis_index(space_axis),
                       'shard_batch_spatial')
        out.append(_place(mesh, a))
    return out[0] if len(out) == 1 else tuple(out)


def shard_spatial(mesh, array, axis='data', dim=1):
    """This rank's block of ``array``'s spatial dim ``dim`` (s1 of an
    (n, s1, s2, ...) chunk), split in equal blocks over the mesh's
    ``axis``: the spatial domain decomposition of ONE chunk across
    ranks. ``array.shape[dim]`` must be divisible by the axis size (an
    uneven split would change each block's halo geometry). A numpy
    array becomes a float32 tensor on the rank's device; a tensor stays
    where it is."""
    block = _block(array, dim, mesh.shape[axis], mesh.axis_index(axis),
                   'shard_spatial')
    if isinstance(block, torch.Tensor):
        return block
    return _place(mesh, block)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@torch.no_grad()
def replicate(mesh, tree):
    """Make every tensor of a tree (params, optimizer state: dicts, lists
    and tuples of tensors) the same on every rank of the mesh: the mesh's
    first rank's values, broadcast into each rank's tensors in place.
    Returns the tree."""
    group = mesh.group()
    if group is None:
        return tree
    src = int(mesh.devices.flat[0])
    for t in _tensors(tree):
        buf = t.detach().cpu() if mesh.staged(t) else t.detach()
        dist.broadcast(buf, src, group=group)
        if buf is not t:
            t.copy_(buf)
        mesh.count('broadcast', t.numel() * t.element_size())
    return tree


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, local_device_ids=None, backend=None):
    """Join this process to the run's process group as one rank: the
    port of the JAX package's multi-host set-up, over
    ``torch.distributed.init_process_group``.

    With no args, reads a launcher's variables (torchrun's ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, and ``LOCAL_RANK``
    for the card). With an explicit ``coordinator_address`` ('host:port',
    or an init method such as 'file:///path/store'), ``num_processes``
    and ``process_id`` are required and validated here, so a bad rank
    wiring fails with a readable message instead of a hang at the
    rendezvous. ``local_device_ids`` is the one card this rank uses (a
    rank owns one device). ``backend`` is 'nccl' (default: each rank on
    its own card) or 'gloo' (the CPU, or ranks that share a card).

    Returns (rank, world size); raises RuntimeError if the process group
    already exists with a different rank or size."""
    kwargs = {}
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError(
                'init_multihost: explicit coordinator_address '
                'requires num_processes and process_id')
        num_processes = int(num_processes)
        process_id = int(process_id)
        if num_processes < 1:
            raise ValueError(
                f'init_multihost: num_processes={num_processes} '
                'must be >= 1')
        if not 0 <= process_id < num_processes:
            raise ValueError(
                f'init_multihost: process_id={process_id} outside '
                f'[0, {num_processes})')
        address = str(coordinator_address)
        kwargs = dict(init_method=(address if '://' in address
                                   else f'tcp://{address}'),
                      world_size=num_processes, rank=process_id)
    elif not dist.is_initialized():
        missing = [v for v in LAUNCHER_ENV if v not in os.environ]
        if missing:
            raise ValueError(
                'init_multihost: no coordinator_address and no launcher '
                f'environment (missing {missing}); pass '
                'coordinator_address, num_processes and process_id')
        kwargs = dict(init_method='env://')
    backend = backend or 'nccl'
    if local_device_ids is not None:
        ids = list(local_device_ids)
        if len(ids) != 1:
            raise ValueError(
                f'init_multihost: local_device_ids={ids}: a rank owns one '
                'device')
        card = ids[0]
    else:
        card = int(os.environ.get('LOCAL_RANK', 0))
    if local_device_ids is not None or backend == 'nccl':
        resolve_device('cuda')
        torch.cuda.set_device(card % torch.cuda.device_count())
    if dist.is_initialized():
        # reuse is only safe when the live group matches what the caller
        # asked for: otherwise their rank wiring is wrong
        if kwargs and (dist.get_world_size() != kwargs['world_size']
                       or dist.get_rank() != kwargs['rank']):
            raise RuntimeError(
                'init_multihost: the process group already exists as '
                f'rank {dist.get_rank()} of {dist.get_world_size()}, but '
                f'this call requested rank {kwargs["rank"]} of '
                f'{kwargs["world_size"]}')
        logger.info('init_multihost: the process group already exists '
                    'with matching parameters; reusing it.')
    else:
        dist.init_process_group(backend, **kwargs)
    return dist.get_rank(), dist.get_world_size()


# ----------------------------------------------------------------------
# collectives (no-ops on a mesh without a process group)
def even_split(n, parts):
    """[(start, count)] of ``n`` rows split over ``parts`` ranks: an even
    split, the first ``n % parts`` ranks taking one row more (a rank may
    hold none)."""
    base, extra = divmod(int(n), int(parts))
    out, start = [], 0
    for i in range(int(parts)):
        count = base + (i < extra)
        out.append((start, count))
        start += count
    return out


def _exchange(mesh, group, sends, recvs, like, kind):
    """One ``batch_isend_irecv``: ``sends`` is [(peer, tensor)],
    ``recvs`` [(peer, shape)]; returns the received tensors (dtype and
    device of ``like``), in the order of ``recvs``. Empty messages are
    skipped on both sides (every rank knows every size). The bytes sent
    are counted under ``kind``."""
    staged = mesh.staged(like)
    ops, out = [], []
    for peer, t in sends:
        if t.numel():
            t = t.contiguous()
            t = t.cpu() if staged else t
            ops.append(dist.P2POp(dist.isend, t, peer, group))
            mesh.count(kind, t.numel() * t.element_size())
    for peer, shape in recvs:
        buf = torch.empty(shape, dtype=like.dtype,
                          device='cpu' if staged else like.device)
        if buf.numel():
            ops.append(dist.P2POp(dist.irecv, buf, peer, group))
        out.append(buf)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [t.to(like.device) if staged else t for t in out]


def _rows_shape(x, dim, n):
    return (*x.shape[:dim], n, *x.shape[dim + 1:])


def _halo_send_recv(mesh, x, dim, before, after, axis, kind='halo'):
    """(rows above, rows below) this rank's block: the previous rank's
    last ``before`` rows and the next rank's first ``after`` rows, empty
    (0 rows) at the global edges."""
    group, peers = mesh.group(axis), mesh.axis_ranks(axis)
    i, n = mesh.axis_index(axis), x.shape[dim]
    sends, recvs = [], []
    if i > 0:  # my first rows are the previous rank's bottom halo
        sends.append((peers[i - 1], x.narrow(dim, 0, after)))
        recvs.append((peers[i - 1], _rows_shape(x, dim, before)))
    if i < len(peers) - 1:  # my last rows are the next rank's top halo
        sends.append((peers[i + 1], x.narrow(dim, n - before, before)))
        recvs.append((peers[i + 1], _rows_shape(x, dim, after)))
    got = _exchange(mesh, group, sends, recvs, x, kind)
    top = got.pop(0) if i > 0 else x.new_empty(_rows_shape(x, dim, 0))
    bottom = got.pop(0) if i < len(peers) - 1 else x.new_empty(
        _rows_shape(x, dim, 0))
    return top, bottom


class _HaloExchange(torch.autograd.Function):
    """The halo exchange and its transpose. Forward: the neighbours'
    boundary rows. Backward: the gradient of each received row goes
    back to the rank that owns the row, which adds it to that row's
    gradient (one ``batch_isend_irecv`` each way, counted as 'halo')."""

    @staticmethod
    def forward(ctx, x, mesh, dim, before, after, axis):
        ctx.args = (mesh, dim, before, after, axis)
        ctx.shape = x.shape
        return _halo_send_recv(mesh, x, dim, before, after, axis)

    @staticmethod
    def backward(ctx, g_top, g_bottom):
        mesh, dim, before, after, axis = ctx.args
        group, peers = mesh.group(axis), mesh.axis_ranks(axis)
        i = mesh.axis_index(axis)
        dx = g_top.new_zeros(ctx.shape)
        n = dx.shape[dim]
        sends, recvs = [], []
        if i > 0:  # my top halo's gradient belongs to the previous rank
            sends.append((peers[i - 1], g_top))
            recvs.append((peers[i - 1], _rows_shape(dx, dim, after)))
        if i < len(peers) - 1:
            sends.append((peers[i + 1], g_bottom))
            recvs.append((peers[i + 1], _rows_shape(dx, dim, before)))
        got = _exchange(mesh, group, sends, recvs, dx, 'halo')
        if i > 0:
            dx.narrow(dim, 0, after).add_(got.pop(0))
        if i < len(peers) - 1:
            dx.narrow(dim, n - before, before).add_(got.pop(0))
        return dx, None, None, None, None, None


def halo_exchange(mesh, x, dim, before=1, after=1, axis=None):
    """The rows of the neighbouring ranks' blocks next to this rank's
    block of ``x`` along ``dim``: (the last ``before`` rows of the
    previous rank along ``axis``, the first ``after`` rows of the next),
    None at the global edges (and on a mesh without a process group).
    One ``batch_isend_irecv`` for both neighbours; differentiable
    (``_HaloExchange``: the backward sends each halo row's gradient to
    its owner, one ``batch_isend_irecv`` too)."""
    axis = axis or mesh.axis_names[0]
    if mesh.group(axis) is None or mesh.shape[axis] == 1:
        return None, None
    if torch.is_grad_enabled() and x.requires_grad:
        top, bottom = _HaloExchange.apply(x, mesh, dim, before, after, axis)
    else:
        top, bottom = _halo_send_recv(mesh, x, dim, before, after, axis)
    i = mesh.axis_index(axis)
    return (top if i > 0 else None,
            bottom if i < mesh.shape[axis] - 1 else None)


def _redistribute(mesh, x, dim, axis, owned, needs, kind='rows'):
    """Rows [lo, hi) of the global tensor for this rank (``needs[i]``),
    from the ranks that own them (``owned``: [(start, count)] per rank);
    the received pieces and the rank's own are concatenated in row
    order."""
    group, peers = mesh.group(axis), mesh.axis_ranks(axis)
    i = mesh.axis_index(axis)
    start, count = owned[i]
    sends, recvs, pieces = [], [], []
    for j, peer in enumerate(peers):
        lo, hi = needs[j]
        a, b = max(lo, start), min(hi, start + count)
        if j != i and b > a:
            sends.append((peer, x.narrow(dim, a - start, b - a)))
    lo, hi = needs[i]
    for j, peer in enumerate(peers):
        s, c = owned[j]
        a, b = max(lo, s), min(hi, s + c)
        if b > a:
            pieces.append((j, a, b))
            if j != i:
                recvs.append((peer, _rows_shape(x, dim, b - a)))
    got = iter(_exchange(mesh, group, sends, recvs, x, kind))
    parts = [x.narrow(dim, a - start, b - a) if j == i else next(got)
             for j, a, b in pieces]
    if not parts:
        return x.new_empty(_rows_shape(x, dim, 0))
    return torch.cat(parts, dim=dim) if len(parts) > 1 else parts[0]


def _redistribute_grad(mesh, g, dim, axis, owned, needs, shape,
                       kind='rows'):
    """The transpose of ``_redistribute``: each received row's gradient
    goes back to its owner, which adds it to the row's gradient."""
    group, peers = mesh.group(axis), mesh.axis_ranks(axis)
    i = mesh.axis_index(axis)
    start, count = owned[i]
    lo, hi = needs[i]
    dx = g.new_zeros(shape)
    sends, recvs, mine = [], [], []
    for j, peer in enumerate(peers):
        s, c = owned[j]
        a, b = max(lo, s), min(hi, s + c)
        if b <= a:
            continue
        piece = g.narrow(dim, a - lo, b - a)
        if j == i:
            mine.append((a, piece))
        else:
            sends.append((peer, piece))
    for j, peer in enumerate(peers):
        a, b = max(needs[j][0], start), min(needs[j][1], start + count)
        if j != i and b > a:
            recvs.append((peer, a, _rows_shape(g, dim, b - a)))
    got = _exchange(mesh, group, sends, [(p, s) for p, _, s in recvs], g,
                    kind)
    for a, piece in mine:
        dx.narrow(dim, a - start, piece.shape[dim]).add_(piece)
    for (_, a, _), piece in zip(recvs, got):
        dx.narrow(dim, a - start, piece.shape[dim]).add_(piece)
    return dx


class _Redistribute(torch.autograd.Function):
    """``redistribute_rows`` and its exact transpose."""

    @staticmethod
    def forward(ctx, x, mesh, dim, axis, owned, needs):
        ctx.args = (mesh, dim, axis, owned, needs)
        ctx.shape = x.shape
        return _redistribute(mesh, x, dim, axis, owned, needs)

    @staticmethod
    def backward(ctx, g):
        mesh, dim, axis, owned, needs = ctx.args
        return (_redistribute_grad(mesh, g, dim, axis, owned, needs,
                                   ctx.shape), None, None, None, None, None)


def redistribute_rows(mesh, x, n_rows, needs, dim=2, axis=None):
    """This rank's rows ``needs[i] = (lo, hi)`` of a tensor of ``n_rows``
    global rows along ``dim`` held over the ranks of ``axis`` in the even
    split (``even_split``), each rank holding its block ``x``: every rank
    passes every rank's ``needs`` (they follow from the shapes), sends
    the rows others need and receives the rows it needs, one
    ``batch_isend_irecv`` (counted as 'rows'). The rows a strided or
    'valid' conv's output block reads. Differentiable: the backward
    sends each received row's gradient back to its owner."""
    axis = axis or mesh.axis_names[0]
    owned = even_split(n_rows, mesh.shape[axis])
    needs = [(int(lo), int(hi)) for lo, hi in needs]
    if mesh.group(axis) is None or mesh.shape[axis] == 1:
        lo, hi = needs[0]
        return x.narrow(dim, lo, hi - lo)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Redistribute.apply(x, mesh, dim, axis, owned, needs)
    return _redistribute(mesh, x, dim, axis, owned, needs)


def _all_gather_cat(mesh, x, axis, dim=0):
    group = mesh.group(axis)
    if group is None:
        return x
    staged = mesh.staged(x)
    src = x.detach().contiguous()
    src = src.cpu() if staged else src
    parts = [torch.empty_like(src) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, src, group=group)
    mesh.count('gather', src.numel() * src.element_size())
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out


class _GatherRows(torch.autograd.Function):
    """Differentiable all-gather along ``dim``. Every rank computes the
    SAME loss from the gathered tensor, so the gradient of this rank's
    block is its own slice of its own gradient (the sum over ranks that
    ``torch.distributed.nn.functional.all_gather``'s backward forms
    would be the axis size times it); the parameter gradients are then
    summed over the ranks once, by ``all_reduce_``."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.index, ctx.rows, ctx.dim = (mesh.axis_index(axis), x.shape[dim],
                                        dim)
        return _all_gather_cat(mesh, x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.index * ctx.rows, ctx.rows), None,
                None, None)


def all_gather_rows(mesh, x, axis=None, dim=0):
    """The blocks of ``x`` of every rank along ``axis``, stacked in rank
    order on ``dim`` (the batch rows on dim 0; a sample's s1 blocks of a
    channels-last tensor on dim 1): every block the same size
    (differentiable; see ``_GatherRows``). The tensor itself on a mesh
    without a process group."""
    axis = axis or mesh.axis_names[0]
    if mesh.group(axis) is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherRows.apply(x, mesh, axis, dim)
    return _all_gather_cat(mesh, x, axis, dim)


class _SumOverRanks(torch.autograd.Function):
    """The sum of a tensor over the ranks of an axis, when every rank
    then computes the SAME loss from the sum: the gradient of this
    rank's term is the sum's gradient itself (the backward is the
    identity, no collective)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _psum(mesh, x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def _psum(mesh, x, axis):
    out = x.detach().clone()
    buf = out.cpu() if mesh.staged(out) else out
    dist.all_reduce(buf, group=mesh.group(axis))
    mesh.count('psum', buf.numel() * buf.element_size())
    return buf.to(out.device)


def sum_over_ranks(mesh, x, axis=None):
    """``x`` summed over the ranks along ``axis`` (a row-parallel
    ``Dense``'s partial products), the same on every rank of the axis;
    differentiable for a loss that every rank computes alike
    (``_SumOverRanks``). Counted as 'psum'."""
    axis = axis or mesh.axis_names[0]
    if mesh.group(axis) is None or mesh.shape[axis] == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _SumOverRanks.apply(x, mesh, axis)
    return _psum(mesh, x, axis)


@torch.no_grad()
def all_reduce_(mesh, tensors, axis=None):
    """Sum ``tensors`` over the ranks along ``axis`` (over all of the
    mesh's ranks for ``axis=None``), in place, as ONE flat buffer per
    dtype (one collective per dtype, not per tensor). Returns
    ``tensors``."""
    group = mesh.group(axis)
    tensors = list(tensors)
    if group is None or not tensors:
        return tensors
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        buf = flat.cpu() if mesh.staged(flat) else flat
        dist.all_reduce(buf, group=group)
        mesh.count('allreduce', buf.numel() * buf.element_size())
        buf = buf.to(flat.device)
        start = 0
        for t in same:
            t.copy_(buf[start:start + t.numel()].view_as(t))
            start += t.numel()
    return tensors


@torch.no_grad()
def gather_rows(mesh, x, dst, dim=0, axis=None):
    """``x`` of every rank along ``axis`` concatenated on ``dim`` in rank
    order, on the rank ``dst`` (its position along the axis); None on
    the others. The tensor itself on a mesh without a process group."""
    axis = axis or mesh.axis_names[0]
    group = mesh.group(axis)
    if group is None:
        return x
    staged = mesh.staged(x)
    src = x.contiguous()
    src = src.cpu() if staged else src
    me = mesh.axis_index(axis) == dst
    parts = ([torch.empty_like(src) for _ in range(mesh.shape[axis])]
             if me else None)
    dist.gather(src, parts, dst=mesh.axis_ranks(axis)[dst], group=group)
    mesh.count('gather', src.numel() * src.element_size())
    if not me:
        return None
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out


def broadcast_object(mesh, obj):
    """The mesh's first rank's ``obj`` (any picklable object) on every
    rank."""
    group = mesh.group()
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=int(mesh.devices.flat[0]),
                               group=group)
    return box[0]


def all_gather_object(mesh, obj, axis=None):
    """Every rank's ``obj`` (of the ranks along ``axis``; of all the
    mesh's ranks for None), in rank order, on every rank."""
    group = mesh.group(axis)
    if group is None:
        return [obj]
    out = [None] * (mesh.size if axis is None else mesh.shape[axis])
    dist.all_gather_object(out, obj, group=group)
    return out


class SpatialShard:
    """The spatial context of a network run on a block of s1 rows (the
    ``spatial`` entry of a layer's ``ctx``): this rank's position on the
    mesh's ``axis``, its neighbours' boundary rows (``halo``), the
    split of a tensor's global s1 rows over the axis (``block``: the
    even split of ``even_split``, which a rank's input block of equal
    rows is too) and its rows of a full-size raster (``rows``). With
    ``gather_small`` the fused blocks that the ``small_reflect_conv``
    kernel takes gather their input over the axis (``gather``) and run
    the kernel on the whole tensor (``models.fuse.FusedReflectConv``);
    without, every fused block exchanges halo rows."""

    def __init__(self, mesh, axis=None, gather_small=False):
        self.mesh = mesh
        self.axis = axis or mesh.axis_names[0]
        self.index = mesh.axis_index(self.axis)
        self.size = mesh.shape[self.axis]
        self.gather_small = bool(gather_small)

    @property
    def first(self):
        return self.index == 0

    @property
    def last(self):
        return self.index == self.size - 1

    def halo(self, x, dim=2, before=1, after=1):
        """(rows above, rows below) this rank's block of ``x`` on
        ``dim``; None at the global edges. Differentiable."""
        return halo_exchange(self.mesh, x, dim, before, after, self.axis)

    def split(self, n_rows):
        """[(start, count)] of every rank's rows of ``n_rows`` global
        rows."""
        return even_split(n_rows, self.size)

    def block(self, n_rows):
        """(start, count) of this rank's rows of ``n_rows`` global
        rows."""
        return self.split(n_rows)[self.index]

    def redistribute(self, x, n_rows, needs, dim=2):
        """This rank's rows ``needs[self.index]`` of a tensor split as
        ``split(n_rows)`` (``redistribute_rows``)."""
        return redistribute_rows(self.mesh, x, n_rows, needs, dim,
                                 self.axis)

    def gather(self, x, n_rows, dim=2):
        """The whole tensor of ``n_rows`` global rows along ``dim`` on
        every rank of the axis, from every rank's block
        (``redistribute_rows``, counted as 'rows'): the backward sends
        each row's gradient back to its owner, which sums them."""
        return self.redistribute(x, n_rows, [(0, n_rows)] * self.size, dim)

    def rows(self, full, dim, n_rows):
        """This rank's rows of a full-size tensor of ``n_rows`` rows
        along ``dim``."""
        if full.shape[dim] != n_rows:
            raise ValueError(
                f'a raster of {full.shape[dim]} rows on dim {dim} is not '
                f'the {n_rows} global rows of the activation it joins')
        start, count = self.block(n_rows)
        return full.narrow(dim, start, count)


def halo_bytes_from_compiled(mesh):
    """(bytes, calls) of the halo exchanges this rank sent since the
    mesh's counters were last reset. The JAX package parses the compiled
    SPMD program's collective-permutes; the port's halo exchanges are
    its own calls (``halo_exchange``), so it counts them as they run:
    there is no compiled program to parse."""
    return mesh.counters['halo_bytes'], mesh.counters['halo_ops']


def allreduce_bytes_from_compiled(mesh):
    """(bytes, calls) of the all-reduces and gathers this rank sent since
    the mesh's counters were last reset (the JAX package counts
    all-reduce, reduce-scatter and all-gather in the compiled program;
    the port counts its own ``all_reduce_`` / gathers as they run)."""
    c = mesh.counters
    return (c['allreduce_bytes'] + c['gather_bytes'],
            c['allreduce_ops'] + c['gather_ops'])
