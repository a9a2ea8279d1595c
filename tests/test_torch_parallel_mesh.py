"""The port's meshes of ranks (``sup3r_tpu_torch/parallel/mesh.py``):
``init_multihost``'s argument plumbing and validation with
``torch.distributed`` monkeypatched (the five cases of
tests/utilities/test_multihost.py), a mesh without a process group, and,
over four spawned ranks of one gloo group (``spawn_ranks``), the mesh
sizes, the halo exchange, the gathers, the all-reduce, the broadcasts,
``shard_batch`` / ``shard_spatial`` and the byte counters, each held to
numpy on the same arrays.

Run as a script (``python tests/test_torch_parallel_mesh.py out_dir rank
world store``) this file is one rank: it imports torch and the port
only."""

import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sup3r_tpu_torch.parallel import (
    allreduce_bytes_from_compiled,
    get_mesh,
    halo_bytes_from_compiled,
    init_multihost,
    replicate,
    shard_batch,
    shard_spatial,
)
from sup3r_tpu_torch.parallel.mesh import (
    all_gather_object,
    all_gather_rows,
    all_reduce_,
    broadcast_object,
    gather_rows,
    halo_exchange,
    is_multihost,
)
from sup3r_tpu_torch.utilities.test_helpers import (
    rank_results,
    run_rank_scenarios,
    spawn_ranks,
)

torch.set_num_threads(1)

WORLD = 4
#: the global arrays the ranks split: a channels-first (n, c, s1, s2)
#: tensor whose s1 rows the ranks hold 3 each, and a batch of 8 rows
HALO = np.random.default_rng(0).standard_normal(
    (2, 3, 3 * WORLD, 5)).astype(np.float32)
BATCH = np.random.default_rng(1).standard_normal((8, 4, 2)).astype(
    np.float32)


# ----------------------------------------------------------------------
# init_multihost with torch.distributed monkeypatched
def test_explicit_args_are_plumbed(monkeypatch):
    calls = {}
    monkeypatch.setattr(dist, 'init_process_group',
                        lambda backend, **kw: calls.update(backend=backend,
                                                           **kw))
    monkeypatch.setattr(dist, 'get_rank', lambda: 2)
    monkeypatch.setattr(dist, 'get_world_size', lambda: 4)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    monkeypatch.setattr(torch.cuda, 'set_device',
                        lambda i: calls.update(card=i))
    assert init_multihost('10.0.0.1:1234', num_processes=4, process_id=2,
                          local_device_ids=[1]) == (2, 4)
    assert calls == {'backend': 'nccl', 'init_method': 'tcp://10.0.0.1:1234',
                     'world_size': 4, 'rank': 2, 'card': 1}
    calls.clear()
    init_multihost('file:///tmp/store', 4, 2, backend='gloo')
    assert calls == {'backend': 'gloo', 'init_method': 'file:///tmp/store',
                     'world_size': 4, 'rank': 2}


def test_validation_errors(monkeypatch):
    monkeypatch.setattr(dist, 'init_process_group', lambda *a, **k: None)
    with pytest.raises(ValueError, match='requires num_processes'):
        init_multihost('10.0.0.1:1234')
    with pytest.raises(ValueError, match='outside'):
        init_multihost('10.0.0.1:1234', num_processes=4, process_id=4)
    with pytest.raises(ValueError, match='must be >= 1'):
        init_multihost('10.0.0.1:1234', num_processes=0, process_id=0)
    with pytest.raises(ValueError, match='one device'):
        init_multihost('10.0.0.1:1234', 2, 0, local_device_ids=[0, 1])
    for var in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match='launcher environment'):
        init_multihost()


def test_already_initialized_is_reused(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError('a live group must be reused')

    monkeypatch.setattr(dist, 'is_initialized', lambda: True)
    monkeypatch.setattr(dist, 'init_process_group', refuse)
    monkeypatch.setattr(dist, 'get_rank', lambda: 0)
    monkeypatch.setattr(dist, 'get_world_size', lambda: 1)
    assert init_multihost('10.0.0.1:1234', num_processes=1, process_id=0,
                          backend='gloo') == (0, 1)
    with pytest.raises(RuntimeError, match='requested rank 1 of 2'):
        init_multihost('10.0.0.1:1234', num_processes=2, process_id=1,
                       backend='gloo')


def test_other_runtime_errors_propagate(monkeypatch):
    def raise_other(*args, **kwargs):
        raise RuntimeError('coordination service unreachable')

    monkeypatch.setattr(dist, 'init_process_group', raise_other)
    with pytest.raises(RuntimeError, match='unreachable'):
        init_multihost('10.0.0.1:1234', num_processes=2, process_id=0,
                       backend='gloo')


def test_get_mesh_raises_on_too_few_devices(monkeypatch):
    """Without a process group the world is this process: a mesh of one
    rank, whose collectives do nothing; a wider mesh raises, and the
    default device is the card (none here: it raises)."""
    with pytest.raises(ValueError, match='requested a 999-device'):
        get_mesh(999, devices='cpu')
    mesh = get_mesh(devices='cpu')
    assert mesh.size == 1 and mesh.shape == {'data': 1}
    assert not is_multihost(mesh)
    x = torch.ones(2, 3)
    assert halo_exchange(mesh, x, 0) == (None, None)
    assert all_gather_rows(mesh, x) is x
    assert shard_batch(mesh, BATCH).shape == BATCH.shape
    assert halo_bytes_from_compiled(mesh) == (0, 0)
    assert allreduce_bytes_from_compiled(mesh) == (0, 0)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_mesh()


def test_get_mesh_joins_a_launcher_group(monkeypatch):
    """With a launcher's variables (torchrun's) and no process group,
    ``get_mesh`` joins the group they describe: here a gloo world of one
    on a free localhost port, whose collectives run."""
    import socket

    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    for var, value in (('RANK', '0'), ('WORLD_SIZE', '1'),
                       ('MASTER_ADDR', '127.0.0.1'),
                       ('MASTER_PORT', str(port))):
        monkeypatch.setenv(var, value)
    monkeypatch.setenv('GLOO_SOCKET_IFNAME', 'lo')
    try:
        mesh = get_mesh(devices='cpu')
        assert dist.is_initialized() and mesh.backend == 'gloo'
        x = torch.arange(6.0).view(2, 3)
        gathered = all_gather_rows(mesh, x)
        assert gathered is not x and torch.equal(gathered, x)
        assert halo_bytes_from_compiled(mesh) == (0, 0)
        assert allreduce_bytes_from_compiled(mesh) == (x.nbytes, 1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ----------------------------------------------------------------------
# the rank scenarios (run in the spawned ranks)
def _sizes(rank, world, out):
    mesh = get_mesh(devices='cpu')
    half = get_mesh(2, devices='cpu')
    try:
        get_mesh(999, devices='cpu')
        message = None
    except ValueError as e:
        message = str(e)
    # a second init_multihost with the live wiring reuses the group;
    # another wiring raises
    again = init_multihost('file:///unused', world, rank, backend='gloo')
    try:
        init_multihost('file:///unused', world + 1, rank, backend='gloo')
        rewired = None
    except RuntimeError as e:
        rewired = str(e)
    return {'size': mesh.size, 'half': None if half is None else half.size,
            'multihost': is_multihost(mesh), 'message': message,
            'again': again, 'rewired': rewired}


def _halo(rank, world, out):
    mesh = get_mesh(devices='cpu')
    x = torch.from_numpy(HALO[:, :, 3 * rank:3 * rank + 3])
    top, bottom = halo_exchange(mesh, x, 2, before=1, after=2)
    return {'top': None if top is None else top.numpy(),
            'bottom': None if bottom is None else bottom.numpy(),
            'halo': halo_bytes_from_compiled(mesh)}


def _collectives(rank, world, out):
    mesh = get_mesh(devices='cpu')
    x = torch.from_numpy(BATCH[2 * rank:2 * rank + 2]).requires_grad_(True)
    gathered = all_gather_rows(mesh, x)
    weight = torch.arange(gathered.numel(), dtype=torch.float32).view_as(
        gathered)
    (gathered * weight).sum().backward()
    sums = [torch.full((3,), float(rank)), torch.ones(2, 2),
            torch.full((1,), rank, dtype=torch.float64)]
    all_reduce_(mesh, sums)
    to_one = gather_rows(mesh, torch.full((1, 2), float(rank)), 1)
    seeded = torch.Generator().manual_seed(rank)
    tree = {'a': torch.randn(3, generator=seeded),
            'b': [torch.randn(2, 2, generator=seeded), {'c': torch.zeros(
                1, dtype=torch.int64) + rank}]}
    replicate(mesh, tree)
    return {'gathered': gathered.detach().numpy(),
            'grad': x.grad.numpy(), 'want_grad': weight[
                2 * rank:2 * rank + 2].numpy(),
            'sums': [t.numpy() for t in sums],
            'to_one': None if to_one is None else to_one.numpy(),
            'tree': [tree['a'].numpy(), tree['b'][0].numpy(),
                     tree['b'][1]['c'].numpy()],
            'object': broadcast_object(mesh, {'from': rank}),
            'objects': all_gather_object(mesh, rank),
            'allreduce': allreduce_bytes_from_compiled(mesh),
            'counters': dict(mesh.counters)}


def _shards(rank, world, out):
    mesh = get_mesh(devices='cpu')
    rows = shard_batch(mesh, BATCH)
    block = shard_spatial(mesh, HALO, dim=2)
    try:
        shard_spatial(mesh, np.zeros((1, 10, 16, 4, 2), np.float32))
        message = None
    except ValueError as e:
        message = str(e)
    return {'rows': rows.numpy(), 'block': block.numpy(),
            'message': message}


SCENARIOS = {'sizes': _sizes, 'halo': _halo, 'collectives': _collectives,
             'shards': _shards}


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """The scenarios' results of every rank of one 4-rank gloo group."""
    out = tmp_path_factory.mktemp('mesh_ranks')
    spawn_ranks([sys.executable, os.path.abspath(__file__), str(out)],
                WORLD, str(out), timeout=60)
    return rank_results(str(out), WORLD)


def _result(ranks, name, rank):
    res = ranks[rank][name]
    assert 'error' not in res, res['error']
    return res


def test_mesh_sizes_and_reuse(ranks):
    for rank in range(WORLD):
        res = _result(ranks, 'sizes', rank)
        assert res['size'] == WORLD and res['multihost']
        assert res['half'] == (2 if rank < 2 else None)
        assert 'requested a 999-device' in res['message']
        assert res['again'] == (rank, WORLD)
        assert 'already exists' in res['rewired']


def test_halo_exchange_rows_and_bytes(ranks):
    """Each rank gets the last row of the block above and the first two
    rows of the block below (none at the global edges), and counts the
    rows it sent: 2 up, 1 down."""
    plane = HALO[:, :, :1].nbytes
    for rank in range(WORLD):
        res = _result(ranks, 'halo', rank)
        top, bottom = res['top'], res['bottom']
        if rank == 0:
            assert top is None
        else:
            np.testing.assert_array_equal(
                top, HALO[:, :, 3 * rank - 1:3 * rank])
        if rank == WORLD - 1:
            assert bottom is None
        else:
            np.testing.assert_array_equal(
                bottom, HALO[:, :, 3 * rank + 3:3 * rank + 5])
        sent = 2 * plane * (rank > 0) + plane * (rank < WORLD - 1)
        assert res['halo'] == (sent, (rank > 0) + (rank < WORLD - 1))


def test_gathers_reduce_and_broadcast(ranks):
    """The differentiable gather stacks the ranks' rows in rank order and
    gives each rank its own rows' gradient; the all-reduce sums (one
    flat buffer a dtype); ``gather_rows`` lands on its rank only; the
    broadcasts take the first rank's values."""
    first = _result(ranks, 'collectives', 0)
    for rank in range(WORLD):
        res = _result(ranks, 'collectives', rank)
        np.testing.assert_array_equal(res['gathered'], BATCH)
        np.testing.assert_array_equal(res['grad'], res['want_grad'])
        total = sum(range(WORLD))
        np.testing.assert_array_equal(res['sums'][0], np.full(3, total))
        np.testing.assert_array_equal(res['sums'][1],
                                      np.full((2, 2), WORLD))
        assert res['sums'][2].dtype == np.float64
        assert float(res['sums'][2][0]) == total
        if rank == 1:
            np.testing.assert_array_equal(
                res['to_one'], np.repeat(np.arange(WORLD, dtype=np.float32),
                                         2).reshape(WORLD, 2))
        else:
            assert res['to_one'] is None
        for got, want in zip(res['tree'], first['tree']):
            np.testing.assert_array_equal(got, want)
        assert res['object'] == {'from': 0}
        assert res['objects'] == list(range(WORLD))
        counters = res['counters']
        # the gather's own rows, the float32 and float64 sums, and one
        # row to rank 1 (0 for rank 1's gather_rows send is counted too)
        assert counters['gather_ops'] == 2
        assert counters['gather_bytes'] == BATCH[:2].nbytes + 8
        assert counters['allreduce_ops'] == 2
        assert counters['allreduce_bytes'] == 7 * 4 + 8
        assert counters['broadcast_ops'] == 3
        assert res['allreduce'] == (counters['allreduce_bytes']
                                    + counters['gather_bytes'], 4)


def test_shard_batch_and_spatial_blocks(ranks):
    for rank in range(WORLD):
        res = _result(ranks, 'shards', rank)
        np.testing.assert_array_equal(res['rows'],
                                      BATCH[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(res['block'],
                                      HALO[:, :, 3 * rank:3 * rank + 3])
        assert 'not divisible' in res['message']


if __name__ == '__main__':
    run_rank_scenarios(SCENARIOS, *sys.argv[1:])
