"""A copy of the benchmark with every cell cut to a size the CPU runs
in seconds: the published layer lists narrowed (filters, repeats) and
the domains, chunks and batches shrunk. Only the tests use it. The copy
also names the Sup3rCC wind chain's cell, whose files the benchmark
keeps for a later cell (see PERF.md), so that the forward-pass driver's
chain, topography and streaming paths stay tested."""

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
#: the chain's entries, added to the copy's ``BENCHMARK.json``
CHAIN_CONFIG = {
    'name': 'cc_wind_chain',
    'source': 'https://github.com/NREL/sup3r/tree/main/sup3r/configs/sup3rcc',
    'file': 'portbench/configs/cc_wind_chain.json', 'reduced': [],
    'why': 'the Sup3rCC wind chain'}
CHAIN_CELL = {'name': 'ccwind.fwp.stream', 'config': 'cc_wind_chain',
              'traffic': 'fwp.stream', 'chips': 1,
              'why': 'the chain through chunked_io with topography'}


def narrow(layers, filters, repeats):
    """The layer list with filter and unit counts mapped by ``filters``
    and every repeated group ``repeats`` long."""
    out = []
    for layer in layers:
        layer = copy.deepcopy(layer)
        if 'repeat' in layer:
            layer['n'] = repeats
            layer['repeat'] = narrow(layer['repeat'], filters, repeats)
        for key in ('filters', 'units'):
            if layer.get(key) in filters:
                layer[key] = filters[layer[key]]
        out.append(layer)
    return out


def edit(path, fn):
    with open(path) as f:
        data = json.load(f)
    fn(data)
    with open(path, 'w') as f:
        json.dump(data, f)


def make(root):
    """Write the tiny copy (``BENCHMARK.json`` and ``portbench/``) under
    ``root``; returns ``root``."""
    root = Path(root)
    shutil.copytree(REPO / 'portbench', root / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    shutil.copy(REPO / 'BENCHMARK.json', root / 'BENCHMARK.json')
    configs, traffic = root / 'portbench' / 'configs', root / 'portbench' / \
        'traffic'

    def flagship(c):
        gen = c['members'][0]
        gen['generator'] = narrow(gen['generator'], {64: 8}, 2)
        c['discriminator'] = narrow(
            c['discriminator'],
            {32: 4, 64: 4, 128: 8, 256: 8, 1024: 16}, 1)

    def chain(c):
        m0, m1 = c['members']
        m0['generator'] = narrow(m0['generator'], {64: 8, 1600: 200}, 1)
        m1['generator'] = narrow(m1['generator'], {64: 8, 768: 48}, 1)

    def with_chain(bench):
        if CHAIN_CELL['name'] not in {w['name'] for w in bench['workloads']}:
            bench['configs'].append(CHAIN_CONFIG)
            bench['workloads'].append(CHAIN_CELL)
            for metric in bench['end_to_end'] + bench['per_layer']:
                if 'st3x4x.fwp.node' in metric.get('workloads', ()):
                    metric['workloads'].append(CHAIN_CELL['name'])

    edit(root / 'BENCHMARK.json', with_chain)
    edit(configs / 'st_gan_3x4x_2f.json', flagship)
    edit(configs / 'cc_wind_chain.json', chain)
    edit(traffic / 'fwp.node.json', lambda t: t.update(
        domain=[8, 8, 8], fwp_chunk_shape=[4, 4, 8], spatial_pad=2,
        temporal_pad=2, device_batch_size=2, n_files=2))
    edit(traffic / 'fwp.stream.json', lambda t: t.update(
        domain=[6, 6, 4], fwp_chunk_shape=[3, 3, 2], spatial_pad=1,
        temporal_pad=1, n_files=2))
    edit(traffic / 'train.b16.json', lambda t: t.update(
        domain=[66, 66, 72], sample_shape=[63, 63, 64], batch_size=2))
    return root


def run_cell(root, cell, seed=12345678901, seconds=1.0, trace=False):
    """One run of a tiny cell on the CPU, past the harness's look for a
    card; returns (cell, record)."""
    import time

    from portbench import harness

    found = harness.find_cell(harness.load_json(root / 'BENCHMARK.json'),
                              cell, root=root / 'portbench')
    driver = harness.load_module(
        root / 'portbench' / 'drivers' / f'{found["traffic"]["kind"]}.py')
    record = driver.run(found, seed=seed, seconds=seconds, trace=trace,
                        t_start=time.perf_counter(), device='cpu')
    return found, record
