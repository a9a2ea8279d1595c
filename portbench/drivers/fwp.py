"""The forward-pass loop: node jobs of ``ForwardPass.run``, one after
another, each ``ForwardPassStrategy(...)`` then ``ForwardPass.run(strategy,
0)`` until the outputs are on the host (``out_pattern=None``, nothing
written).

Set-up makes each member's weights on the card from the seed, saves the
model where the strategy loads it, writes the NetCDF3 inputs the passes
cycle through (and a topography source where the configuration takes
one), and runs one warm-up pass on each input. The window then runs
passes until it closes. Afterwards the program is freed and the plain
reference recomputes a sample of the window's chunk outputs, drawn from
the seed: every chunk of the first pass, and one chunk of a share of
the others.
"""

import gc
import math
import shutil
import sys
import time
import traceback

import numpy as np

from portbench import harness
from portbench.reference import fwp as ref_fwp
from portbench.reference.flops import forward_flops
from portbench.reference.network import apply, param_shapes
from portbench.reference.topo import block_mean

SMALL_KERNEL = 'small_reflect_conv_kernel'


def member_shapes(config, padded, batch):
    """[(channels-last input shape of each member for one padded
    chunk)]: a 4D member takes time as its batch."""
    s1, s2, t = padded
    shapes = []
    for m in config['members']:
        nf = len(m['lr_features'])
        if m['dims'] == 4:
            shapes.append((batch * t, s1, s2, nf))
        else:
            shapes.append((batch, s1, s2, t, nf))
        s1, s2, t = s1 * m['s_enhance'], s2 * m['s_enhance'], \
            t * m['t_enhance']
    return shapes


def make_inputs(cell, seed, work):
    """The NetCDF3 inputs (one per ``n_files``) and, for a configuration
    with topography, its source; returns (paths, low-res arrays (s1, s2,
    t, f), topography source values or None)."""
    config, traffic = cell['config'], cell['traffic']
    s1, s2, t = traffic['domain']
    lat = np.linspace(*traffic['lat'], s1)
    lon = np.linspace(*traffic['lon'], s2)
    features = config['members'][0]['lr_features']
    exo = config.get('exo', {})
    data_features = [f for f in features if f not in exo]
    stats = config['data']
    paths, arrays = [], []
    for i in range(traffic['n_files']):
        rng = harness.seed_rng(seed, 1, i)
        data = {f: (rng.standard_normal((s1, s2, t)) * stats['stdevs'][f]
                    + stats['means'][f]).astype(np.float32)
                for f in data_features}
        paths.append(str(harness.write_nc(
            work / f'input_{i}.nc', data, lat, lon, traffic['hours'])))
        arrays.append(np.stack([data[f] for f in data_features], axis=-1))
    topo = None
    if 'topography' in exo:
        src_lat, src_lon = source_grid(lat, lon, traffic['topo_sub'] *
                                       config['members'][0]['s_enhance'])
        rng = harness.seed_rng(seed, 2)
        topo = (rng.random((len(src_lat), len(src_lon)))
                * exo['topography']['source_max']).astype(np.float32)
        harness.write_static_nc(work / 'topography.nc', 'topography', topo,
                                src_lat, src_lon)
    return paths, arrays, topo


def build_models(cell, seed, work, device):
    """Each member as a ``Sup3rGan`` with the seeded weights, saved under
    ``work``; returns the model directories."""
    import torch

    from sup3r_tpu_torch.models import Sup3rGan

    config = cell['config']
    dirs = []
    for i, m in enumerate(config['members']):
        nf = len(m['lr_features'])
        lr_shape = (1, 4, 4, nf) if m['dims'] == 4 else (1, 4, 4, 2, nf)
        hr_shape = ((1, 4 * m['s_enhance'], 4 * m['s_enhance'],
                     len(m['hr_out_features'])) if m['dims'] == 4 else
                    (1, 4 * m['s_enhance'], 4 * m['s_enhance'],
                     2 * m['t_enhance'], len(m['hr_out_features'])))
        model = Sup3rGan(
            m['generator'], [{'class': 'Flatten'}, {'class': 'Dense',
                                                    'units': 1}],
            meta={'lr_features': m['lr_features'],
                  'hr_out_features': m['hr_out_features'],
                  's_enhance': m['s_enhance'], 't_enhance': m['t_enhance'],
                  'input_resolution': m['input_resolution']},
            means=config['means'], stdevs=config['stdevs'], device=device)
        model.init_weights(lr_shape, hr_shape, seed=0)
        weights = harness.make_weights(
            param_shapes(m['generator'], lr_shape), seed, 10 + i, device)
        params = list(model._gen.parameters())
        if [tuple(p.shape) for p in params] != [tuple(w.shape)
                                                 for w in weights]:
            raise RuntimeError(f'member {i}: the program holds params '
                               f'{[tuple(p.shape) for p in params]}')
        with torch.no_grad():
            for p, w in zip(params, weights):
                p.copy_(w)
        path = work / f'model_{i}'
        model.save(str(path))
        dirs.append(str(path))
        del model, params, weights
    return dirs


class Pass:
    """One node job through the program's entry points."""

    def __init__(self, cell, inputs, model_dirs, work, device):
        from sup3r_tpu_torch.pipeline import ForwardPass

        class Recorded(ForwardPass):
            """``ForwardPass`` that keeps its last instance, for its
            timer."""

            last = None

            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                type(self).last = self

        self.fwp_class = Recorded
        self.cell, self.inputs, self.device = cell, inputs, device
        config, traffic = cell['config'], cell['traffic']
        many = len(model_dirs) > 1
        self.kwargs = dict(
            model_class='MultiStepGan' if many else 'Sup3rGan',
            model_kwargs=({'model_dirs': model_dirs, 'device': device}
                          if many else {'model_dir': model_dirs[0],
                                        'device': device}),
            fwp_chunk_shape=tuple(traffic['fwp_chunk_shape']),
            spatial_pad=traffic['spatial_pad'],
            temporal_pad=traffic['temporal_pad'],
            device_batch_size=traffic['device_batch_size'],
            chunked_io=traffic['chunked_io'],
            inference_mode=config['inference_mode'], out_pattern=None)
        if 'topography' in config.get('exo', {}):
            self.kwargs['exo_handler_kwargs'] = {'topography': {
                'source_file': str(work / 'topography.nc'),
                'cache_dir': str(work / 'exo_cache')}}
        self.count = 0

    def __call__(self):
        from sup3r_tpu_torch.pipeline import ForwardPassStrategy

        i = self.count
        self.count += 1
        path = self.inputs[i % len(self.inputs)]
        t0 = time.perf_counter()
        with harness.span('plan'):
            strategy = ForwardPassStrategy(file_paths=path, **self.kwargs)
        t1 = time.perf_counter()
        with harness.span('run'):
            out = self.fwp_class.run(strategy, 0)
        wall = time.perf_counter() - t0
        log = self.fwp_class.last.timer.log
        return {'index': i, 'file': i % len(self.inputs), 'out': out,
                'wall_s': wall, 'plan_s': t1 - t0,
                'n_chunks': strategy.fwp_slicer.n_chunks,
                'prep_s': log.get('get_input_chunk')}


def reference_models(config, seed, device):
    """Each member for the reference: its layer list, the seeded weights
    made again, and its stats."""
    members = []
    for i, m in enumerate(config['members']):
        nf = len(m['lr_features'])
        lr_shape = (1, 4, 4, nf) if m['dims'] == 4 else (1, 4, 4, 2, nf)
        params = harness.make_weights(
            param_shapes(m['generator'], lr_shape), seed, 10 + i, device)
        means, stdevs = ref_fwp.stats(m['lr_features'], config['means'],
                                      config['stdevs'], device)
        out_m, out_s = ref_fwp.stats(m['hr_out_features'], config['means'],
                                     config['stdevs'], device)
        members.append({'layers': m['generator'], 'params': params,
                        'means': means, 'stdevs': stdevs, 'out_means': out_m,
                        'out_stdevs': out_s, 'dims': m['dims'],
                        'exo_features': m.get('hr_exo_features', []),
                        's_enhance': m['s_enhance'],
                        't_enhance': m['t_enhance']})
    return members


def reference_chunk(config, members, lr_window, exo_windows, device):
    """The plain chain on one padded chunk ``(s1, s2, t, f)`` (topography
    already appended where the first member takes it): each member
    normalises, runs and un-normalises; a 4D member takes time as its
    batch. ``exo_windows`` maps a layer's raster name to its static
    (s1, s2) window. Returns the channels-last high-res chunk (numpy)."""
    import torch

    x = torch.as_tensor(np.ascontiguousarray(lr_window), device=device)
    for m in members:
        x = (x - m['means']) / m['stdevs']
        exo = {}
        for name in m['exo_features']:
            raster = torch.as_tensor(exo_windows[name], device=device)
            raster = ((raster - config['means'][name])
                      / config['stdevs'][name])
            if m['dims'] != 4:
                raise ValueError('a static raster feeds 4D members only')
            exo[name] = raster[None, None].expand(x.shape[2], 1, -1, -1)
        if m['dims'] == 4:
            out = apply(m['layers'], m['params'], x.permute(2, 3, 0, 1), exo)
            out = out.permute(2, 3, 0, 1)
        else:
            out = apply(m['layers'], m['params'],
                        x.permute(3, 0, 1, 2)[None], exo)[0]
            out = out.permute(1, 2, 3, 0)
        x = out * m['out_stdevs'] + m['out_means']
    return x.cpu().numpy()


def reference_outputs(cell, seed, arrays, topo, chunks, device):
    """The plain reference's cropped output of each (file, chunk index)
    in ``chunks``, in order (numpy, channels-last)."""
    import torch

    config, traffic = cell['config'], cell['traffic']
    members = reference_models(config, seed, device)
    plan, pads = ref_fwp.chunk_plan(
        traffic['domain'], traffic['fwp_chunk_shape'],
        traffic['spatial_pad'], traffic['temporal_pad'])
    windows = dict(plan)
    s_total = math.prod(m['s_enhance'] for m in members)
    t_total = math.prod(m['t_enhance'] for m in members)
    if topo is not None:
        s0 = members[0]['s_enhance']
        sub = traffic['topo_sub']
        topo_in = block_mean(topo, sub * s0)
        topo_layer = block_mean(topo, sub)
    outs = []
    with torch.no_grad():
        for file_i, chunk_i in chunks:
            window = windows[chunk_i]
            lr = ref_fwp.padded_window(arrays[file_i], window, pads)
            exo = {}
            if topo is not None:
                t_in = ref_fwp.padded_window(topo_in, window[:2], pads[:2])
                lr = np.concatenate([lr, np.repeat(
                    t_in[:, :, None, None], lr.shape[2], axis=2)], axis=-1)
                exo['topography'] = ref_fwp.padded_window(
                    topo_layer, window[:2], pads[:2], (s0, s0))
            hr = reference_chunk(config, members, lr, exo, device)
            outs.append(ref_fwp.crop(hr, window, pads,
                                     (s_total, s_total, t_total)))
    return outs


def max_rel_err(got, want):
    """The largest error of the chunk outputs ``got`` against ``want``,
    each feature's error over that feature's largest magnitude in
    ``want`` (inf for a missing or misshapen output)."""
    worst = 0.0
    for g, w in zip(got, want):
        if g is None or g.shape != w.shape:
            return math.inf
        scale = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0)
        err = np.abs(g - w).reshape(-1, w.shape[-1]).max(axis=0)
        worst = max(worst, float((err / scale).max()))
    return worst


def sample_chunks(seed, n_passes, n_chunks, traffic):
    """The (pass, chunk) pairs a run keeps and checks, drawn from the
    seed: every chunk of the first pass, then one chunk of each pass
    with probability ``sample_share``, up to ``sample_max`` more."""
    rng = harness.seed_rng(seed, 3)
    picks = [(0, c) for c in range(n_chunks)]
    extra = 0
    for i in range(1, n_passes):
        pick = int(rng.integers(n_chunks))
        if rng.random() < traffic['sample_share'] and (
                extra < traffic['sample_max']):
            picks.append((i, pick))
            extra += 1
    return picks


def source_grid(lat, lon, factor):
    """1D axes of a topography source with ``factor`` points along each
    axis of every low-res cell, at the centres of equal sub-cells: each
    point lies well inside one cell of the grid ``factor / sub`` times
    finer, so each cell's mean is its block's mean."""
    def axis(v):
        frac = (np.arange(len(v) * factor) + 0.5) / factor - 0.5
        return v[0] + frac * (v[1] - v[0])
    return axis(np.asarray(lat, np.float64)), axis(np.asarray(lon,
                                                              np.float64))


def run(cell, seed, seconds, trace, t_start, device):
    """One run of a forward-pass cell; returns the record the metric
    readers and the result line read."""
    import torch

    config, traffic = cell['config'], cell['traffic']
    work = harness.work_dir(cell['name'], seed)
    phases = harness.Phases(t_start)
    phases('driver')
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        inputs, arrays, topo = make_inputs(cell, seed, work)
        phases('inputs')
        model_dirs = build_models(cell, seed, work, device)
        phases('models')
        run_pass = Pass(cell, inputs, model_dirs, work, device)
        for i in range(len(inputs)):
            run_pass()
            phases(f'pass {i}')
        harness.sync(device)
        setup_s = time.perf_counter() - t_start
        phases.print()

        kept, failed, walls, plans, preps = {}, 0, [], [], []
        stats = {'passes': 0, 'chunks': 0, 'hr_voxels': 0,
                 'chunks_outside_stretch': 0}
        n_chunks = len(ref_fwp.chunk_plan(
            traffic['domain'], traffic['fwp_chunk_shape'], 0, 0)[0])
        wanted = sample_chunks(seed, 10000, n_chunks, traffic)

        def step():
            nonlocal failed
            try:
                res = run_pass()
            except Exception:  # a failed pass counts, and is shown
                traceback.print_exc(file=sys.stderr)
                failed += 1
                return
            out = res['out']
            walls.append(res['wall_s'])
            plans.append(res['plan_s'])
            if res['prep_s'] is not None:
                preps.append(res['prep_s'] / res['n_chunks'])
            i = stats['passes']
            stats['passes'] += 1
            stats['chunks'] += len(out)
            if not window.in_stretch:
                stats['chunks_outside_stretch'] += len(out)
            stats['hr_voxels'] += sum(int(np.prod(o.shape[:-1]))
                                      for o in out.values())
            for p, c in wanted:
                if p == i:
                    o = out.get(c)
                    kept[(p, c)] = (res['file'],
                                    None if o is None else np.array(o))

        window = harness.Window(seconds, device, profile=(
            range(1, 1 + traffic['profile_passes']) if trace else None))
        window.run(step)
        memory_peak = (torch.cuda.max_memory_allocated()
                       if device != 'cpu' else 0)
        padded = [c + 2 * p for c, p in zip(
            traffic['fwp_chunk_shape'], (traffic['spatial_pad'],) * 2
            + (traffic['temporal_pad'],))]
        shapes = member_shapes(config, padded, 1)
        chunk_flops = sum(forward_flops(m['generator'], s)
                          for m, s in zip(config['members'], shapes))
        launch = next(filter(None, (
            harness.small_kernel_launch(m['generator'], s)
            for m, s in zip(config['members'], member_shapes(
                config, padded, traffic['device_batch_size'])))), None)
        profile = (harness.profile_summary(window.prof, (SMALL_KERNEL,))
                   if window.prof is not None else None)
        del run_pass
        free_program()

        due = [pc for pc in wanted if pc[0] < stats['passes']]
        got = [kept.get(pc, (None, None))[1] for pc in due]
        want = reference_outputs(
            cell, seed, arrays, topo,
            [(kept.get(pc, (pc[0] % traffic['n_files'],))[0], pc[1])
             for pc in due], device)
        readings = {'fwp_max_rel_err': max_rel_err(got, want),
                    'fwp_chunks_missing': float(sum(g is None for g in got))}
        checks, ok = harness.judge(readings, traffic['limits'])
        attempted = stats['passes'] + failed
        return {
            'kind': 'fwp', 'setup_s': setup_s, 'window_s': window.elapsed,
            'pass_walls_s': walls, 'plan_s': plans,
            'prep_s_per_chunk': preps, **stats,
            'flops': chunk_flops * stats['chunks_outside_stretch'],
            'flops_s': window.elapsed - window.stretch_s,
            'device_name': (torch.cuda.get_device_name(0)
                            if device != 'cpu' else 'cpu'),
            'small_kernel': launch, 'profile': profile,
            'memory_peak_bytes': memory_peak,
            'attempted': attempted, 'failed': failed,
            'correct': ok and failed == 0 and bool(due),
            'checks': checks}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def free_program():
    """Drop the program's cached models and the card's free blocks."""
    import torch

    from sup3r_tpu_torch.pipeline import strategy

    strategy._MODEL_CACHE.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
