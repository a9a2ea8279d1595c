"""The training loop: ``Sup3rGan.run_gradient_descent(lr, hr,
weight_gen_advers, train_gen=True, train_disc=True)`` on the next batch
of a running ``BatchHandler``, step after step, as ``_train_epoch``
runs it.

Set-up writes the seeded NetCDF3 high-res domain, builds the handler
over it and the model with both networks' weights made on the card from
the seed, and drives that model through its first steps
(``check_steps``) on the handler's first batches: those steps compile
and warm up, and are the ones the reference follows from the seeded
weights. The same model and handler then run the window. One step of
the window, the first to start once a share of the window drawn from
the seed has passed, is held: both networks' weights and Adam moments
before it, its batch, its losses, its gradient (from the first moment's
change) and its weights' change. Afterwards the program is freed and
the reference re-runs the first steps from the seeded weights, and the
held step from the program's state before it, on the windows of the
domain that the batches hold, which it finds itself in the data: each
step's losses, every leaf's gradient and every leaf's change are
compared by the gap between the two sides' norms.
"""

import gc
import math
import shutil
import sys
import time

import numpy as np

from portbench import harness
from portbench.reference.flops import gan_step_flops
from portbench.reference.gan import Adam, coarsen, gan_step
from portbench.reference.network import param_shapes

SMALL_KERNEL = 'small_reflect_conv_kernel'
#: Adam's b1, to read a step's gradient from the first moment
B1 = 0.9
#: the numbers a training run compares (``traffic['limits']``)
READINGS = ('loss_rel_err', 'grad_median_leaf_gap', 'grad_worst_leaf_gap',
            'change_norm_gap')


def shapes(cell):
    """(low-res, high-res) channels-last batch shapes."""
    config, traffic = cell['config'], cell['traffic']
    m = config['members'][0]
    s1, s2, t = traffic['sample_shape']
    n, nf = traffic['batch_size'], len(m['lr_features'])
    lr = (n, s1 // m['s_enhance'], s2 // m['s_enhance'],
          t // m['t_enhance'], nf)
    return lr, (n, s1, s2, t, len(m['hr_out_features']))


def make_domain(cell, seed, work):
    """The seeded high-res domain (s1, s2, t, f) and its NetCDF3 file."""
    config, traffic = cell['config'], cell['traffic']
    s1, s2, t = traffic['domain']
    features = config['members'][0]['lr_features']
    stats = config['data']
    rng = harness.seed_rng(seed, 1)
    data = {f: (rng.standard_normal((s1, s2, t)) * stats['stdevs'][f]
                + stats['means'][f]).astype(np.float32) for f in features}
    path = harness.write_nc(work / 'train.nc', data,
                            np.linspace(*traffic['lat'], s1),
                            np.linspace(*traffic['lon'], s2),
                            traffic['hours'])
    return str(path), np.stack([data[f] for f in features], axis=-1)


def weights(cell, seed, device):
    """The generator's and the discriminator's seeded weights."""
    config = cell['config']
    lr, hr = shapes(cell)
    gen = harness.make_weights(param_shapes(
        config['members'][0]['generator'], (1, *lr[1:])), seed, 10, device)
    disc = harness.make_weights(param_shapes(
        config['discriminator'], (1, *hr[1:])), seed, 20, device)
    return gen, disc


def build(cell, seed, path, device):
    """The program's handler and model, the model holding the seeded
    weights."""
    import torch

    from sup3r_tpu_torch.models import Sup3rGan
    from sup3r_tpu_torch.preprocessing import BatchHandler, DataHandler
    from sup3r_tpu_torch.utilities import RANDOM_GENERATOR

    config, traffic = cell['config'], cell['traffic']
    m = config['members'][0]
    RANDOM_GENERATOR.bit_generator.state = harness.seed_rng(
        seed, 4).bit_generator.state
    handler = BatchHandler(
        [DataHandler(path, features=m['lr_features'])],
        batch_size=traffic['batch_size'], n_batches=2 ** 31,
        s_enhance=m['s_enhance'], t_enhance=m['t_enhance'],
        sample_shape=tuple(traffic['sample_shape']),
        means=config['means'], stds=config['stdevs'],
        queue_cap=traffic['queue_cap'], device=device)
    model = Sup3rGan(m['generator'], config['discriminator'],
                     learning_rate=traffic['learning_rate'],
                     loss=traffic['loss'], means=config['means'],
                     stdevs=config['stdevs'], device=device)
    lr, hr = shapes(cell)
    model.init_weights((1, *lr[1:]), (1, *hr[1:]), seed=0)
    gen_w, disc_w = weights(cell, seed, device)
    for net, ws in ((model._gen, gen_w), (model._disc, disc_w)):
        params = list(net.parameters())
        if [tuple(p.shape) for p in params] != [tuple(w.shape) for w in ws]:
            raise RuntimeError('the program holds params '
                               f'{[tuple(p.shape) for p in params]}')
        with torch.no_grad():
            for p, w in zip(params, ws):
                p.copy_(w)
    return handler, model


def normalize(config, data):
    """The domain as the feed holds it: (x - mean) / stdev a feature, in
    float32."""
    features = config['members'][0]['lr_features']
    means = np.array([config['means'][f] for f in features], np.float32)
    stdevs = np.array([config['stdevs'][f] for f in features], np.float32)
    return ((data - means) / stdevs).astype(np.float32)


def locate(data, sample):
    """The window of ``data`` (s1, s2, t, f) equal to ``sample``, found by
    its first value; None if there is none."""
    shape = sample.shape[:3]
    for start in np.argwhere(data[..., 0] == sample[0, 0, 0, 0]):
        if any(s + w > n for s, w, n in zip(start, shape, data.shape)):
            continue
        window = data[start[0]:start[0] + shape[0],
                      start[1]:start[1] + shape[1],
                      start[2]:start[2] + shape[2]]
        if np.array_equal(window, sample):
            return window
    return None


def norms(tensors):
    return np.array([float(t.double().norm()) for t in tensors])


def leaf_gaps(prog, ref, keep=None):
    """Each kept leaf's gap between the two sides' norms, over the larger
    of the reference's norm of that leaf and of the median kept leaf."""
    keep = np.ones(len(ref), bool) if keep is None else keep
    median = float(np.median(ref[keep]))
    return np.abs(prog - ref)[keep] / np.maximum(ref[keep], median)


def gap(prog, ref, keep=None):
    """The largest of ``leaf_gaps`` (inf where no leaf is kept)."""
    gaps = leaf_gaps(prog, ref, keep)
    return float(gaps.max()) if gaps.size else math.inf


def reference(cell, seed, data, hr_batches, device, dtype=None):
    """The reference's losses, first gradients and changes over the
    steps, on the windows of ``data`` that the program's batches hold,
    and its state after them (``start``'s form, see ``reference_step``);
    None when a batch holds a sample that is no window of the data.
    ``dtype`` (float32 by default) is the precision it computes in."""
    import torch

    config, traffic = cell['config'], cell['traffic']
    m = config['members'][0]
    norm = normalize(config, data)
    gen_w, disc_w = weights(cell, seed, device)
    if dtype is not None:
        gen_w = [w.to(dtype) for w in gen_w]
        disc_w = [w.to(dtype) for w in disc_w]
    start = [w.clone() for w in gen_w + disc_w]
    gen = {'layers': m['generator'],
           'params': [w.requires_grad_(True) for w in gen_w]}
    disc = {'layers': config['discriminator'],
            'params': [w.requires_grad_(True) for w in disc_w]}
    lr_rate = traffic['learning_rate']
    gen['opt'] = Adam(gen['params'], lr_rate)
    disc['opt'] = Adam(disc['params'], lr_rate)
    losses, first = [], None
    for hr in hr_batches:
        found = [locate(norm, s) for s in hr]
        if any(f is None for f in found):
            return None
        hr_t = torch.as_tensor(np.stack(found), device=device,
                               dtype=start[0].dtype)
        lr_t = coarsen(hr_t, m['s_enhance'], m['t_enhance'])
        g_loss, d_loss, g_grads, d_grads = gan_step(
            gen, disc, lr_t, hr_t, traffic['weight_gen_advers'])
        losses.append((g_loss, d_loss))
        if first is None:
            first = (g_grads, d_grads)
    end = [p.detach() for p in gen['params'] + disc['params']]
    change = [e - s for e, s in zip(end, start)]
    state = {'params': [p.clone() for p in end],
             'mu': gen['opt'].mu + disc['opt'].mu,
             'nu': gen['opt'].nu + disc['opt'].nu,
             'count': gen['opt'].count, 'n_gen': len(gen_w)}
    return losses, first, change, state


def reference_step(cell, start, data, hr, device):
    """The reference's one step from ``start`` ({'params', 'mu', 'nu':
    flat generator-then-discriminator lists, 'count': the steps taken
    before, 'n_gen': the generator's leaves}) on the windows of ``data``
    that the batch ``hr`` holds, in ``start``'s precision: ([its
    losses], its gradients, its change), the form ``compare`` reads;
    None when a sample is no window of the data."""
    import torch

    config, traffic = cell['config'], cell['traffic']
    m = config['members'][0]
    norm = normalize(config, data)
    found = [locate(norm, s) for s in hr]
    if any(f is None for f in found):
        return None
    dtype = start['params'][0].dtype
    hr_t = torch.as_tensor(np.stack(found), device=device, dtype=dtype)
    lr_t = coarsen(hr_t, m['s_enhance'], m['t_enhance'])
    params = [p.detach().clone().requires_grad_(True)
              for p in start['params']]
    n_gen = start['n_gen']
    nets = []
    for layers, sl in ((m['generator'], slice(0, n_gen)),
                       (config['discriminator'], slice(n_gen, None))):
        opt = Adam(params[sl], traffic['learning_rate'])
        opt.mu = [t.clone() for t in start['mu'][sl]]
        opt.nu = [t.clone() for t in start['nu'][sl]]
        opt.count = start['count']
        nets.append({'layers': layers, 'params': params[sl], 'opt': opt})
    g_loss, d_loss, g_grads, d_grads = gan_step(
        *nets, lr_t, hr_t, traffic['weight_gen_advers'])
    change = [p.detach() - s for p, s in zip(params, start['params'])]
    return [(g_loss, d_loss)], (g_grads, d_grads), change


def scales(ref, n_gen):
    """What a step's numbers are measured against, from the reference's
    first step from the seeded weights: its two losses, and the norm of
    each network's median leaf of its gradient."""
    losses, first = ref[0], ref[1]
    return {'losses': losses[0],
            'medians': tuple(float(np.median(norms(g))) for g in first)}


def compare(prog, ref, n_gen, scale, label='steps'):
    """The numbers compared, on ``prog`` and ``ref`` ({'losses',
    'first', 'change'} and its tuple): the first step's losses, each
    relative to the larger of the reference's loss and a thousandth of
    ``scale``'s; the median leaf's and the worst leaf's gap between the
    two sides' norms of the first gradient (see ``leaf_gaps``), the
    worse of the two networks, over the leaves whose reference gradient
    is at least a thousandth of ``scale``'s median leaf (those under it
    are nought to rounding, as is a whole network whose loss has
    saturated); the worst leaf's gap of the change over the steps,
    leaving out leaves whose reference gradient is under a thousandth
    of this step's median leaf (they move by round-off alone). A
    reading that is not a number is infinite. Printed, not compared:
    the later steps' losses (Adam's first updates are sign(g), so a
    gradient element within rounding of zero moves a full step either
    way and the later losses carry that)."""
    if ref is None:
        return dict.fromkeys(READINGS, math.inf)
    losses, first, change = ref[:3]
    by_step = [max(abs(p - r) / max(abs(r), 1e-3 * abs(r1))
                   for p, r, r1 in zip(ps, rs, scale['losses']))
               for ps, rs in zip(prog['losses'], losses)]
    print(f'portbench: {label}: losses {prog["losses"][0]} against '
          f'{losses[0]}; relative loss gap by step: '
          + ', '.join(f'{e:.3g}' for e in by_step), file=sys.stderr)
    median_gap, worst_gap, change_gap = 0.0, 0.0, 0.0
    nets = ((slice(0, n_gen), first[0], prog['first'][0]),
            (slice(n_gen, None), first[1], prog['first'][1]))
    for net, (sl, ref_g, prog_g), floor in zip(('gen', 'disc'), nets,
                                                scale['medians']):
        r_g = norms(ref_g)
        moving = r_g >= 1e-3 * np.median(r_g)
        change_gap = worse(change_gap, gap(norms(prog['change'][sl]),
                                           norms(change[sl]), moving))
        keep = r_g >= 1e-3 * floor
        if not keep.any():
            print(f'portbench: {label}: {net} gradient (median leaf '
                  f'{np.median(r_g):.3g}) under a thousandth of the first '
                  f'step\'s ({floor:.3g}): not compared', file=sys.stderr)
            continue
        gaps = leaf_gaps(norms(prog_g), r_g, keep)
        worst = int(np.argmax(gaps))
        print(f'portbench: {label}: {net} gradient gaps: worst of '
              f'{len(gaps)} leaves ({len(r_g)}) {gaps[worst]:.3g}, median '
              f'leaf {np.median(gaps):.3g}', file=sys.stderr)
        median_gap = worse(median_gap, float(np.median(gaps)))
        worst_gap = worse(worst_gap, float(gaps.max()))
    readings = {'loss_rel_err': by_step[0], 'grad_median_leaf_gap': median_gap,
                'grad_worst_leaf_gap': worst_gap,
                'change_norm_gap': change_gap}
    return {k: v if math.isfinite(v) else math.inf
            for k, v in readings.items()}


def worse(a, b):
    """The larger reading; not a number counts as infinite."""
    return max(a if a == a else math.inf, b if b == b else math.inf)


def merge(*readings):
    """Each number's worst over the compared steps."""
    return {k: max(r[k] for r in readings) for k in READINGS}


def program_steps(model, batches, n, w_adv):
    """The program's first ``n`` steps on the next batches through the
    window's own call: ({'losses', 'first': each network's first
    gradient, read from Adam's first moment after one step, 'change'},
    the batches' high-res halves on the host)."""
    start = [p.detach().clone() for p in model.gen_params
             + model.disc_params]
    prog = {'losses': [], 'first': None}
    hr_batches = []
    for k in range(n):
        batch = next(batches)
        hr_batches.append(batch.high_res.cpu().numpy())
        out = model.run_gradient_descent(
            batch.low_res, batch.high_res, weight_gen_advers=w_adv,
            train_gen=True, train_disc=True)
        prog['losses'].append((out['loss_gen'], out['loss_disc']))
        if k == 0:
            prog['first'] = tuple(
                [m.detach() / (1 - B1) for m in state['mu']]
                for state in (model._gen_opt_state, model._disc_opt_state))
    prog['change'] = [p.detach() - s for p, s in zip(
        model.gen_params + model.disc_params, start)]
    return prog, hr_batches


def model_state(model):
    """Copies of the program's weights and Adam moments, generator then
    discriminator."""
    states = (model._gen_opt_state, model._disc_opt_state)
    return {'params': [p.detach().clone() for p in model.gen_params
                       + model.disc_params],
            'mu': [m.detach().clone() for s in states for m in s['mu']],
            'nu': [v.detach().clone() for s in states for v in s['nu']]}


class Held:
    """One step of the window held for the check: the first step to
    start once ``at`` seconds of the window have passed (the window's
    first step until then, should none start later)."""

    def __init__(self, at):
        self.at = at
        self.step = None

    def wants(self, index, since_open):
        return self.step is None or (self.step['index'] == 0 and index > 0
                                     and since_open >= self.at)

    def before(self, model, index, batch):
        self.step = {'index': index, 'start': model_state(model),
                     'hr': batch.high_res.detach().clone()}

    def after(self, model, out):
        held, now = self.step, model_state(model)
        held['losses'] = [(out['loss_gen'], out['loss_disc'])]
        n_gen = len(model.gen_params)
        grads = [(m1 - B1 * m0) / (1 - B1) for m1, m0 in zip(
            now['mu'], held['start']['mu'])]
        held['first'] = (grads[:n_gen], grads[n_gen:])
        held['change'] = [p1 - p0 for p1, p0 in zip(
            now['params'], held['start']['params'])]


def run(cell, seed, seconds, trace, t_start, device):
    """One run of a training cell; returns the record the metric readers
    and the result line read."""
    import torch

    config, traffic = cell['config'], cell['traffic']
    work = harness.work_dir(cell['name'], seed)
    handler = None
    phases = harness.Phases(t_start)
    phases('driver')
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        path, data = make_domain(cell, seed, work)
        phases('domain')
        handler, model = build(cell, seed, path, device)
        phases('model')
        batches = iter(handler)
        w_adv = traffic['weight_gen_advers']
        n_gen = len(model.gen_params)
        prog, hr_batches = program_steps(model, batches,
                                         traffic['check_steps'], w_adv)
        harness.sync(device)
        setup_s = time.perf_counter() - t_start
        phases('steps')
        phases.print()

        queue = handler._queue
        gets, starved = queue._gets, queue._starved_waits

        outside = [0]
        held = Held(float(harness.seed_rng(seed, 6).uniform(0.1, 0.5))
                    * seconds)
        index = [0]

        def step():
            outside[0] += not window.in_stretch
            with harness.span('next_batch'):
                batch = next(batches)
            hold = held.wants(index[0], window.since_open())
            if hold:
                held.before(model, index[0], batch)
            index[0] += 1
            with harness.span('step'):
                out = model.run_gradient_descent(
                    batch.low_res, batch.high_res, weight_gen_advers=w_adv,
                    train_gen=True, train_disc=True)
            if hold:
                held.after(model, out)

        window = harness.Window(seconds, device, profile=(
            range(1, 1 + traffic['profile_steps']) if trace else None))
        results = window.run(step)
        steps = sum(len(r) if isinstance(r, list) else 1 for r in results)
        gets, starved = queue._gets - gets, queue._starved_waits - starved
        memory_peak = (torch.cuda.max_memory_allocated()
                       if device != 'cpu' else 0)
        lr, hr = shapes(cell)
        step_flops = gan_step_flops(config['members'][0]['generator'],
                                    config['discriminator'], lr, hr)
        launch = harness.small_kernel_launch(
            config['members'][0]['generator'], lr)
        profile = (harness.profile_summary(window.prof, (SMALL_KERNEL,))
                   if window.prof is not None else None)
        handler.stop()
        handler = None
        del model, batches
        gc.collect()
        if device != 'cpu':
            torch.cuda.empty_cache()

        ref = reference(cell, seed, data, hr_batches, device)
        scale = scales(ref, n_gen) if ref is not None else None
        readings = [compare(prog, ref, n_gen, scale, 'set-up steps')]
        if held.step is not None and ref is not None:
            step_k = held.step
            start = {**step_k['start'], 'n_gen': n_gen,
                     'count': traffic['check_steps'] + step_k['index']}
            hr_k = step_k.pop('hr').cpu().numpy()
            readings.append(compare(
                step_k, reference_step(cell, start, data, hr_k, device),
                n_gen, scale, f'window step {step_k["index"]}'))
        else:
            readings.append(dict.fromkeys(READINGS, math.inf))
        held = None
        checks, ok = harness.judge(merge(*readings), traffic['limits'])
        return {
            'kind': 'train', 'setup_s': setup_s, 'window_s': window.elapsed,
            'steps': steps, 'flops': step_flops * outside[0],
            'flops_s': window.elapsed - window.stretch_s,
            'feed_gets': gets, 'feed_starved': starved,
            'device_name': (torch.cuda.get_device_name(0)
                            if device != 'cpu' else 'cpu'),
            'small_kernel': launch, 'profile': profile,
            'memory_peak_bytes': memory_peak,
            'attempted': steps + traffic['check_steps'], 'failed': 0,
            'correct': ok, 'checks': checks}
    finally:
        if handler is not None:
            handler.stop()
        shutil.rmtree(work, ignore_errors=True)
