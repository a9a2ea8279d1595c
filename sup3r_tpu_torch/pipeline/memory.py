"""Device-memory-aware planning for chunked inference: pick
``device_batch_size`` automatically from an activation-memory model of
the generator. The port of ``sup3r_tpu/pipeline/memory.py``, sized for
the card: the budget is the free memory ``torch.cuda.mem_get_info``
reports for the model's device, unless ``hbm_bytes`` is given (it must
be on the CPU). One padded chunk that alone exceeds the budget is
sharded over a mesh of ranks instead (``use_mesh='spatial'``), and
``estimate_halo_bytes`` gives the bytes its halo exchanges move.

The analytic model walks the network's layer shapes: peak residency
for a feed-forward conv stack is dominated by the largest adjacent
(input, output) activation pair plus temps; params and the I/O buffers
ride on top. A multi-step chain budgets for its hungriest member; the
solar composite counts all three of its groups, with the intermediates
that stay on the device while the later groups run.
"""

import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: fraction of device memory the planner allows the generator to use —
#: leaves headroom for temps, the runtime, and double-buffered transfers
SAFETY = 0.6


def _layer_shapes(layers, in_shape):
    """Activation shape after every layer (batch-1 basis)."""
    shapes = [tuple(in_shape)]
    shape = tuple(in_shape)
    for lyr in layers:
        try:
            shape = tuple(lyr.out_shape(shape))
        except NotImplementedError:
            # fused layers don't do shape inference; a k3/s1 reflect
            # conv preserves spatial dims and we cannot see c_out
            # here, so reuse the current shape (channel counts in the
            # flagship bodies are constant between fusable blocks).
            # Any OTHER exception is a genuine planner bug and must
            # surface here, not as a device OOM with a ~32x-undersized
            # estimate.
            shape = tuple(shape)
        shapes.append(shape)
    return shapes


def estimate_activation_bytes(model, lr_shape):
    """Peak activation bytes to run ONE batch element of shape
    ``lr_shape`` (no batch dim) through the model, float32.

    Multi-step chains (``model.models``) take the max over their
    members' estimates at each member's (enhanced) input shape: a
    dispatch runs every member, so the planner budgets for the hungriest
    step. Models without a generator (linear, physics) count their input
    and output."""
    groups = getattr(model, 'groups', None)
    if groups:
        return _solar_chain_bytes(groups, lr_shape)
    members = getattr(model, 'models', None)
    if members:
        shape = tuple(lr_shape)
        peak = 0
        for member in members:
            peak = max(peak, estimate_activation_bytes(member, shape))
            se = int(getattr(member, 's_enhance', 1) or 1)
            te = int(getattr(member, 't_enhance', 1) or 1)
            if len(shape) == 4:
                shape = (shape[0] * se, shape[1] * se, shape[2] * te,
                         shape[3])
            else:
                shape = (shape[0] * se, shape[1] * se, shape[2])
        return peak
    gen = getattr(model, 'generator', None)
    if gen is None:
        s = int(np.prod(lr_shape)) * 4
        se = int(getattr(model, 's_enhance', 1) or 1) ** 2
        te = int(getattr(model, 't_enhance', 1) or 1)
        return s * (1 + se * te)
    if getattr(model, 'is_4d', False) and len(lr_shape) == 4:
        # spatial models fold time into the batch at dispatch
        # (forward_pass._reshape_data_chunk): estimate one time slice
        # through the layers and scale by the folded batch factor
        t = int(lr_shape[2])
        shapes = _layer_shapes(gen.layers,
                               (1, lr_shape[0], lr_shape[1],
                                lr_shape[3]))
        shapes = [(s[0] * t, *s[1:]) for s in shapes]
    else:
        shapes = _layer_shapes(gen.layers, (1, *lr_shape))
    sizes = [int(np.prod(s)) * 4 for s in shapes]
    # peak = largest adjacent in+out pair (+50% fusion/temp headroom)
    peak_pair = max(a + b for a, b in zip(sizes[:-1], sizes[1:]))
    params = sum(int(p.numel()) * 4 for p in (model.gen_params or ()))
    return int(1.5 * peak_pair + params + sizes[0] + sizes[-1])


def _solar_chain_bytes(groups, lr_shape):
    """Peak bytes of a ``SolarMultiStepGan`` on one (s1, s2, t, f) chunk:
    the wind group, then the solar group beside the wind output, then the
    temporal group beside both outputs and their concat (all three stay
    on the device until the temporal group's output is fetched)."""
    solar, wind, temporal = groups
    s1, s2, t = (int(v) for v in lr_shape[:3])
    se = int(np.prod(wind.s_enhancements))
    hr_cells = s1 * se * s2 * se * t

    def in_shape(group):
        n = len([f for f in group.lr_features if f != 'topography'])
        return (s1, s2, t, n)

    wind_out = 4 * hr_cells * len(wind.hr_out_features)
    solar_out = 4 * hr_cells * len(solar.hr_out_features)
    t_feats = len(temporal.lr_features)
    return int(max(
        estimate_activation_bytes(wind, in_shape(wind)),
        wind_out + estimate_activation_bytes(solar, in_shape(solar)),
        wind_out + solar_out + 4 * hr_cells * t_feats
        + estimate_activation_bytes(
            temporal, (s1 * se, s2 * se, t, t_feats))))


def estimate_halo_bytes(model, lr_shape, n_devices):
    """Estimated bytes exchanged per generator application when ONE
    chunk's s1 dim is split over ``n_devices`` ranks (the
    use_mesh='spatial' path): every k3 conv needs a 1-cell boundary
    plane from each neighbour, both directions. Summed over the ranks
    (each rank's ``Mesh.counters['halo_bytes']`` counts what it sent)."""
    gen = getattr(model, 'generator', None)
    if gen is None or n_devices <= 1:
        return 0
    shapes = _layer_shapes(gen.layers, (1, *lr_shape))
    total = 0
    for lyr, shape in zip(gen.layers, shapes[:-1]):
        if 'Conv' in type(lyr).__name__:  # incl. FusedReflectConv
            # plane = everything but the sharded s1 dim
            plane = int(np.prod(shape[2:])) * 4
            total += 2 * (n_devices - 1) * plane
    return total


def resolve_device_batch_size(model, padded_lr_shape, n_features,
                              hbm_bytes=None, max_batch=64):
    """('auto' resolution) -> (batch_size, use_spatial: bool).

    batch_size >= 1 chunks fit per dispatch; use_spatial=True means
    one padded chunk alone exceeds the memory budget and the chunk
    should be sharded over a mesh instead. ``hbm_bytes`` defaults to
    the free memory of the model's CUDA device; on the CPU it must be
    given."""
    if hbm_bytes is None:
        device = getattr(model, 'device', torch.device('cpu'))
        if device.type != 'cuda':
            raise ValueError(
                'device_batch_size="auto" sizes batches from the free '
                f'memory of a CUDA device; the model is on {device}, so '
                'pass hbm_bytes')
        hbm_bytes = torch.cuda.mem_get_info(device)[0]
    budget = hbm_bytes * SAFETY
    lr_shape = (*padded_lr_shape, n_features)
    per_chunk = estimate_activation_bytes(model, lr_shape)
    if per_chunk > budget:
        logger.warning(
            'One padded chunk %s needs ~%.2f GB of ~%.2f GB usable '
            'device memory; it needs use_mesh="spatial" sharding',
            lr_shape, per_chunk / 1024 ** 3, budget / 1024 ** 3)
        return 1, True
    batch = int(max(1, min(max_batch, budget // per_chunk)))
    logger.info(
        'device_batch_size=auto -> %d (per-chunk ~%.3f GB, budget '
        '~%.2f GB)', batch, per_chunk / 1024 ** 3,
        budget / 1024 ** 3)
    return batch, False
