"""Network: an ordered list of DSL layer modules, with the
introspection hooks the models rely on (enhancement factors, exo feature
order). The port of ``sup3r_tpu/models/network.py``.

The public arrays keep the JAX package's channels-last layout
``(n, s1, s2[, t], c)``: ``apply`` permutes once at entry and once at
exit, and the layers run channels-first in between.
"""

import json

import numpy as np
import torch
from torch import nn

from sup3r_tpu_torch.models.layers import (
    EXO_LAYERS,
    OBS_LAYERS,
    Dense,
    Flatten,
    FlexiblePadding,
    build_layers,
)


class Network(nn.Module):
    """A generator or discriminator: layer modules + init/apply."""

    def __init__(self, hidden_layers):
        """``hidden_layers``: a JSON list, a path to a JSON file with a
        ``hidden_layers`` key, or an already-built list of layer
        modules (a fused layer list shares the modules' parameters).
        """
        super().__init__()
        if isinstance(hidden_layers, str):
            with open(hidden_layers) as f:
                config = json.load(f)
            hidden_layers = config['hidden_layers']
        if hidden_layers and isinstance(hidden_layers[0], dict):
            self.config = list(hidden_layers)
            layers = build_layers(hidden_layers)
        else:
            self.config = None
            layers = list(hidden_layers)
        self.layers = nn.ModuleList(layers)

    # ------------------------------------------------------------------
    # introspection used by models
    @property
    def s_enhance(self):
        """Product of layer spatial multipliers."""
        return int(np.prod([lyr.spatial_mult for lyr in self.layers]))

    @property
    def t_enhance(self):
        """Product of layer temporal multipliers."""
        return int(np.prod([lyr.temporal_mult for lyr in self.layers]))

    @property
    def is_5d(self):
        """Whether the network consumes 5D (spatiotemporal) input."""
        return any(
            type(lyr).__name__ in ('Conv3D', 'Conv3DTranspose', 'Cropping3D')
            or getattr(lyr, 'n_spatial', 2) == 3
            for lyr in self.layers
        ) or any(len(getattr(lyr, 'paddings', [])) == 5
                 for lyr in self.layers)

    @property
    def input_dims(self):
        """4 for spatial-only nets, 5 for spatiotemporal."""
        return 5 if self.is_5d else 4

    @property
    def exo_features(self):
        """Names of mid-network exogenous features, in layer order."""
        return [lyr.name for lyr in self.layers
                if isinstance(lyr, EXO_LAYERS)]

    @property
    def obs_features(self):
        """Names of observation-fusion features, in layer order."""
        return [lyr.name for lyr in self.layers
                if isinstance(lyr, OBS_LAYERS)]

    @property
    def has_dropout(self):
        """Whether a layer is a ``Dropout`` (the train step then draws
        its masks)."""
        return any(type(lyr).__name__ == 'Dropout' for lyr in self.layers)

    @property
    def min_input_width(self):
        """Minimum spatial/temporal input width imposed by the first
        padding layer (reflect padding requires input > pad width).
        Returns per-dim minimums excluding batch/channel, or None (the
        forward-pass slicer's ``min_width``)."""
        for lyr in self.layers:
            if isinstance(lyr, FlexiblePadding):
                inner = lyr.paddings[1:-1]
                return tuple(max(a, b) + 1 for a, b in inner)
        return None

    # ------------------------------------------------------------------
    #: a CUDA event recorded after the last weight writes that
    #: ``mark_weights_written`` saw (None on the CPU and before any)
    weights_event = None

    def mark_weights_written(self):
        """Record a CUDA event on the current stream behind the weight
        writes queued there so far: a reader on another stream waits on
        ``weights_event`` before it reads the weights."""
        p = next(self.parameters(), None)
        if p is not None and p.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(p.device))
            self.weights_event = event

    def init(self, in_shape, generator):
        """Create every layer's parameters (on the CPU, from the seeded
        ``torch.Generator``) for a channels-last input shape; returns the
        output shape. Move the network with ``.to(device)`` after."""
        shape = tuple(in_shape)
        for lyr in self.layers:
            shape = lyr.init(shape, generator)
        return shape

    def forward(self, x, exo=None, train=False, dropout_generator=None,
                spatial=None, dropout_rows=None):
        """Run the layers on a channels-first tensor. ``exo`` maps
        feature name -> channels-last raster for the injection layers
        (exo and observations alike); ``train`` with a
        ``dropout_generator`` turns the ``Dropout`` layers on, and
        ``dropout_rows`` (this rank's index, the number of ranks) makes
        their masks the global batch's rows of a data-parallel step. With a
        ``spatial`` shard (``parallel.mesh.SpatialShard``) ``x`` is this
        rank's block of s1 rows, every rank's block of equal rows; a
        layer without a sharded form raises a ValueError that says why
        (``models/layers.py`` lists the sharded forms)."""
        ctx = {'exo': exo or {}, 'skips': {}, 'train': train,
               'dropout_generator': dropout_generator, 'spatial': spatial,
               'dropout_rows': dropout_rows}
        if spatial is not None:
            ctx['s1'] = x.shape[2] * spatial.size
            head = self.row_parallel_index()
            if head is not None and not (
                    head < len(self.layers)
                    and isinstance(self.layers[head], Dense)):
                raise ValueError(
                    'a Flatten on a spatial mesh must be followed by a '
                    'Dense: a flattened block of s1 rows feeds a '
                    'row-parallel Dense only')
        for lyr in self.layers:
            if ctx['spatial'] is not None and not lyr.sharded_form:
                raise ValueError(
                    f'{type(lyr).__name__} cannot run on a block of s1 rows '
                    f'of a spatial mesh: {lyr.unsharded_reason}')
            x = lyr(x, ctx)
        if ctx['skips']:
            raise ValueError(
                'Unclosed skip connections: '
                f'{sorted(ctx["skips"])} — each SkipConnection name must '
                'appear exactly twice')
        return x

    def row_parallel_index(self):
        """Where a run on blocks of s1 rows becomes whole on every rank
        of a ``space`` group: the index of the row-parallel ``Dense``
        that follows the first ``Flatten`` (the flattened block's
        features times its rows of the kernel, summed over the group), or
        None without a Flatten (the output is then the rank's block)."""
        for i, lyr in enumerate(self.layers):
            if isinstance(lyr, Flatten):
                return i + 1
        return None

    @property
    def whole_on_space(self):
        """Whether a run on blocks of s1 rows gives every rank of a
        ``space`` group the whole output (a Flatten -> Dense head), not
        its block."""
        return self.row_parallel_index() is not None

    def space_replicated_params(self):
        """The params computed whole on every rank of a ``space`` group
        when the network runs on blocks of s1 rows: the bias of the
        row-parallel ``Dense`` (``row_parallel_index``), and every param
        after it. Their gradients are the same on every rank of the
        group, so a step sums them over the ``data`` axis only; every
        other param's gradient is a rank's share, summed over all
        ranks."""
        head = self.row_parallel_index()
        if head is None or head >= len(self.layers):
            return []
        return [self.layers[head].bias] + [
            p for lyr in self.layers[head + 1:] for p in lyr.parameters()]

    def apply(self, x, exo=None, train=False, dropout_generator=None,
              spatial=None, dropout_rows=None):
        """Run the network on a channels-last tensor; returns the
        channels-last output (a view of the channels-first result).
        Shadows ``nn.Module.apply(fn)``, as the JAX package's
        ``Network.apply`` runs the network."""
        x = x.permute(0, x.ndim - 1, *range(1, x.ndim - 1)).contiguous()
        out = self(x, exo, train, dropout_generator, spatial, dropout_rows)
        return out.permute(0, *range(2, out.ndim), 1)

    def out_shape(self, in_shape):
        """Static output shape for a given input shape (no params)."""
        shape = tuple(in_shape)
        for lyr in self.layers:
            shape = lyr.out_shape(shape)
        return shape

    def __len__(self):
        return len(self.layers)
