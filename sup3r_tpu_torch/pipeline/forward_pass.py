"""Chunk execution: pad -> generate -> crop -> write.

Reference parity: sup3r/pipeline/forward_pass.py:32-673 (pad_source_data
:122, run_generator :188, _reshape_data_chunk :280, _output_check :385,
run :428). The port's copy of ``sup3r_tpu/pipeline/forward_pass.py``
for the single-device path: ``generate(..., fetch=False)`` hands back the
generator's output as a tensor on the card, each chunk's halo is cropped
there, and the drain of one device batch (device-to-host copy, output
transform, file writes) runs on a drain thread, on its own CUDA stream,
while the next batch is prepared and dispatched. Exogenous rasters are
padded with their chunk and reach ``generate`` per model step; 4D models,
models without ``fetch=`` (``MultiStepGan``, ``LinearInterp``), mixed exo
structures and output-combine exo run chunk by chunk.

With ``use_mesh`` every rank of the process group runs ``run`` on the
same strategy (``sup3r_tpu_torch.parallel``: one process per device).
The ranks take the first rank's chunk list. With ``use_mesh=True`` rank
i of n takes every n-th chunk from its i-th, prep included, and runs
them as one process would, in device batches of ``device_batch_size /
n`` chunks (rounded up: the batch size counts the chunks of one
generator application over the mesh, as in the JAX package). With
``use_mesh='spatial'`` every rank runs its block of s1 rows of every
chunk (halo exchanges in each conv), and the output blocks of a batch's
j-th chunk gather to rank j mod n, which writes it; chunks that cannot
batch run whole on that rank. With ``out_pattern=None`` every rank
returns every chunk's output.
"""

import contextlib
import itertools
import logging
from concurrent.futures import ThreadPoolExecutor
from warnings import warn

import numpy as np
import torch
import torch.distributed as dist

from sup3r_tpu_torch._native import reflect_pad_4d
from sup3r_tpu_torch.models.abstract import supports_fetch
from sup3r_tpu_torch.ops.conv_ad import shard_aligned_worthwhile
from sup3r_tpu_torch.parallel.mesh import (
    all_gather_object,
    broadcast_object,
    gather_rows,
    get_mesh,
    shard_spatial,
)
from sup3r_tpu_torch.postprocessing.writers import (
    OutputHandlerH5,
    OutputHandlerNC,
)
from sup3r_tpu_torch.preprocessing.loaders import get_source_type
from sup3r_tpu_torch.utilities import Timer, trace

logger = logging.getLogger(__name__)


def _to_host(out):
    """A writable numpy copy of a generator output: the device-to-host
    copy for a tensor on the card; a copy too for a CPU tensor, whose
    memory the writers' in-place transforms must not touch (it is a
    view of the generate result)."""
    if not isinstance(out, torch.Tensor):
        return np.array(out)
    host = out.cpu().numpy()
    return host.copy() if out.device.type == 'cpu' else host


class ForwardPass:
    """Run a node's share of forward-pass chunks."""

    OUTPUT_HANDLER_CLASS = {
        'nc': OutputHandlerNC,
        'h5': OutputHandlerH5,
    }
    #: the number of the next pass of the process (a trace id)
    _passes = itertools.count()

    def __init__(self, strategy, node_index=0):
        self.strategy = strategy
        self.node_index = node_index
        self.model = strategy.get_model()
        self.timer = Timer('fwp')
        #: per-node accounting for the batched path: device->host MB
        #: actually fetched and how many chunks drained packed vs via
        #: the host float32 transform (benchmark attribution)
        self.stats = {'fetch_mb': 0.0, 'packed_chunks': 0,
                      'host_chunks': 0}
        out_type = (get_source_type(strategy.out_pattern)
                    if strategy.out_pattern else None)
        self.output_handler_class = (
            self.OUTPUT_HANDLER_CLASS[out_type] if out_type else None)
        # reference default: invert u/v to ws/wd for H5, keep raw u/v
        # for gridded NetCDF intermediates (strategy.py invert_uv)
        invert = getattr(strategy, 'invert_uv', None)
        self._invert_uv = (out_type == 'h5') if invert is None \
            else bool(invert)
        self._nn_fill = bool(getattr(strategy, 'nn_fill', False))
        device = self.model.device
        #: the drain's CUDA stream: its copies and crops wait for the
        #: dispatch they drain, not for the dispatch queued after it
        self._drain_stream = (torch.cuda.Stream(device)
                              if device.type == 'cuda' else None)
        #: the mesh of ranks that share the node's chunks (None without
        #: ``use_mesh``)
        self.mesh = None
        self._resolve_auto_batch()
        if strategy.use_mesh and self.mesh is None:
            self.mesh = get_mesh(devices=device)
        #: the chunks of one device batch, partial batches padded to it
        #: (``run_chunks_batched`` sets it)
        self.batch_size = getattr(strategy, 'device_batch_size', 1)

    def _resolve_auto_batch(self):
        """Resolve device_batch_size='auto' into an int from the memory
        estimate of one padded chunk (see pipeline/memory.py). When one
        padded chunk alone does not fit the card, switch on spatial
        sharding over the ranks of the process group, a world of one
        included, as the JAX package switches over its local devices,
        even one. In a group of ranks (a CLI
        node run as one, ``utilities.cli.run_node_group``) the ranks take
        the first rank's plan (ranks sharing a card see different free
        memory), and a plan that needs no sharding fans the chunks out
        over them (``use_mesh=True``, the one-process output) rather than
        running every chunk on every rank."""
        strategy = self.strategy
        if getattr(strategy, 'device_batch_size', 1) != 'auto':
            return
        from sup3r_tpu_torch.pipeline.memory import (
            estimate_halo_bytes,
            resolve_device_batch_size,
        )

        slicer = strategy.fwp_slicer
        pads = (2 * strategy.spatial_pad, 2 * strategy.spatial_pad,
                2 * strategy.temporal_pad)
        padded = tuple(int(c) + p
                       for c, p in zip(slicer.chunk_shape, pads))
        n_feats = len(self.model.lr_features)
        batch, use_spatial = resolve_device_batch_size(
            self.model, padded, n_feats)
        group = dist.is_initialized() and dist.get_world_size() > 1
        if group:
            self.mesh = get_mesh(devices=self.model.device)
            batch, use_spatial = broadcast_object(self.mesh,
                                                  (batch, use_spatial))
        strategy.device_batch_size = batch
        if use_spatial and not strategy.use_mesh:
            self.mesh = self.mesh or get_mesh(devices=self.model.device)
            n_dev = self.mesh.size
            strategy.use_mesh = 'spatial'
            halo = estimate_halo_bytes(self.model, (*padded, n_feats), n_dev)
            logger.info(
                'auto batching -> use_mesh="spatial" over %d rank(s); '
                'estimated halo exchange ~%.2f MB per generator '
                'application', n_dev, halo / 1024 ** 2)
        elif group and not strategy.use_mesh:
            strategy.use_mesh = True
            logger.info('auto batching in a group of %d ranks -> '
                        'use_mesh=True (chunk fan-out)', self.mesh.size)

    @property
    def meta(self):
        """Run metadata to write with output files."""
        return {
            'node_index': self.node_index,
            'model_meta': self.model.meta,
            'strategy_meta': self.strategy.meta,
        }

    # ------------------------------------------------------------------
    def get_input_chunk(self, chunk_index=0, mode='reflect'):
        """Strategy chunk + boundary padding (of its exo rasters too)."""
        chunk = self.strategy.init_chunk(chunk_index)
        chunk.input_data, chunk.exo_data = self.pad_source_data(
            chunk.input_data, chunk.pad_width, chunk.exo_data, mode=mode)
        return chunk

    def _get_step_enhance(self, step):
        """Cumulative enhancement of an exo step (reference:
        forward_pass.py:89): up to its model for input steps, through it
        for layer and output steps."""
        combine_type = step['combine_type']
        model_step = step['model']
        assert combine_type in ('input', 'output', 'layer'), (
            f'Bad combine_type in step {step}')
        stop = model_step if combine_type == 'input' else model_step + 1
        return (int(np.prod(self.model.s_enhancements[:stop])),
                int(np.prod(self.model.t_enhancements[:stop])))

    def pad_source_data(self, input_data, pad_width, exo_data,
                        mode='reflect'):
        """Reflect-pad the (s1, s2, t, f) input (``_native.reflect_pad_4d``,
        multithreaded C++, as float32; ``np.pad`` for another mode or
        rank, as in the JAX package) and each exo raster by the pads
        scaled with its step's enhancement. A time-invariant (s1, s2, 1)
        raster is first repeated over t_enhance x the unpadded time
        length."""
        if mode == 'reflect' and np.ndim(input_data) == 4:
            out = reflect_pad_4d(input_data, pad_width)
        else:
            out = np.pad(input_data, (*pad_width, (0, 0)), mode=mode)
        for entry in (exo_data or {}).values():
            for step in entry['steps']:
                s_en, t_en = self._get_step_enhance(step)
                exo_pad = (*((en * pw[0], en * pw[1]) for en, pw in zip(
                    (s_en, s_en, t_en), pad_width)), (0, 0))
                arr = step['data']
                if arr.ndim == 3:
                    arr = np.repeat(arr[:, :, None],
                                    step['t_enhance'] * input_data.shape[2],
                                    axis=2)
                step['data'] = np.pad(arr, exo_pad, mode=mode)
        return out, exo_data

    # ------------------------------------------------------------------
    @classmethod
    def run_generator(cls, data_chunk, hr_crop_slices, model,
                      s_enhance=None, t_enhance=None, exo_data=None):
        """Reshape -> model.generate -> crop overlap.

        A model whose ``generate`` takes ``fetch=`` hands back the output
        tensor on its device, so the halo CROP happens there and the
        device->host copy moves only the kept voxels; the others
        (``MultiStepGan``, ``LinearInterp``) return numpy and are cropped
        on the host. Returns the cropped tensor or array (a view of the
        generate result: callers must not modify it in place)."""
        data_chunk, exo_data, i_lr_t, i_lr_s = cls._reshape_data_chunk(
            model, data_chunk, exo_data)
        kwargs = {'fetch': False} if supports_fetch(type(model)) else {}
        hi_res = model.generate(data_chunk, exogenous_data=exo_data,
                                **kwargs)
        if hi_res.ndim == 4:
            hi_res = (hi_res.permute(1, 2, 0, 3)
                      if isinstance(hi_res, torch.Tensor)
                      else hi_res.transpose(1, 2, 0, 3))[None]
        if s_enhance is not None and (
                hi_res.shape[1] != s_enhance * data_chunk.shape[i_lr_s]):
            raise RuntimeError(
                f'Spatial enhancement {s_enhance}x does not match '
                f'{data_chunk.shape} -> {tuple(hi_res.shape)}')
        if t_enhance is not None and (
                hi_res.shape[3] != t_enhance * data_chunk.shape[i_lr_t]):
            raise RuntimeError(
                f'Temporal enhancement {t_enhance}x does not match '
                f'{data_chunk.shape} -> {tuple(hi_res.shape)}')
        return hi_res[0][hr_crop_slices]

    @staticmethod
    def _reshape_data_chunk(model, data_chunk, exo_data):
        """4D models consume (t, s1, s2, f); 5D models consume
        (1, s1, s2, t, f). Each exo raster takes the layout of the model
        step it feeds."""
        members = getattr(model, 'models', [model])
        for entry in (exo_data or {}).values():
            for step in entry['steps']:
                assert step['model'] < len(members), (
                    f'exo step model index {step["model"]} out of range')
                arr = step['data']
                step['data'] = (np.transpose(arr, (2, 0, 1, 3))
                                if members[step['model']].is_4d
                                else arr[None])
        if model.is_4d:
            return np.transpose(data_chunk, (2, 0, 1, 3)), exo_data, 0, 1
        return np.asarray(data_chunk)[None], exo_data, 3, 1

    # ------------------------------------------------------------------
    @classmethod
    def _output_check(cls, out_data, allowed_const=False):
        """Guard against NaN or suspicious constant output (reference:
        forward_pass.py:385, the semantic sanitizer for the TF
        reflect-pad >2GB bug class)."""
        if np.isnan(out_data).any():
            raise MemoryError(
                'Forward pass output contains NaN values!')
        if allowed_const is True:
            return
        allowed = allowed_const if isinstance(allowed_const,
                                              (list, tuple)) else []
        for i in range(out_data.shape[-1]):
            chan = out_data[..., i]
            if chan.std() == 0 and chan.flat[0] not in allowed:
                raise MemoryError(
                    f'Forward pass output channel {i} is constant '
                    f'({chan.flat[0]})! If this is intended pass '
                    'allowed_const including this value.')

    def _write(self, chunk, data, nn_fill=None):
        """Host transform + write of one chunk's float32 output."""
        self.output_handler_class._write_output(
            data=data, features=list(self.model.hr_out_features),
            lat_lon=chunk.hr_lat_lon, times=chunk.hr_times,
            out_file=chunk.out_file, meta_data=self.meta,
            gids=chunk.gids, invert_uv=self._invert_uv,
            nn_fill=self._nn_fill if nn_fill is None else nn_fill)

    def run_chunk(self, chunk, allowed_const=False):
        """Generate + check + write one chunk. Returns (failed,
        output_or_none).

        Unlike the reference's classmethod (which rebuilds the model
        from model_kwargs per call, forward_pass.py:440), this is an
        instance method — the model and output handler live on the
        ForwardPass, so no per-chunk construction arguments exist."""
        logger.info('Running forward pass for chunk_index=%s.',
                    chunk.index)
        if np.isnan(chunk.input_data).any():
            raise RuntimeError(
                f'Chunk {chunk.index} input data contains NaNs')
        cropped = self.run_generator(
            chunk.input_data, chunk.hr_crop_slice, self.model,
            s_enhance=self.strategy.s_enhance,
            t_enhance=self.strategy.t_enhance, exo_data=chunk.exo_data)
        # a model that had to fetch (output-combine exo) finishes
        # through the host transform: the generator never runs twice
        if (self._pack_single_gate(chunk)
                and isinstance(cropped, torch.Tensor)):
            self._pack_write([(chunk, cropped)],
                             allowed_const=allowed_const)
            return False, None
        out_data = _to_host(cropped)
        try:
            self._output_check(out_data, allowed_const=allowed_const)
        except MemoryError as e:
            logger.error('Chunk %s failed output check: %s', chunk.index,
                         e)
            raise
        if chunk.out_file is not None:
            self._write(chunk, out_data)
        return False, out_data if chunk.out_file is None else None

    def _pack_single_gate(self, chunk):
        """Whether this chunk's per-chunk run uses the device-packed
        output path (crop + transform + storage quantization on the
        device — see ``_pack_write``): H5 file output and a model whose
        ``generate`` takes ``fetch=`` (``MultiStepGan`` and
        ``LinearInterp`` keep the host path).
        ``pack_output_on_device=True`` errors if this chunk cannot pack
        — same contract as the batched ``_pack_gate``."""
        flag = getattr(self.strategy, 'pack_output_on_device', None)
        if flag is False:
            return False
        ok = (self.output_handler_class is OutputHandlerH5
              and chunk.out_file is not None
              and supports_fetch(type(self.model)))
        if flag is True and not ok:
            raise RuntimeError(
                'pack_output_on_device=True but this chunk cannot '
                'pack on device (needs H5 output, out_pattern set, and a '
                'model whose generate supports fetch=)')
        return ok

    def run_chunks_batched(self, chunk_ids, batch_size):
        """Device-batched execution: group same-shaped padded chunks,
        stack them, run ONE generate per group, crop + drain + write.

        The replacement for the reference's process-pool-per-chunk
        (reference: forward_pass.py:503): a batch of chunks fills the
        card and amortizes per-dispatch host work, while chunk prep (IO
        + padding) runs on host threads and each batch drains on a
        drain thread while the next one is dispatched."""
        from collections import deque

        self.batch_size = batch_size
        outputs = {}

        def run_batch(batch, drain_pool, drain_futs):
            dispatched = self.timer(self._dispatch_chunk_batch,
                                    span='dispatch')(batch)
            if dispatched is None:  # per-chunk path, this rank's chunks
                outputs.update({
                    c.index: self.run_chunk(
                        c,
                        allowed_const=self.strategy.allowed_const)[1]
                    for c in self._writes(batch)})
                return
            drain_futs.append(drain_pool.submit(
                self.timer(self._drain_chunk_batch, span='drain'),
                dispatched))

        # STREAMING grouping: chunks are prepared with a bounded
        # number in flight and dispatched as soon as a same-shape
        # batch fills — materializing the node's whole chunk list
        # first would hold O(n_chunks) padded inputs in host RAM.
        # Peak memory here is O(in-flight + one partial batch per
        # distinct shape); distinct padded shapes number at most a
        # handful (interior + edge variants).
        drain_futs = []
        buffers = {}
        it = iter(chunk_ids)
        inflight = deque()
        with ThreadPoolExecutor(
                max(self.strategy.pass_workers, 2)) as pool, \
                ThreadPoolExecutor(max_workers=1) as drain_pool:

            def submit_next():
                i = next(it, None)
                if i is None:
                    return False
                inflight.append(pool.submit(
                    self.timer(self.get_input_chunk, span='prep'), i))
                return True

            for _ in range(max(2 * batch_size, 4)):
                if not submit_next():
                    break
            while inflight:
                with trace.span('fwp.prep_wait'):
                    chunk = inflight.popleft().result()
                submit_next()
                key = (chunk.input_data.shape,
                       chunk.exo_data is not None)
                buffers.setdefault(key, []).append(chunk)
                if len(buffers[key]) == batch_size:
                    run_batch(buffers.pop(key), drain_pool,
                              drain_futs)
            for batch in buffers.values():  # partial-batch leftovers
                run_batch(batch, drain_pool, drain_futs)
            with trace.span('fwp.drain_wait'):
                for fut in drain_futs:
                    outputs.update(fut.result())
        return outputs

    def _writes(self, batch):
        """The chunks of ``batch`` this rank writes: all of them, or
        under ``use_mesh='spatial'`` every n-th from the rank's index i
        (of n)."""
        if self.strategy.use_mesh != 'spatial':
            return list(batch)
        mesh = self.mesh
        return list(batch[mesh.axis_index(mesh.axis_names[0])::mesh.size])

    def _dispatch_chunk_batch(self, batch):
        """Stack same-shaped chunks and launch the device batch (this
        rank's s1 blocks of it under ``use_mesh='spatial'``: see the
        module docstring). Returns ``(output tensor, chunks, ready
        event)`` without waiting for the device, ``chunks`` being those
        whose outputs are the tensor's first rows (the rest are padding;
        under ``'spatial'``, the chunks this rank writes), or None when the
        chunks must run one by one: 4D models (they already batch over
        time), models without ``norm_input`` / ``fetch=`` (every chain),
        chunks whose exo structures differ, and output-combine exo (a
        host concat)."""
        if self.model.is_4d:
            return None
        if not (hasattr(self.model, 'norm_input')
                and supports_fetch(type(self.model))):
            if not getattr(self, '_batch_gate_logged', False):
                self._batch_gate_logged = True
                logger.info('%s does not support device batching; running '
                            'chunks individually',
                            type(self.model).__name__)
            return None
        with trace.span('fwp.stack'):
            exo_batched = None
            if any(c.exo_data for c in batch):
                exo_batched = self._stack_exo(batch)
                if exo_batched is None or self.model._has_output_exo(
                        exo_batched):
                    return None
            stacked = np.stack([c.input_data for c in batch], axis=0)
            n_real = len(batch)
            # pad partial batches up to the device batch size by
            # repeating the last chunk: one batch shape per chunk shape
            full = self.batch_size

            def pad_full(arr):
                if n_real < full:
                    return np.concatenate(
                        [arr, np.repeat(arr[-1:], full - n_real, axis=0)],
                        axis=0)
                return arr

            stacked = pad_full(stacked)
            layer_exo = None
            if exo_batched is not None:
                for entry in exo_batched.values():
                    for step in entry['steps']:
                        step['data'] = pad_full(step['data'])
                stacked = self.model._combine_fwp_input(
                    np.asarray(stacked, dtype=np.float32), exo_batched)
                # mid-network rasters, normalized with their own feature
                # stats (generate skips exo norm when norm_in=False)
                layer_exo = self.model._norm_layer_exo({
                    feature: step['data']
                    for feature, entry in exo_batched.items()
                    for step in entry['steps']
                    if step.get('combine_type') == 'layer'})
        with trace.span('fwp.h2d'):
            lr = self.model.norm_input(stacked)
            if self.strategy.use_mesh != 'spatial':
                # the copy generate would make first (a spatial pass
                # copies each rank's block in shard_spatial)
                lr = torch.as_tensor(lr, dtype=torch.float32,
                                     device=self.model.device)
                trace.count('fwp.h2d_bytes', lr.nbytes)
        trace.count('fwp.dispatches')
        chunks = list(batch)
        if self.strategy.use_mesh == 'spatial':
            out, chunks = self._generate_spatial(lr, layer_exo, batch)
        else:
            out = self.model.generate(lr, norm_in=False, un_norm_out=True,
                                      exogenous_data=layer_exo or None,
                                      fetch=False)
        ready = None
        if self._drain_stream is not None:
            ready = torch.cuda.Event()
            ready.record()
        return out, chunks, ready

    def _generate_spatial(self, lr, layer_exo, batch):
        """``use_mesh='spatial'``: run this rank's block of s1 rows of
        every chunk of the stacked ``lr`` (the ranks together), then
        gather each real chunk's output blocks to the rank that writes it,
        j mod n for the j-th (one gather a chunk, in this thread: every
        rank must issue the collectives in one order). Returns (this
        rank's chunks' outputs stacked, those chunks). On a mesh 4 or
        more wide the model takes the shard-aligned route
        (``inference_shard_aligned``, the JAX package's gate); below it
        the small kernel's blocks gather their input over the ranks, in
        ``generate`` (this thread, like every collective of the pass)."""
        mesh = self.mesh
        if (shard_aligned_worthwhile(mesh.size)
                and hasattr(type(self.model), 'inference_shard_aligned')):
            self.model.inference_shard_aligned = True
        if not getattr(self, '_sp_halo_logged', False):
            from sup3r_tpu_torch.pipeline.memory import estimate_halo_bytes

            self._sp_halo_logged = True
            halo = lr.shape[0] * estimate_halo_bytes(
                self.model, lr.shape[1:], mesh.size)
            logger.info(
                'use_mesh=spatial: s1=%d split over %d rank(s); estimated '
                'conv halo exchange ~%.2f MB per batched generator '
                'application', lr.shape[1], mesh.size, halo / 1024 ** 2)
        block = self.model.generate(
            shard_spatial(mesh, lr, dim=1), norm_in=False, un_norm_out=True,
            exogenous_data=layer_exo or None, fetch=False, mesh=mesh)
        mine, outs = [], []
        with torch.inference_mode():
            for j, chunk in enumerate(batch):
                full = gather_rows(mesh, block[j], j % mesh.size, dim=0)
                if full is not None:
                    mine.append(chunk)
                    outs.append(full)
            out = torch.stack(outs) if outs else block[:0]
        return out, mine

    @staticmethod
    def _stack_exo(batch):
        """Stack the chunks' exo rasters into one batched ``ExoData``, or
        None if their structures differ."""
        from sup3r_tpu_torch.preprocessing.exo import ExoData

        first = batch[0].exo_data
        if not all(c.exo_data is not None
                   and sorted(c.exo_data) == sorted(first) for c in batch):
            return None
        out = {}
        for feat, entry in first.items():
            steps = []
            for i, step in enumerate(entry['steps']):
                datas = []
                for c in batch:
                    csteps = c.exo_data[feat]['steps']
                    if (len(csteps) != len(entry['steps'])
                            or csteps[i]['combine_type']
                            != step['combine_type']
                            or np.shape(csteps[i]['data'])
                            != np.shape(step['data'])):
                        return None
                    datas.append(np.asarray(csteps[i]['data'],
                                            dtype=np.float32))
                steps.append({**{k: v for k, v in step.items()
                                 if k != 'data'},
                              'data': np.stack(datas, axis=0)})
            out[feat] = {'steps': steps}
        return ExoData(out)

    def _drain_context(self, out, ready):
        """Inference mode, on the drain stream after ``ready`` when the
        output is on the card."""
        ctx = contextlib.ExitStack()
        ctx.enter_context(torch.inference_mode())
        if self._drain_stream is not None:
            self._drain_stream.wait_event(ready)
            # the caching allocator must not hand this block to the
            # default stream while drain-stream work reads it
            out.record_stream(self._drain_stream)
            ctx.enter_context(torch.cuda.stream(self._drain_stream))
        return ctx

    def _pack_gate(self, batch):
        """Whether this dispatched batch drains through the
        device-packed path (ops/output_pack.py): crop + u/v inversion
        + limits + storage quantization on device, fetching cropped
        integer bytes. Auto unless ``strategy.pack_output_on_device``
        forces it; requires the H5 writer and chunks that write files
        (callers wanting arrays back get the untransformed float32
        block). ``nn_fill`` is honored: chunks whose device-computed
        min/max show out-of-range values fall back to the host NaN-fill
        transform per chunk (in range — the normal case — nn_fill is a
        no-op and the packed bytes are identical)."""
        flag = getattr(self.strategy, 'pack_output_on_device', None)
        if flag is False:
            return False
        ok = (self.output_handler_class is OutputHandlerH5
              and all(c.out_file is not None for c in batch))
        if flag is True and not ok:
            raise RuntimeError(
                'pack_output_on_device=True but this run cannot pack '
                'on device (needs H5 output and out_pattern set)')
        return ok

    def _pack_write(self, items_all, allowed_const=None):
        """Pack cropped device outputs and write their H5 files: run
        the pack (inversion + limits + quantization into writer layout)
        on the device, fetch the small check stats in one copy, then
        the packed integer arrays. Chunks are grouped by (crop shape,
        lat orientation) so each group is one pack and one fetch per
        feature."""
        from sup3r_tpu_torch.ops.output_pack import (
            fetch_stats,
            pack_chunks,
            pack_plan,
            theta_for,
        )

        names, pairs, quant = pack_plan(
            self.model.hr_out_features, self._invert_uv)
        groups = {}
        for chunk, cropped in items_all:
            invert_lat = bool(
                chunk.hr_lat_lon[-1, 0, 0] > chunk.hr_lat_lon[0, 0, 0])
            groups.setdefault(
                (tuple(cropped.shape), invert_lat), []).append(
                    (chunk, cropped))
        outputs = {}
        allowed = (self.strategy.allowed_const
                   if allowed_const is None else allowed_const)
        for (_, invert_lat), items in groups.items():
            stacked = torch.stack([c for _, c in items])
            thetas = torch.as_tensor(np.stack(
                [theta_for(ch.hr_lat_lon, invert_lat)
                 for ch, _ in items]), device=stacked.device)
            packed, stats = pack_chunks(stacked, thetas, pairs, quant,
                                        invert_lat)
            stats = fetch_stats(stats)
            for j in range(len(items)):
                self._check_packed_stats(stats, j, allowed)
            # limits: per chunk, out-of-range under nn_fill means the
            # host transform's NaN-fill semantics apply — fall back
            # for THOSE chunks only. In clip mode warn and keep the
            # device clip (bit-identical to the host clip).
            oob = np.zeros(len(items), dtype=bool)
            for k, (name, (_, _, lo, hi)) in enumerate(
                    zip(names, quant)):
                bad = ((stats['ch_max'][:, k] > hi)
                       | (stats['ch_min'][:, k] < lo))
                if bad.any():
                    if self._nn_fill:
                        oob |= bad
                    else:
                        warn(f'"{name}" outside physical range '
                             f'({lo}, {hi}); clipping.')
            host = None
            for j, (chunk, cropped) in enumerate(items):
                if oob[j]:
                    cropped_host = _to_host(cropped)
                    self.stats['fetch_mb'] += (cropped_host.nbytes
                                               / 2 ** 20)
                    trace.count('fwp.d2h_bytes', cropped_host.nbytes)
                    self.stats['host_chunks'] += 1
                    self._write(chunk, cropped_host, nn_fill=True)
                else:
                    if host is None:
                        host = [p.cpu().numpy() for p in packed]
                        self.stats['fetch_mb'] += sum(
                            h.nbytes for h in host) / 2 ** 20
                        trace.count('fwp.d2h_bytes',
                                    sum(h.nbytes for h in host))
                    self.stats['packed_chunks'] += 1
                    self.output_handler_class._write_packed(
                        [h[j] for h in host], list(names),
                        lat_lon=chunk.hr_lat_lon,
                        times=chunk.hr_times,
                        out_file=chunk.out_file, meta_data=self.meta,
                        gids=chunk.gids)
                outputs[chunk.index] = None
        return outputs

    @staticmethod
    def _check_packed_stats(stats, j, allowed_const):
        """Mirror ``_output_check`` from device-computed statistics
        (NaN anywhere; exactly-constant channels outside the allowed
        list)."""
        if stats['nan_any'][j]:
            raise MemoryError(
                'Forward pass output contains NaN values!')
        if allowed_const is True:
            return
        allowed = allowed_const if isinstance(allowed_const,
                                              (list, tuple)) else []
        for i, const in enumerate(stats['ch_const'][j]):
            first = stats['ch_first'][j, i]
            if const and first not in allowed:
                raise MemoryError(
                    f'Forward pass output channel {i} is constant '
                    f'({first})! If this is intended pass '
                    'allowed_const including this value.')

    def _drain_chunk_batch(self, dispatched):
        """Crop each chunk of a dispatched batch on the device, fetch
        the crops to the host in ONE copy, then check and write/return
        each chunk (or pack on the device for H5 output)."""
        out, batch, ready = dispatched
        if not batch:
            return {}
        with self._drain_context(out, ready):
            crops = [out[i][chunk.hr_crop_slice]
                     for i, chunk in enumerate(batch)]
            if self._pack_gate(batch):
                return self._pack_write(list(zip(batch, crops)))
            # timed apart: the copy waits for the batch's kernels
            flat = self.timer(_to_host, span='d2h')(
                torch.cat([c.reshape(-1) for c in crops]))
        self.stats['fetch_mb'] += flat.nbytes / 2 ** 20
        trace.count('fwp.d2h_bytes', flat.nbytes)
        self.stats['host_chunks'] += len(batch)
        outputs, start = {}, 0
        for chunk, crop in zip(batch, crops):
            size = crop.numel()
            out_i = flat[start:start + size].reshape(tuple(crop.shape))
            start += size
            self.timer(self._output_check, span='check')(
                out_i, allowed_const=self.strategy.allowed_const)
            if chunk.out_file is not None:
                self.timer(self._write, span='write')(chunk, out_i)
                outputs[chunk.index] = None
            else:
                outputs[chunk.index] = out_i
        return outputs

    # ------------------------------------------------------------------
    @classmethod
    def run(cls, strategy, node_index):
        """Run all this node's chunks (serial, IO-threaded, or
        device-batched; over the ranks of a mesh with ``use_mesh``)."""
        with trace.span('fwp.run', node=node_index,
                        pass_index=next(cls._passes)):
            return cls._run_node(strategy, node_index)

    @classmethod
    def _run_node(cls, strategy, node_index):
        with trace.span('fwp.init'):
            fwp = cls(strategy, node_index)
        finished = strategy.node_finished(node_index)
        chunk_ids = [] if finished else [
            i for i in strategy.node_chunks[node_index]
            if not strategy.chunk_finished(i)]
        if fwp.mesh is not None:
            # one plan for every rank, taken before any rank writes
            finished, chunk_ids = broadcast_object(
                fwp.mesh, (finished, chunk_ids))
        if finished:
            logger.info('All chunks for node %s already done.',
                        node_index)
            return None
        outputs = {}
        batch_size = max(1, getattr(strategy, 'device_batch_size', 1))
        if fwp.mesh is not None and strategy.use_mesh != 'spatial':
            # chunk fan-out: this rank's chunks, its share of each batch
            index, n = fwp.mesh.axis_index(fwp.mesh.axis_names[0]), (
                fwp.mesh.size)
            chunk_ids, batch_size = chunk_ids[index::n], -(-batch_size // n)
        trace.count('fwp.chunks', len(chunk_ids))
        if batch_size > 1 or strategy.use_mesh == 'spatial':
            outputs = fwp.run_chunks_batched(chunk_ids, batch_size)
        elif strategy.pass_workers > 1:
            with ThreadPoolExecutor(strategy.pass_workers) as pool:
                futures = {
                    pool.submit(cls._run_one, fwp, strategy, i): i
                    for i in chunk_ids}
                for fut, i in futures.items():
                    outputs[i] = fut.result()
        else:
            for i in chunk_ids:
                outputs[i] = cls._run_one(fwp, strategy, i)
        logger.info('Node %s finished %d chunks. Timing: %s Stats: %s',
                    node_index, len(chunk_ids), fwp.timer.log,
                    fwp.stats)
        if strategy.out_pattern is None:
            if fwp.mesh is not None:
                for part in all_gather_object(fwp.mesh, outputs):
                    outputs.update(part)
            return outputs
        return None

    @staticmethod
    def _run_one(fwp, strategy, chunk_index):
        chunk = fwp.timer(fwp.get_input_chunk, log=True,
                          span='prep')(chunk_index)
        _, out = fwp.timer(fwp.run_chunk, log=True)(
            chunk, allowed_const=strategy.allowed_const)
        return out
