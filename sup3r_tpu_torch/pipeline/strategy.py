"""Forward-pass planning: chunk grids, node assignment, input prep.

Reference parity: sup3r/pipeline/strategy.py:58-700 (ForwardPassStrategy,
ForwardPassChunk :38, node_chunks :364, incremental restart :667). The
port's copy of ``sup3r_tpu/pipeline/strategy.py`` for the eager,
single-device path, with exogenous data (``exo_handler_kwargs``) and
every model class the port exports (the solar composite's
``model_kwargs`` name its three groups' directories, ``t_enhance`` and
``device``; ``MultiStepSurfaceMetGan``'s its surface and temporal
models' kwargs and ``device``; ``Sup3rCondMom`` runs chunk by chunk, as
its ``generate`` has no ``fetch=``), ``chunked_io`` (each chunk
reads and derives only its padded window) and bias correction
(``bias_correct_method`` / ``bias_correct_kwargs``, run on each chunk's
padded input by ``bias.utilities.bias_correct_features``). ``use_mesh``
runs the node's chunks over a mesh of ranks (``sup3r_tpu_torch.parallel``:
every rank of the process group runs ``ForwardPass.run`` with the same
strategy): True fans each device batch's chunks out over the ranks,
'spatial' splits each chunk's s1 rows over them.
"""

import logging
import os
from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np

from sup3r_tpu_torch.pipeline.slicer import ForwardPassSlicer
from sup3r_tpu_torch.postprocessing.writers import OutputHandler
from sup3r_tpu_torch.preprocessing.data_handlers import (
    get_input_handler_class,
)
from sup3r_tpu_torch.preprocessing.exo import ExoData, ExoDataHandler
from sup3r_tpu_torch.preprocessing.rasterizers import Rasterizer
from sup3r_tpu_torch.utilities import Timer, TimeIndex, trace

logger = logging.getLogger(__name__)


#: process-level model cache: identity key (class + abspath'd kwargs +
#: the strategy's mode flags) -> (disk fingerprint, model instance).
#: ForwardPass loads the model at strategy init (meta planning) AND per
#: ForwardPass construction (reference loads per chunk/process,
#: forward_pass.py:638); each fresh instance re-reads the checkpoint,
#: copies the weights to the card and rebuilds its fused network. The
#: fingerprint (per-file mtime/size under any dir/file kwarg)
#: invalidates when the checkpoint on disk changes — and because the
#: identity is the DICT KEY, a re-saved checkpoint REPLACES the stale
#: entry instead of accumulating next to it (models pin params in
#: device memory). The identity also carries inference_mode so
#: concurrent strategies with different modes get separate instances
#: rather than racing on one instance's mutable flags.
_MODEL_CACHE = {}


def _model_fingerprint(val, stat=True):
    """Recursive fingerprint of every path-valued kwarg (model_dir /
    model_dirs lists): abspath + per-file (name, mtime_ns, size) for
    dirs AND single checkpoint files. ``stat=False`` yields the
    path-identity only (the cache's dict key — stable across
    re-saves, so stale entries are replaced, not retained)."""
    if isinstance(val, str) and os.path.isdir(val):
        if not stat:
            return os.path.abspath(val)
        out = []
        for root, _, files in sorted(os.walk(val)):
            for f in sorted(files):
                p = os.path.join(root, f)
                st = os.stat(p)
                out.append((os.path.relpath(p, val), st.st_mtime_ns,
                            st.st_size))
        return (os.path.abspath(val), tuple(out))
    if isinstance(val, str) and os.path.isfile(val):
        if not stat:
            return os.path.abspath(val)
        st = os.stat(val)
        return (os.path.abspath(val), st.st_mtime_ns, st.st_size)
    if isinstance(val, (list, tuple)):
        return tuple(_model_fingerprint(v, stat=stat) for v in val)
    if isinstance(val, dict):
        return tuple(sorted(
            (k, _model_fingerprint(v, stat=stat))
            for k, v in val.items()))
    return val


def _compose_slice(outer, inner):
    """Compose two contiguous slices: index ``inner`` within the
    extent selected by ``outer``."""
    base = 0 if outer.start is None else outer.start
    return slice(base + inner.start, base + inner.stop)


class _CoordsOnlyHandler:
    """Geometry-only stand-in for the full input handler on the head
    node and with ``chunked_io=True``: exposes lat_lon / time_index / a
    coords-only dataset; variable reads happen per chunk."""

    def __init__(self, rasterizer):
        self.rasterizer = rasterizer
        self.data = rasterizer.data
        self.lat_lon = rasterizer.lat_lon
        self.time_index = rasterizer.data.time_index


@dataclass
class ForwardPassChunk:
    """One chunk's padded input + metadata for generation/writing."""

    input_data: np.ndarray
    exo_data: Optional[dict]
    hr_crop_slice: tuple
    lr_pad_slice: tuple
    hr_lat_lon: np.ndarray
    hr_times: TimeIndex
    gids: np.ndarray
    out_file: Optional[str]
    pad_width: tuple
    index: int

    @property
    def shape(self):
        """Current input shape (derived — get_input_chunk replaces
        input_data with the padded array, so a captured value would
        go stale)."""
        return self.input_data.shape


@dataclass
class ForwardPassStrategy:
    """Plan a chunked forward-pass run over a full domain.

    Parameters mirror the reference strategy dataclass
    (sup3r/pipeline/strategy.py:58).
    """

    file_paths: Union[str, list]
    model_kwargs: dict
    model_class: str = 'Sup3rGan'
    fwp_chunk_shape: tuple = (None, None, None)
    spatial_pad: int = 0
    temporal_pad: int = 0
    input_handler_name: Optional[str] = None
    input_handler_kwargs: dict = field(default_factory=dict)
    out_pattern: Optional[str] = None
    exo_handler_kwargs: dict = field(default_factory=dict)
    bias_correct_method: Optional[str] = None
    bias_correct_kwargs: dict = field(default_factory=dict)
    allowed_const: Union[bool, list] = False
    incremental: bool = True
    #: minimum padded chunk widths required by the generator; None =
    #: derived from the model's layer config (reference default is a
    #: user-supplied (4, 4, 4), strategy.py:109)
    min_width: Optional[tuple] = None
    #: invert u/v output pairs to windspeed/winddirection on write;
    #: None = the reference default (True for H5, False for NetCDF)
    invert_uv: Optional[bool] = None
    #: NN-fill out-of-physical-range output values instead of clipping
    #: (reference default True, strategy.py:177)
    nn_fill: bool = True
    #: accepted for reference-config compatibility; a no-op here (the
    #: reference uses it to pin TF inference onto CPU,
    #: strategy.py:201 — device placement is explicit in this build)
    use_cpu: bool = True
    output_workers: int = 1
    pass_workers: int = 1
    max_nodes: int = 1
    head_node: bool = False
    redistribute_chunks: bool = False
    #: 'exact' (default) or 'fast' — named speed/accuracy profile
    #: applied to the loaded model (Sup3rGan.inference_mode): 'fast'
    #: enables the subpixel tail + bf16 body with a validated
    #: accuracy budget (tests/forward_pass/test_fast_mode.py)
    inference_mode: str = 'exact'
    #: stack this many same-shaped padded chunks into one device batch
    #: (amortizes per-dispatch host work and fills the card). 'auto'
    #: sizes the batch from a per-chunk memory estimate of the generator
    #: against the card's free memory (see pipeline/memory.py)
    device_batch_size: Union[int, str] = 1
    #: run device batches over the ranks of the process group (one
    #: device each, ``parallel.get_mesh``): True = each rank runs its
    #: share of every batch's chunks; 'spatial' = each rank runs its
    #: block of every chunk's s1 rows, with conv halo exchanges between
    #: neighbouring ranks (for chunks too large for one card); any other
    #: truthy value runs as True, as in the JAX package. Without a
    #: process group the mesh is this process alone
    use_mesh: Union[bool, str] = False
    #: stream input per chunk: only coordinates are loaded up front and
    #: each chunk reads just its padded window from disk (lazy NetCDF4
    #: slicing / windowed H5 gid reads; NetCDF3 is read whole per
    #: chunk). Replaces the reference's dask-lazy input handlers
    #: (sup3r/pipeline/strategy.py:253-266) for domains that don't fit
    #: in host RAM.
    chunked_io: bool = False
    #: device-side output packing for the batched drain: crop + u/v
    #: inversion + physical limits + storage quantization run on the
    #: card (ops/output_pack.py) and the device->host fetch carries
    #: cropped int16/uint16 bytes (>=2x fewer than float32, plus no
    #: halo). None = auto (on when supported: H5
    #: output files + a device-batched model; chunks with
    #: out-of-range values under nn_fill fall back to the host
    #: NaN-fill transform per chunk). False forces the
    #: host transform; True errors if unsupported. Values can differ
    #: from the host path by +-1 storage quantum at round() boundaries
    #: (device vs host trig ulps — tests/test_torch_output_pack.py).
    pack_output_on_device: Optional[bool] = None
    #: internal: explicit per-node chunk-id lists computed ONCE by the
    #: head process and shipped to every node subprocess through the
    #: node config. With ``redistribute_chunks`` the plan depends on
    #: which outputs exist WHEN IT IS COMPUTED — a late-starting node
    #: re-deriving it after its siblings finished chunks would get a
    #: shifted ``array_split`` and orphan work (the in-process variant
    #: of this race was found by tests/pipeline/test_chaos.py).
    node_chunks_plan: Optional[list] = None

    @trace.span('strategy.init')
    def __post_init__(self):
        self.timer = Timer('strategy')
        with trace.span('strategy.model'):
            model = self.get_model()
        self.s_enhance = model.s_enhance
        self.t_enhance = model.t_enhance
        self.input_features = [
            f for f in model.lr_features
            if f not in (self.exo_handler_kwargs or {})]
        self.exo_features = list(self.exo_handler_kwargs or {})
        self.features = self.input_features

        with trace.span('strategy.read'):
            ihk = dict(self.input_handler_kwargs)
            self.time_slice = ihk.pop('time_slice', slice(None))
            HandlerClass = get_input_handler_class(self.input_handler_name)
            if self.chunked_io:
                self.input_handler = self._init_chunked_io(ihk)
            elif self.head_node and ihk.get('hr_spatial_coarsen') in (
                    None, 0, 1) and not any(
                    ihk.get(k) for k in ('nan_method_kwargs', 'time_roll',
                                         'time_shift')):
                # planning pass: geometry + time index only — no variable
                # reads (reference: strategy.py head_node semantics).
                # hr_spatial_coarsen changes the planning grid shape and
                # nan-masking/time-remap kwargs can change the time index,
                # so those fall through to the full handler (planner and
                # workers MUST agree on chunk geometry).
                meta_keys = ('target', 'shape', 'threshold', 'raster_file',
                             'res_kwargs', 'full_grid_shape')
                self.input_handler = _CoordsOnlyHandler(Rasterizer(
                    self.file_paths, features=[],
                    **{k: ihk[k] for k in meta_keys if k in ihk}))
            else:
                load_ihk = dict(ihk)
                # eager mode with a narrow time_slice: load ONLY the
                # padded window instead of the file's whole time extent
                # (the reference passes a padded_time_slice the same way,
                # strategy.py:312-353); time_roll/time_shift remap the
                # global axis so they force a full load. All slicer time
                # slices stay in RAW file coordinates — reads are shifted
                # by the loaded window's start (self._time_offset).
                if (isinstance(self.time_slice, slice)
                        and self.time_slice != slice(None)
                        and not ihk.get('time_roll')
                        and not ihk.get('time_shift')):
                    n_full = self._probe_time_len(ihk)
                    if n_full:
                        start, stop, step = self.time_slice.indices(n_full)
                        t0 = max(start - self.temporal_pad * step, 0)
                        t1 = min(stop + self.temporal_pad * step, n_full)
                        load_ihk['time_slice'] = slice(t0, t1)
                        self._time_offset = t0
                        self._n_times_full = n_full
                self.input_handler = HandlerClass(
                    self.file_paths, features=self.features, **load_ihk)

        grid_shape = self.input_handler.lat_lon.shape[:2]
        n_times = (getattr(self, '_n_times_full', None)
                   or len(self.input_handler.time_index))
        chunk_shape = tuple(
            c if c is not None else (grid_shape + (n_times,))[i]
            for i, c in enumerate(self.fwp_chunk_shape))
        self.fwp_chunk_shape = chunk_shape

        min_width = self.min_width
        if min_width is None:
            min_width = getattr(model, 'min_input_width', None)
            if callable(min_width):
                min_width = None
            if min_width is None and hasattr(model, '_gen'):
                min_width = model._gen.min_input_width
        if min_width is not None and len(min_width) == 2:
            min_width = (*min_width, 1)

        with trace.span('strategy.plan'):
            self.fwp_slicer = ForwardPassSlicer(
                coarse_shape=grid_shape, time_steps=n_times,
                s_enhance=self.s_enhance, t_enhance=self.t_enhance,
                time_slice=self.time_slice, temporal_pad=self.temporal_pad,
                spatial_pad=self.spatial_pad, chunk_shape=chunk_shape,
                min_width=min_width)

        # the head node only plans node_chunks: it skips the exo
        # rasterization, which the worker nodes do themselves
        with trace.span('strategy.exo'):
            self.exo_data = (None if self.head_node
                             else self.load_exo_data(model))
        self.gids = np.arange(
            grid_shape[0] * self.s_enhance
            * grid_shape[1] * self.s_enhance).reshape(
            (grid_shape[0] * self.s_enhance,
             grid_shape[1] * self.s_enhance))
        self._hr_lat_lon = None
        self._out_files = None
        # freeze the node plan NOW: with redistribute_chunks the split
        # depends on which outputs exist, and deferring it to first
        # access would let nodes that start late see other nodes'
        # fresh outputs and compute a DIFFERENT (shifted) plan,
        # orphaning chunks (tests/pipeline/test_chaos.py)
        _ = self.node_chunks

    # ------------------------------------------------------------------
    def get_model(self):
        """Instantiate/load the model from model_class + model_kwargs
        (``model_kwargs`` carries ``device`` through to ``load``; the
        default is the card)."""
        from sup3r_tpu_torch import models as models_mod

        ModelClass = getattr(models_mod, self.model_class, None)
        if ModelClass is None:
            raise KeyError(f'Could not find model class '
                           f'"{self.model_class}" in sup3r_tpu_torch.models')
        kwargs = self.model_kwargs
        if isinstance(kwargs, str):
            kwargs = {'model_dir': kwargs}
        try:
            identity = (self.model_class,
                        _model_fingerprint(kwargs, stat=False),
                        self.inference_mode)
            fingerprint = _model_fingerprint(kwargs)
            hash((identity, fingerprint))
        except (TypeError, OSError):
            identity = None  # unhashable kwargs / racing fs: no cache
        entry = _MODEL_CACHE.get(identity) if identity else None
        model = entry[1] if entry and entry[0] == fingerprint else None
        if model is None:
            model = ModelClass.load(**kwargs)
            if identity is not None:
                # same-identity insert REPLACES a stale entry
                _MODEL_CACHE[identity] = (fingerprint, model)
        if self.inference_mode != 'exact' and not hasattr(
                type(model), 'inference_mode'):
            raise ValueError(f'{self.model_class} does not support '
                             f'inference_mode={self.inference_mode!r}')
        # reset the mutable inference flags unconditionally: a cached
        # instance may carry another strategy's mode or shard setting
        if hasattr(type(model), 'inference_mode'):
            model.inference_mode = self.inference_mode
        if hasattr(type(model), 'inference_shard_aligned'):
            model.inference_shard_aligned = False
        return model

    def load_exo_data(self, model):
        """ExoData of every exo feature (reference: strategy.py:583-628).
        The rasters live on the raw file time axis, as the slicer's chunk
        slices do; the cache defaults under the output directory unless
        ``SUP3R_TPU_EXO_CACHE_DIR`` pins one."""
        if not self.exo_handler_kwargs:
            return None
        data = {}
        ihk_exo = {k: v for k, v in self.input_handler_kwargs.items()
                   if k != 'time_slice'}
        for feature in self.exo_features:
            kwargs = dict(self.exo_handler_kwargs[feature])
            kwargs.setdefault('file_paths', self.file_paths)
            kwargs.setdefault('input_handler_kwargs', ihk_exo)
            if (self.out_pattern is not None
                    and not os.environ.get('SUP3R_TPU_EXO_CACHE_DIR')):
                kwargs.setdefault('cache_dir', os.path.join(
                    os.path.dirname(os.path.abspath(self.out_pattern)),
                    'exo_cache'))
            kwargs['feature'] = feature
            kwargs['model'] = model
            data.update(ExoDataHandler(**kwargs).data)
        return ExoData(data)

    # ------------------------------------------------------------------
    @property
    def hr_lat_lon(self):
        """Full-domain high-res coordinates."""
        if self._hr_lat_lon is None:
            lr = self.input_handler.lat_lon
            shape = tuple(d * self.s_enhance for d in lr.shape[:2])
            self._hr_lat_lon = OutputHandler.get_lat_lon(
                np.array(lr, dtype=np.float64), shape)
        return self._hr_lat_lon

    @property
    def out_files(self):
        """Chunk output file paths named by _tttttt_ssssss ids."""
        if self._out_files is None:
            ids = [f'{t:06d}_{s:06d}'
                   for t in range(self.fwp_slicer.n_time_chunks)
                   for s in range(self.fwp_slicer.n_spatial_chunks)]
            if self.out_pattern is None:
                self._out_files = [None] * len(ids)
            else:
                assert '{file_id}' in self.out_pattern, (
                    'out_pattern must include {file_id}')
                os.makedirs(os.path.dirname(
                    os.path.abspath(self.out_pattern)), exist_ok=True)
                self._out_files = [
                    self.out_pattern.format(file_id=fid) for fid in ids]
        return self._out_files

    @property
    def node_chunks(self):
        """Chunk-id lists per node (reference: strategy.py:364).

        Computed ONCE and cached: with ``redistribute_chunks`` the
        split depends on which outputs exist, and re-deriving it at
        run time would shift every node's assignment as other nodes
        complete chunks — orphaning work (found by
        tests/pipeline/test_chaos.py kill-resume)."""
        if not hasattr(self, '_node_chunks'):
            if self.node_chunks_plan is not None:
                # head-computed plan shipped through the node config:
                # every node subprocess uses the ONE plan the head
                # froze, however late it starts (see the field doc)
                self._node_chunks = [
                    np.asarray(c, dtype=int)
                    for c in self.node_chunks_plan]
                return self._node_chunks
            chunks = self.unmasked_chunks
            if self.redistribute_chunks:
                chunks = [c for c in chunks
                          if not self.chunk_finished(c, log=False)]
            n_nodes = int(min(self.max_nodes or np.inf,
                              max(len(chunks), 1)))
            self._node_chunks = np.array_split(chunks, n_nodes)
        return self._node_chunks

    @property
    def fwp_mask(self):
        """Per-spatial-chunk skip mask: True where a 'mask' variable in
        the input covers the entire padded chunk (e.g. all-ocean
        chunks; reference: strategy.py:631-661)."""
        if not hasattr(self, '_fwp_mask'):
            n_spatial = self.fwp_slicer.n_spatial_chunks
            mask = np.zeros(n_spatial, dtype=bool)
            data = self.input_handler.data
            if 'mask' not in getattr(data, 'features', []):
                # mask may exist in the source without being a model
                # feature; probe the raw files
                try:
                    ihk = dict(self.input_handler_kwargs)
                    ihk.pop('time_slice', None)
                    HandlerClass = get_input_handler_class(
                        self.input_handler_name)
                    data = HandlerClass(
                        self.file_paths, features=['mask'],
                        time_slice=slice(0, 1), **ihk).data
                except (KeyError, RuntimeError):
                    # no 'mask' variable in the source files — the only
                    # expected miss. Anything else (IO errors, bad
                    # kwargs) must propagate: silently disabling the
                    # ocean-chunk skip turns a config error into a
                    # 2-5x cost increase on production domains.
                    logger.info('No "mask" variable in the input '
                                'files; not skipping any chunks.')
                    data = self.input_handler.data
            if 'mask' in getattr(data, 'features', []):
                mask_vals = data['mask']
                if mask_vals.ndim == 3:
                    mask_vals = mask_vals[..., 0]
                for s_idx, lr_slices in enumerate(
                        self.fwp_slicer.s_lr_pad_slices):
                    chunk_mask = mask_vals[lr_slices[0], lr_slices[1]]
                    mask[s_idx] = bool(np.prod(chunk_mask))
                logger.info('Masking %d of %d spatial chunks',
                            int(mask.sum()), n_spatial)
            self._fwp_mask = mask
        return self._fwp_mask

    def chunk_masked(self, chunk_index, log=True):
        """Whether a chunk is skipped by the spatial mask."""
        s_idx, _ = self.fwp_slicer.get_chunk_indices(chunk_index)
        masked = bool(self.fwp_mask[s_idx])
        if masked and log:
            logger.info('Chunk %s is masked; skipping', chunk_index)
        return masked

    @property
    def unmasked_chunks(self):
        """Chunk ids not skipped by the spatial mask."""
        return [i for i in range(self.fwp_slicer.n_chunks)
                if not self.chunk_masked(i, log=False)]

    def chunk_finished(self, chunk_index, log=True):
        """True if the chunk output file already exists (incremental
        restart; reference: strategy.py:667)."""
        out_file = self.out_files[chunk_index]
        check = (out_file is not None and os.path.exists(out_file)
                 and self.incremental)
        if check and log:
            logger.info('Chunk %s already done (%s exists)', chunk_index,
                        out_file)
        return check

    def node_finished(self, node_idx):
        """True if all the node's chunks are finished."""
        return all(self.chunk_finished(i, log=False)
                   for i in self.node_chunks[node_idx])

    @property
    def meta(self):
        """Run metadata for output files."""
        return {
            'fwp_chunk_shape': self.fwp_chunk_shape,
            'spatial_pad': self.spatial_pad,
            'temporal_pad': self.temporal_pad,
            'model_kwargs': self.model_kwargs
            if not isinstance(self.model_kwargs, dict)
            else {k: str(v)[:100] for k, v in self.model_kwargs.items()},
            'model_class': self.model_class,
        }

    # ------------------------------------------------------------------
    def _local_t(self, sl):
        """Raw file-coordinate time slice -> the eager handler's
        loaded-window coordinates (no-op unless the handler was
        window-loaded)."""
        off = getattr(self, '_time_offset', 0)
        if not off:
            return sl
        return slice(sl.start - off, sl.stop - off, sl.step)

    def _probe_time_len(self, ihk):
        """Full-file time length from a coords-only read (for
        windowed eager loading)."""
        try:
            meta_keys = ('target', 'shape', 'threshold',
                         'raster_file', 'res_kwargs',
                         'full_grid_shape')
            rast = Rasterizer(
                self.file_paths, features=[],
                **{k: ihk[k] for k in meta_keys if k in ihk})
            ti = rast.data.time_index
            return len(ti) if ti is not None else None
        except Exception:  # pragma: no cover - fall back to full load
            logger.warning('Could not probe the file time length; '
                           'loading the full time extent',
                           exc_info=True)
            return None

    def prep_chunk_data(self, chunk_index=0):
        """The padded low-res input of a chunk, bias corrected when the
        strategy asks for it, and its exo rasters (``ExoData.get_chunk``
        of the padded slices, or None)."""
        s_idx, t_idx = self.fwp_slicer.get_chunk_indices(chunk_index)
        lr_pad_slice = self.fwp_slicer.s_lr_pad_slices[s_idx]
        ti_pad_slice = self.fwp_slicer.t_lr_pad_slices[t_idx]
        exo_data = (self.exo_data.get_chunk(
            [lr_pad_slice[0], lr_pad_slice[1], ti_pad_slice])
            if self.exo_data is not None else None)
        if self.chunked_io:
            input_data = self._read_chunk_window(lr_pad_slice,
                                                 ti_pad_slice)
        else:
            data = self.input_handler.data
            input_data = np.array(data.as_array(self.features)[
                lr_pad_slice[0], lr_pad_slice[1],
                self._local_t(ti_pad_slice)])

        if self.bias_correct_kwargs:
            from sup3r_tpu_torch.bias.utilities import (
                bias_correct_features,
            )

            # full-domain lat_lon (the coordinates-only handler's under
            # chunked_io) + lr_padded_slice: factor rasters are windowed
            # file->domain by coordinate match, then domain->chunk by
            # slice (reference: bias_transforms.py lr_padded_slice args)
            input_data = bias_correct_features(
                features=list(self.bias_correct_kwargs),
                data=input_data, feature_names=self.features,
                lat_lon=self.input_handler.lat_lon,
                time_index=self.input_handler.time_index[
                    self._local_t(ti_pad_slice)],
                bc_method=self.bias_correct_method,
                bc_kwargs=self.bias_correct_kwargs,
                lr_padded_slice=lr_pad_slice)
        return input_data, exo_data

    def init_chunk(self, chunk_index=0):
        """Build the ForwardPassChunk for a chunk id."""
        s_idx, t_idx = self.fwp_slicer.get_chunk_indices(chunk_index)
        assert chunk_index <= self.fwp_slicer.n_chunks, (
            f'chunk_index {chunk_index} > n_chunks '
            f'{self.fwp_slicer.n_chunks}')
        hr_slice = self.fwp_slicer.s_hr_slices[s_idx]
        ti_slice = self.fwp_slicer.t_lr_slices[t_idx]
        lr_times = self.input_handler.time_index[
            self._local_t(ti_slice)]
        input_data, exo_data = self.timer(
            self.prep_chunk_data, log=True)(chunk_index)
        return ForwardPassChunk(
            input_data=input_data,
            exo_data=exo_data,
            lr_pad_slice=self.fwp_slicer.s_lr_pad_slices[s_idx],
            hr_crop_slice=(
                self.fwp_slicer.hr_crop_slices_exact[t_idx][s_idx]),
            hr_lat_lon=self.hr_lat_lon[hr_slice[0], hr_slice[1]],
            hr_times=OutputHandler.get_times(
                lr_times, self.t_enhance * len(lr_times)),
            gids=self.gids[hr_slice[0], hr_slice[1]],
            out_file=self.out_files[chunk_index],
            pad_width=self.fwp_slicer.get_pad_width(chunk_index),
            index=chunk_index)

    def _init_chunked_io(self, ihk):
        """Coords-only setup for streaming reads: resolve the raster
        extent once (coordinate search / flat-grid walk), keep only
        geometry in memory, and stash per-chunk handler kwargs."""
        from sup3r_tpu_torch.preprocessing.loaders import get_source_type

        ihk = dict(ihk)
        # hr_spatial_coarsen=1 is identity, but time_roll/time_shift
        # of 1 are real one-step remaps — only None/0 are no-ops there
        unsupported = {k: v for k, v in (
            ('hr_spatial_coarsen', ihk.get('hr_spatial_coarsen')),
            ('time_roll', ihk.get('time_roll')),
            ('time_shift', ihk.get('time_shift')))
            if (v not in (None, 0, 1)
                or (v == 1 and k != 'hr_spatial_coarsen'))}
        assert not unsupported, (
            f'chunked_io does not support {list(unsupported)} — these '
            'remap the global grid/time axes, incompatible with '
            'per-chunk windowed reads')
        rk = dict(ihk.get('res_kwargs') or {})
        if get_source_type(self.file_paths) == 'nc':
            rk['lazy'] = True
        ihk['res_kwargs'] = rk
        meta_keys = ('target', 'shape', 'threshold', 'raster_file',
                     'res_kwargs', 'full_grid_shape')
        meta_kwargs = {k: ihk[k] for k in meta_keys if k in ihk}
        self._meta_rast = Rasterizer(self.file_paths, features=[],
                                     **meta_kwargs)
        # per-chunk kwargs: the window supersedes extent matching
        for k in ('target', 'shape', 'raster_file', 'threshold',
                  'cache_kwargs', 'hr_spatial_coarsen', 'time_roll',
                  'time_shift', 'full_grid_shape'):
            ihk.pop(k, None)
        self._chunk_ihk = ihk
        self._set_chunked_clearsky_scale(ihk)
        return _CoordsOnlyHandler(self._meta_rast)

    def _set_chunked_clearsky_scale(self, ihk):
        """chunked_io x DataHandlerNCforCC: the eager handler scales
        its regridded NSRDB clearsky_ghi by the PER-PIXEL
        max_t(rsds)/max_t(cs) ratio (reference: nc_cc.py:231-240);
        per-window handlers only see a time window, so their local
        time-maxima diverge from the full-axis ones. Compute the
        full-domain (s1, s2) scale raster once here with blocked
        reads and stash it in the per-chunk handler kwargs; chunk
        windows slice it spatially in _read_chunk_window."""
        from sup3r_tpu_torch.preprocessing.data_handlers import (
            DataHandlerNCforCC,
        )

        HandlerClass = get_input_handler_class(self.input_handler_name)
        nsrdb_fp = ihk.get('nsrdb_source_fp')
        need_cs = any(str(f).lower() in ('clearsky_ratio', 'clearsky_ghi')
                      for f in (self.features or []))
        if (not issubclass(HandlerClass, DataHandlerNCforCC)
                or nsrdb_fp is None or not need_cs):
            return
        if ihk.get('clearsky_scale') is not None:
            # precomputed (e.g. by the head node, shipped through the
            # node config as an .npy path) — don't redo the
            # full-domain NSRDB scan on every worker
            scale = ihk['clearsky_scale']
            if isinstance(scale, str):
                scale = np.load(scale)
            self._chunk_ihk['clearsky_scale'] = scale
            return
        gcm_ti = self._meta_rast.data.time_index
        grid = self._meta_rast.lat_lon.reshape(-1, 2)
        n_pts = len(grid)
        s1, s2 = self._meta_rast.grid_shape

        # per-point unscaled clearsky time-max, blocked by points
        cs_max = np.empty(n_pts, dtype=np.float32)
        pblock = 65536
        for p0 in range(0, n_pts, pblock):
            out = HandlerClass._regrid_clearsky(
                nsrdb_fp, ihk.get('nsrdb_agg', 1),
                grid[p0:p0 + pblock], gcm_ti)
            cs_max[p0:p0 + pblock] = np.nanmax(out, axis=0)

        # per-pixel rsds time-max, blocked in time
        rsds_max = np.full((s1, s2), -np.inf, dtype=np.float32)
        n_t = len(gcm_ti)
        tblock = max(1, int(4e7 // max(n_pts, 1)))
        for t0 in range(0, n_t, tblock):
            rast = Rasterizer(
                self.file_paths, features=['rsds'],
                window=self._meta_rast.raster_index,
                time_slice=slice(t0, min(t0 + tblock, n_t)),
                res_kwargs=self._chunk_ihk.get('res_kwargs'))
            rsds_max = np.fmax(rsds_max, np.nanmax(
                np.asarray(rast.data['rsds']), axis=-1))
            if hasattr(rast.loader, 'close'):
                rast.loader.close()
        scale = (rsds_max / np.maximum(cs_max.reshape(s1, s2), 1e-6)
                 ).astype(np.float32)
        logger.info('chunked_io NCforCC: per-pixel clearsky scale in '
                    '[%.6g, %.6g]', float(np.nanmin(scale)),
                    float(np.nanmax(scale)))
        self._chunk_ihk['clearsky_scale'] = scale

    def _read_chunk_window(self, lr_pad_slice, ti_pad_slice):
        """Build a windowed DataHandler for one padded chunk: reads
        only that window from disk, then derives features on it."""
        meta_idx = self._meta_rast.raster_index
        if isinstance(meta_idx, np.ndarray):
            window = meta_idx[lr_pad_slice[0], lr_pad_slice[1]]
        else:
            window = (_compose_slice(meta_idx[0], lr_pad_slice[0]),
                      _compose_slice(meta_idx[1], lr_pad_slice[1]))
        HandlerClass = get_input_handler_class(self.input_handler_name)
        chunk_ihk = self._chunk_ihk
        scale = chunk_ihk.get('clearsky_scale')
        if isinstance(scale, np.ndarray) and scale.ndim == 2:
            # full-domain per-pixel scale raster -> this chunk's window
            chunk_ihk = {**chunk_ihk,
                         'clearsky_scale': scale[lr_pad_slice[0],
                                                 lr_pad_slice[1]]}
        handler = HandlerClass(
            self.file_paths, features=self.features, window=window,
            time_slice=ti_pad_slice, **chunk_ihk)
        out = np.asarray(handler.data.as_array(self.features),
                         dtype=np.float32)
        # lazy loaders keep h5py handles open for window reads; close
        # them explicitly so thousands of chunks can't exhaust fds
        loader = getattr(getattr(handler, 'rasterizer', None),
                         'loader', None)
        if loader is not None and hasattr(loader, 'close'):
            loader.close()
        return out
