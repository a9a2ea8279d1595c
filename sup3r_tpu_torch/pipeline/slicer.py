"""Chunking math for halo-padded forward passes.

This is the correctness heart of domain-decomposed inference: the
low-res domain splits into (s1, s2, t) chunks; each chunk is padded by
(spatial_pad, temporal_pad) low-res pixels of overlap before going
through the generator; the enhanced output is then cropped so stitched
chunks tile the high-res domain exactly.

The slice semantics here are verified bit-identical to the reference
(reference: sup3r/pipeline/slicer.py:20-716) by
tests/pipeline/test_slicer.py which executes the reference source
directly and sweeps parameters. The port's copy of
``sup3r_tpu/pipeline/slicer.py``, held bit-identical to it by
tests/test_torch_slicer.py.
"""

import itertools
import logging
from warnings import warn

import numpy as np

logger = logging.getLogger(__name__)


def get_chunk_slices(arr_size, chunk_size, index_slice=slice(None)):
    """Split range(arr_size)[index_slice] into consecutive slices of at
    most chunk_size (reference: sup3r/pipeline/utilities.py:27)."""
    start = index_slice.start or 0
    stop = min(index_slice.stop or arr_size, arr_size)
    return [slice(i, min(i + chunk_size, stop))
            for i in range(start, stop, chunk_size)]


def _parse_time_slice(value):
    if value is None:
        return slice(None)
    if isinstance(value, slice):
        return value
    return slice(*value)


class ForwardPassSlicer:
    """All padded/unpadded/cropped slice grids for chunked inference."""

    def __init__(self, coarse_shape, time_steps, s_enhance, t_enhance,
                 time_slice=None, temporal_pad=0, spatial_pad=0,
                 chunk_shape=None, min_width=None):
        """
        Parameters
        ----------
        coarse_shape : (s1, s2) full low-res spatial domain
        time_steps : total low-res time steps (before time_slice)
        s_enhance, t_enhance : enhancement factors
        time_slice : slice | list selecting the time range to process
        temporal_pad, spatial_pad : low-res halo widths
        chunk_shape : (s1, s2, t) max unpadded chunk shape
        min_width : per-dim minimum padded width required by the
            generator's first padding layer
        """
        self.coarse_shape = tuple(coarse_shape)
        self.time_steps = time_steps
        self.s_enhance = s_enhance
        self.t_enhance = t_enhance
        self.time_slice = _parse_time_slice(time_slice)
        self.temporal_pad = temporal_pad
        self.spatial_pad = spatial_pad
        self.chunk_shape = tuple(chunk_shape)
        self.min_width = (self.chunk_shape if min_width is None
                          else tuple(min_width))
        self.dummy_time_index = np.arange(time_steps)
        self._cache = {}

    def _cached(self, name, builder):
        if name not in self._cache:
            self._cache[name] = builder()
        return self._cache[name]

    # ------------------------------------------------------------------
    # low-res unpadded slices
    @property
    def s1_lr_slices(self):
        """Unpadded chunk slices along spatial dim 1."""
        return get_chunk_slices(self.coarse_shape[0], self.chunk_shape[0],
                                slice(0, self.coarse_shape[0]))

    @property
    def s2_lr_slices(self):
        """Unpadded chunk slices along spatial dim 2."""
        return get_chunk_slices(self.coarse_shape[1], self.chunk_shape[1],
                                slice(0, self.coarse_shape[1]))

    @property
    def t_lr_slices(self):
        """Unpadded time chunk slices (near-even np.array_split of the
        sliced time range)."""
        ti = self.dummy_time_index[self.time_slice]
        n_chunks = int(np.ceil(len(ti) / self.chunk_shape[2]))
        pieces = np.array_split(ti, n_chunks)
        return [slice(p[0], p[-1] + 1, self.time_slice.step)
                for p in pieces]

    @property
    def s_lr_slices(self):
        """Product of (s1, s2) unpadded slices."""
        return self._cached('s_lr_slices', lambda: list(
            itertools.product(self.s1_lr_slices, self.s2_lr_slices)))

    # ------------------------------------------------------------------
    # padded slices
    @staticmethod
    def get_padded_slices(slices, shape, enhancement, padding, step=None):
        """Pad each slice by ``step * padding * enhancement``, clamped to
        [0, enhancement * shape] (reference: slicer.py:509)."""
        step = step or 1
        pad = step * padding * enhancement
        out = []
        for s in slices:
            start = max(0, s.start * enhancement - pad)
            stop = min(enhancement * shape, s.stop * enhancement + pad)
            out.append(slice(start, stop, step))
        return out

    @property
    def s1_lr_pad_slices(self):
        """Padded slices along spatial dim 1."""
        return self._cached('s1_lr_pad', lambda: self.get_padded_slices(
            self.s1_lr_slices, self.coarse_shape[0], 1,
            self.spatial_pad))

    @property
    def s2_lr_pad_slices(self):
        """Padded slices along spatial dim 2."""
        return self._cached('s2_lr_pad', lambda: self.get_padded_slices(
            self.s2_lr_slices, self.coarse_shape[1], 1,
            self.spatial_pad))

    @property
    def s_lr_pad_slices(self):
        """Product of (s1, s2) padded slices."""
        return self._cached('s_lr_pad', lambda: list(
            itertools.product(self.s1_lr_pad_slices,
                              self.s2_lr_pad_slices)))

    @property
    def t_lr_pad_slices(self):
        """Padded time slices."""
        return self._cached('t_lr_pad', lambda: self.get_padded_slices(
            self.t_lr_slices, self.time_steps, 1, self.temporal_pad,
            step=self.time_slice.step))

    # ------------------------------------------------------------------
    # cropped slices (how much of each padded output to keep)
    @staticmethod
    def get_cropped_slices(unpadded_slices, padded_slices, enhancement):
        """Slices removing the halo from enhanced output (reference:
        slicer.py:590)."""
        out = []
        for ps, us in zip(padded_slices, unpadded_slices):
            step = us.step or 1
            start = stop = None
            if us.start is not None:
                start = enhancement * (us.start - ps.start) // step
            if us.stop is not None:
                stop = enhancement * (us.stop - ps.stop) // step
            if start is not None and start <= 0:
                start = None
            if stop is not None and stop >= 0:
                stop = None
            out.append(slice(start, stop))
        return out

    def check_boundary_slice(self, unpadded_slices, cropped_slices,
                             enhancement, padding, dim):
        """Adjust the last cropped slice when the final chunk is smaller
        than the generator's minimum input width (reference:
        slicer.py:547)."""
        lr_start = unpadded_slices[-1].start or 0
        lr_stop = unpadded_slices[-1].stop or self.coarse_shape[dim]
        padded_width = 2 * padding + lr_stop - lr_start
        if padded_width < self.min_width[dim]:
            half = self.min_width[dim] // 2 + 1
            warn(
                f'Final slice for dim #{dim + 1} '
                f'(slice({lr_start}, {lr_stop}), padding={padding}) is '
                'too small; reducing its start to meet the minimum '
                'width.')
            cropped_slices = list(cropped_slices)
            cropped_slices[-1] = slice(half * enhancement,
                                       -half * enhancement)
        return cropped_slices

    @property
    def s1_hr_crop_slices(self):
        """HR crop slices along spatial dim 1."""

        def build():
            start = self.s_enhance * self.spatial_pad or None
            stop = None if self.spatial_pad == 0 else -start
            crops = [slice(start, stop)] * len(self.s1_lr_slices)
            return self.check_boundary_slice(
                self.s1_lr_slices, crops, self.s_enhance,
                self.spatial_pad, 0)

        return self._cached('s1_hr_crop', build)

    @property
    def s2_hr_crop_slices(self):
        """HR crop slices along spatial dim 2."""

        def build():
            start = self.s_enhance * self.spatial_pad or None
            stop = None if self.spatial_pad == 0 else -start
            crops = [slice(start, stop)] * len(self.s2_lr_slices)
            return self.check_boundary_slice(
                self.s2_lr_slices, crops, self.s_enhance,
                self.spatial_pad, 1)

        return self._cached('s2_hr_crop', build)

    @property
    def s_hr_crop_slices(self):
        """Product of HR spatial crop slices."""
        return self._cached('s_hr_crop', lambda: list(
            itertools.product(self.s1_hr_crop_slices,
                              self.s2_hr_crop_slices)))

    def _exact_boundary_crops(self, lr_slices, pad_slices, crops, dim):
        """Write-consistent variant of the boundary-adjusted crop.

        The reference's ``check_boundary_slice`` keeps
        ``slice(half*e, -half*e)`` of data padded to
        ``pad_slice_width + 2*half`` — i.e. the PADDED-slice extent.
        With ``spatial_pad > 0`` that is ``spatial_pad`` columns wider
        than the chunk's raw extent, while ``hr_lat_lon``/``gids``
        span only the raw extent (reference slicer.py:583-585 +
        strategy.py:573-577): a latent reference inconsistency that
        crashes (or misaligns) the writer for boundary-adjusted final
        chunks. The corrected crop trims the extra leading halo so
        the kept region is exactly the raw extent; with
        ``spatial_pad == 0`` (where the reference math IS consistent)
        it reduces to the reference slice. The reference-faithful
        properties above are untouched (bit-parity-tested)."""
        lr_start = lr_slices[-1].start or 0
        lr_stop = lr_slices[-1].stop or self.coarse_shape[dim]
        padded_width = 2 * self.spatial_pad + lr_stop - lr_start
        if padded_width >= self.min_width[dim]:
            return crops
        half = self.min_width[dim] // 2 + 1
        lead = (lr_start - pad_slices[-1].start) * self.s_enhance
        crops = list(crops)
        crops[-1] = slice(half * self.s_enhance + lead,
                          -half * self.s_enhance)
        return crops

    @property
    def s_hr_crop_slices_exact(self):
        """Product of write-consistent HR spatial crop slices (see
        ``_exact_boundary_crops``)."""

        def build():
            s1 = self._exact_boundary_crops(
                self.s1_lr_slices, self.s1_lr_pad_slices,
                self.s1_hr_crop_slices, 0)
            s2 = self._exact_boundary_crops(
                self.s2_lr_slices, self.s2_lr_pad_slices,
                self.s2_hr_crop_slices, 1)
            return list(itertools.product(s1, s2))

        return self._cached('s_hr_crop_exact', build)

    @property
    def t_hr_crop_slices(self):
        """HR time crop slices — uniform halo crop (time is always
        evenly chunked; reference: slicer.py:216-241)."""

        def build():
            start = stop = None
            if self.temporal_pad > 0:
                start = self.t_enhance * self.temporal_pad
                stop = -start
            return [slice(start, stop)] * len(self.t_lr_slices)

        return self._cached('t_hr_crop', build)

    @property
    def s_lr_crop_slices(self):
        """LR crop slices (for cropping padded *input* chunks)."""

        def build():
            s1 = self.get_cropped_slices(self.s1_lr_slices,
                                         self.s1_lr_pad_slices, 1)
            s1 = self.check_boundary_slice(
                self.s1_lr_slices, s1, self.s_enhance, self.spatial_pad,
                0)
            s2 = self.get_cropped_slices(self.s2_lr_slices,
                                         self.s2_lr_pad_slices, 1)
            s2 = self.check_boundary_slice(
                self.s2_lr_slices, s2, self.s_enhance, self.spatial_pad,
                1)
            return list(itertools.product(s1, s2))

        return self._cached('s_lr_crop', build)

    @property
    def t_lr_crop_slices(self):
        """LR time crop slices."""
        return self._cached('t_lr_crop', lambda: self.get_cropped_slices(
            self.t_lr_slices, self.t_lr_pad_slices, 1))

    # ------------------------------------------------------------------
    # high-res output placement
    @staticmethod
    def get_hr_slices(slices, enhancement, step=None):
        """Scale slices by an enhancement factor."""
        if step is not None:
            step *= enhancement
        return [slice(s.start * enhancement, s.stop * enhancement, step)
                for s in slices]

    @property
    def s1_hr_slices(self):
        """HR slices along dim 1 for placing output in the full array."""
        return self.get_hr_slices(self.s1_lr_slices, self.s_enhance)

    @property
    def s2_hr_slices(self):
        """HR slices along dim 2."""
        return self.get_hr_slices(self.s2_lr_slices, self.s_enhance)

    @property
    def s_hr_slices(self):
        """Product of HR spatial placement slices."""
        return self._cached('s_hr', lambda: list(
            itertools.product(self.s1_hr_slices, self.s2_hr_slices)))

    @property
    def hr_crop_slices(self):
        """Per-time-chunk list of (s1, s2, t, feature) crop tuples for
        generator output."""

        def build():
            out = []
            for t in self.t_hr_crop_slices:
                out.append([(s[0], s[1], t, slice(None))
                            for s in self.s_hr_crop_slices])
            return out

        return self._cached('hr_crop', build)

    @property
    def hr_crop_slices_exact(self):
        """``hr_crop_slices`` with write-consistent boundary-adjusted
        spatial crops (see ``_exact_boundary_crops``) — what the
        strategy hands to chunks so output shapes always match
        ``hr_lat_lon``/``gids``."""

        def build():
            out = []
            for t in self.t_hr_crop_slices:
                out.append([(s[0], s[1], t, slice(None))
                            for s in self.s_hr_crop_slices_exact])
            return out

        return self._cached('hr_crop_exact', build)

    # ------------------------------------------------------------------
    # chunk accounting
    @property
    def n_spatial_chunks(self):
        """Number of spatial chunks."""
        return len(self.s1_lr_slices) * len(self.s2_lr_slices)

    @property
    def n_time_chunks(self):
        """Number of temporal chunks."""
        return len(self.t_lr_slices)

    @property
    def n_chunks(self):
        """Total chunks."""
        return self.n_spatial_chunks * self.n_time_chunks

    @property
    def chunk_lookup(self):
        """(n_s1, n_s2, n_t) array of chunk ids."""
        n_s1 = len(self.s1_lr_slices)
        n_s2 = len(self.s2_lr_slices)
        lookup = np.arange(self.n_chunks).reshape(
            (self.n_time_chunks, n_s1, n_s2))
        return np.transpose(lookup, (1, 2, 0))

    @property
    def spatial_chunk_lookup(self):
        """(n_s1, n_s2) array of spatial chunk ids."""
        n_s1 = len(self.s1_lr_slices)
        n_s2 = len(self.s2_lr_slices)
        return np.arange(self.n_spatial_chunks).reshape((n_s1, n_s2))

    def get_chunk_indices(self, chunk_index):
        """chunk id -> (spatial index, temporal index)."""
        return (chunk_index % self.n_spatial_chunks,
                chunk_index // self.n_spatial_chunks)

    # ------------------------------------------------------------------
    # extra np.pad widths applied to each chunk's input
    @staticmethod
    def _get_pad_width(window, max_steps, max_pad, min_width=None,
                       check_boundary=False):
        """Extra (before, after) pad for a window whose halo ran into the
        domain boundary (reference: slicer.py:625-673)."""
        win_start = window.start or 0
        win_stop = window.stop or max_steps
        start = int(max(0, max_pad - win_start))
        stop = int(max(0, max_pad + win_stop - max_steps))
        padded_width = 2 * max_pad + win_stop - win_start
        too_small = min_width is not None and padded_width < min_width
        if check_boundary and win_stop == max_steps and too_small:
            half = min_width // 2 + 1
            start = max(half, max_pad)
            stop = max(half, max_pad)
        return (start, stop)

    def get_pad_width(self, chunk_index):
        """((s1_lo, s1_hi), (s2_lo, s2_hi), (t_lo, t_hi)) extra pad for a
        chunk."""
        s_idx, t_idx = self.get_chunk_indices(chunk_index)
        ti_slice = self.t_lr_slices[t_idx]
        lr_slice = self.s_lr_slices[s_idx]
        return (
            self._get_pad_width(lr_slice[0], self.coarse_shape[0],
                                self.spatial_pad, self.min_width[0],
                                check_boundary=True),
            self._get_pad_width(lr_slice[1], self.coarse_shape[1],
                                self.spatial_pad, self.min_width[1],
                                check_boundary=True),
            self._get_pad_width(ti_slice, len(self.dummy_time_index),
                                self.temporal_pad),
        )

    @property
    def extra_padding(self):
        """Pad widths for every chunk."""
        return [self.get_pad_width(i) for i in range(self.n_chunks)]
