"""The port's ``ForwardPassSlicer`` is the JAX package's, bit for bit:
every slice property, chunk lookup and pad width agrees exactly over a
sweep of domain shapes, chunk shapes, pads, enhancements, time slices
and minimum widths (including the boundary-adjusted final chunks)."""

import inspect
import warnings

import numpy as np
import pytest

from sup3r_tpu.pipeline.slicer import ForwardPassSlicer as JaxSlicer
from sup3r_tpu_torch.pipeline.slicer import ForwardPassSlicer

PROPERTIES = sorted(
    name for name, member in inspect.getmembers(JaxSlicer)
    if isinstance(member, property))

#: (coarse_shape, time_steps, s_enhance, t_enhance, time_slice,
#:  temporal_pad, spatial_pad, chunk_shape, min_width)
CASES = [
    ((12, 12), 8, 3, 4, slice(None), 1, 1, (6, 6, 4), None),
    ((12, 12), 8, 3, 4, slice(None), 2, 2, (5, 7, 3), None),
    ((12, 12), 8, 1, 2, slice(None), 1, 1, (8, 8, 4), (4, 4, 4)),
    ((8, 8), 12, 3, 4, slice(None), 1, 1, (4, 4, 6), (4, 4, 4)),
    ((64, 64), 40, 3, 4, slice(None), 2, 2, (16, 16, 20), (4, 4, 4)),
    ((10, 10), 5, 2, 1, slice(None), 0, 1, (5, 5, 5), (4, 4, 1)),
    ((13, 7), 30, 5, 24, slice(2, 27), 3, 0, (4, 3, 7), None),
    ((9, 11), 20, 2, 2, slice(1, 19, 2), 1, 2, (4, 5, 3), (3, 3, 3)),
    ((8, 8), 8, 1, 2, slice(None), 1, 0, (7, 7, 4), None),
    ((31, 17), 16, 4, 3, [3, 14], 2, 3, (8, 6, 5), (5, 5, 3)),
    ((6, 6), 4, 3, 4, slice(None), 0, 0, (6, 6, 4), None),
    ((25, 25), 9, 2, 2, slice(0, 9), 4, 4, (3, 4, 2), (7, 7, 3)),
]


def _record(slicer):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        out = {name: getattr(slicer, name) for name in PROPERTIES}
        out['chunks'] = [(slicer.get_chunk_indices(i),
                          slicer.get_pad_width(i))
                         for i in range(slicer.n_chunks)]
    return out


@pytest.mark.parametrize('case', CASES, ids=[str(i) for i in
                                             range(len(CASES))])
def test_slicer_bit_identical(case):
    (coarse, steps, s_en, t_en, time_slice, t_pad, s_pad, chunk,
     min_width) = case
    kwargs = dict(coarse_shape=coarse, time_steps=steps, s_enhance=s_en,
                  t_enhance=t_en, time_slice=time_slice,
                  temporal_pad=t_pad, spatial_pad=s_pad, chunk_shape=chunk,
                  min_width=min_width)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        want = _record(JaxSlicer(**kwargs))
        got = _record(ForwardPassSlicer(**kwargs))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_equal(got[key], want[key], err_msg=key)
