"""``Sup3rCondMom`` through the port's chunked ``ForwardPass`` against
the JAX package's, on tests/forward_pass/test_conditional_fwp.py's
fixture (a JAX save of a 4D first-moment model read by both packages):
outputs within 1e-4 of their largest magnitude, in one chunk and in
padded chunks written to NetCDF, and the stitched pass equal to the
unchunked ``generate``. Its ``generate`` has no ``fetch=``, so the pass
runs chunk by chunk, as the JAX package's does."""

import numpy as np
import pytest
import torch

from sup3r_tpu_torch.models import Sup3rCondMom
from sup3r_tpu_torch.models.abstract import supports_fetch
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from sup3r_tpu_torch.pipeline.memory import (
    estimate_activation_bytes,
    resolve_device_batch_size,
)
from tests.forward_pass.test_conditional_fwp import FEATURES, _cond_mom_model
from tests.test_torch_forward_pass import _nc_input, _run_both

torch.set_num_threads(1)


@pytest.fixture
def model_dir(tmp_path):
    return _cond_mom_model(tmp_path)


@pytest.mark.parametrize('chunks', [((12, 12, 4), 0, 0, None),
                                    ((6, 6, 2), 1, 1, None),
                                    ((6, 6, 2), 1, 1, 'nc')],
                         ids=['one_chunk', 'padded', 'padded_nc'])
def test_forward_pass_matches_jax(tmp_path, model_dir, chunks):
    shape, s_pad, t_pad, suffix = chunks
    strategy, port = _run_both(
        tmp_path, model_dir, suffix=suffix,
        file_paths=_nc_input(tmp_path, (12, 12, 4)),
        model_class='Sup3rCondMom', fwp_chunk_shape=shape,
        spatial_pad=s_pad, temporal_pad=t_pad,
        out_pattern=None)
    if suffix is None:
        assert all(np.isfinite(v).all() for v in port.values())
        assert strategy.fwp_slicer.n_chunks == len(port)


def test_stitched_pass_equals_generate(tmp_path, model_dir):
    """test_cond_mom_forward_pass: the padded, stitched pass equals the
    unchunked ``generate`` on the whole domain. The pads (2 LR cells)
    cover the network's reach, so the chunks' seams are exact; at the
    domain's edges the pass pads its input where ``generate``'s convs pad
    with zeros, so the 4 HR cells of the rim are left out."""
    strategy = ForwardPassStrategy(
        file_paths=_nc_input(tmp_path, (12, 12, 4)),
        model_kwargs={'model_dir': model_dir, 'device': 'cpu'},
        model_class='Sup3rCondMom', fwp_chunk_shape=(6, 6, 2),
        spatial_pad=2, temporal_pad=1, out_pattern=None)
    model = strategy.get_model()
    assert isinstance(model, Sup3rCondMom) and not supports_fetch(
        type(model))
    outputs = ForwardPass.run(strategy, 0)
    slicer = strategy.fwp_slicer
    full = np.full((24, 24, 4, 2), np.nan, np.float32)
    for idx, out in outputs.items():
        s_idx, t_idx = slicer.get_chunk_indices(idx)
        s1, s2 = slicer.s_hr_slices[s_idx]
        full[s1, s2, slicer.t_lr_slices[t_idx]] = out
    data = np.asarray(strategy.input_handler.data.as_array(FEATURES))
    direct = model.generate(np.transpose(data, (2, 0, 1, 3)))
    direct = np.transpose(direct, (1, 2, 0, 3))
    assert np.isfinite(full).all()
    np.testing.assert_allclose(full[4:-4, 4:-4], direct[4:-4, 4:-4],
                               rtol=0, atol=1e-4 * np.abs(direct).max())


def test_memory_counts_the_generator(model_dir):
    model = Sup3rCondMom.load(model_dir, device='cpu')
    per_chunk = estimate_activation_bytes(model, (10, 10, 4, 2))
    params = sum(p.numel() * 4 for p in model.gen_params)
    assert per_chunk > params > 0
    batch, spatial = resolve_device_batch_size(
        model, (10, 10, 4), 2, hbm_bytes=20 * per_chunk)
    assert not spatial and 1 <= batch <= 20
