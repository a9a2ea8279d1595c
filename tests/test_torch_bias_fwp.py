"""Bias correction through the port's ``ForwardPassStrategy`` against
the JAX strategy on the fixtures of tests/bias/test_fwp_qdm_presrat.py:
``local_qdm_bc``, ``local_presrat_bc`` and ``local_linear_bc``, eager
and ``chunked_io``, on a multi-chunk layout with spatial and temporal
padding (each chunk's factor window found by ``lr_padded_slice`` and its
date range rebuilt from the padded chunk's stamps). Every chunk's
corrected input agrees within rtol 1e-4 of its largest magnitude, and a
``chunked_io`` pass equals the eager one."""

import warnings

import h5py
import numpy as np
import pytest
import torch

from sup3r_tpu.pipeline import ForwardPassStrategy as JaxStrategy
from sup3r_tpu.utilities.test_helpers import make_fake_nc_file
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from tests.bias.test_fwp_qdm_presrat import S, _qdm_file
from tests.forward_pass.test_forward_pass import _s_gen_config, _save_model

torch.set_num_threads(1)

RTOL = 1e-4


def _linear_file(fp):
    rng = np.random.default_rng(8)
    lat = np.linspace(40.0, 39.0, S)[:, None].repeat(S, axis=1)
    lon = np.linspace(-105.5, -104.3, S)[None].repeat(S, axis=0)
    with h5py.File(fp, 'w') as f:
        f.create_dataset('latitude', data=lat)
        f.create_dataset('longitude', data=lon)
        f.create_dataset('u_100m_scalar', data=rng.uniform(
            0.5, 1.5, (S, S, 1)).astype(np.float32))
        f.create_dataset('u_100m_adder', data=rng.normal(
            0, 1, (S, S, 1)).astype(np.float32))
    return fp


def _case(tmp_path, method):
    """(input file, model dir, bias kwargs) of a method's fixture."""
    if method == 'local_presrat_bc':
        features = ['pr', 'u_100m']
        fp = _qdm_file(str(tmp_path / 'presrat.h5'), with_presrat=True,
                       k=1.25, tau=-1.5)
        kwargs = {'pr': {'bias_fp': fp, 'base_dset': 'ws',
                         'relative': False, 'feature_name': 'u_100m'}}
        raw = ['pr', 'u100']
    else:
        features = ['u_100m', 'v_100m']
        raw = ['u100', 'v100']
        if method == 'local_qdm_bc':
            fp = _qdm_file(str(tmp_path / 'qdm.h5'))
            kwargs = {'u_100m': {'bias_fp': fp, 'base_dset': 'ws',
                                 'relative': False}}
        else:
            fp = _linear_file(str(tmp_path / 'lin.h5'))
            kwargs = {'u_100m': {'bias_fp': fp, 'smoothing': 0.5}}
    input_file = make_fake_nc_file(str(tmp_path / 'input.nc'), (S, S, 6),
                                   raw)
    model_dir, _ = _save_model(str(tmp_path / 'm'), _s_gen_config(), 2, 1,
                               is_5d=False, features=features)
    return input_file, model_dir, kwargs


@pytest.mark.parametrize('chunked_io', [False, True],
                         ids=['eager', 'chunked_io'])
@pytest.mark.parametrize('method', ['local_qdm_bc', 'local_presrat_bc',
                                    'local_linear_bc'])
def test_corrected_chunks_match_jax(tmp_path, method, chunked_io):
    input_file, model_dir, bc_kwargs = _case(tmp_path, method)
    common = dict(file_paths=input_file, fwp_chunk_shape=(5, 5, 3),
                  spatial_pad=1, temporal_pad=1, out_pattern=None,
                  chunked_io=chunked_io, bias_correct_method=method,
                  bias_correct_kwargs=bc_kwargs)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        port = ForwardPassStrategy(
            model_kwargs={'model_dir': model_dir, 'device': 'cpu'},
            **common)
        jax = JaxStrategy(model_kwargs={'model_dir': model_dir}, **common)
        raw = ForwardPassStrategy(
            model_kwargs={'model_dir': model_dir, 'device': 'cpu'},
            **{**common, 'bias_correct_method': None,
               'bias_correct_kwargs': {}})
        assert port.fwp_slicer.n_chunks == jax.fwp_slicer.n_chunks == 8
        for idx in range(port.fwp_slicer.n_chunks):
            got, _ = port.prep_chunk_data(idx)
            want, _ = jax.prep_chunk_data(idx)
            unbiased, _ = raw.prep_chunk_data(idx)
            assert got.shape == want.shape
            tol = RTOL * float(np.abs(want).max())
            assert float(np.abs(got - want).max()) <= tol, idx
            # the first channel is corrected, the second untouched
            assert not np.allclose(got[..., 0], unbiased[..., 0])
            np.testing.assert_array_equal(got[..., 1], unbiased[..., 1])


def test_corrected_chunked_io_pass_equals_eager(tmp_path):
    input_file, model_dir, bc_kwargs = _case(tmp_path, 'local_qdm_bc')
    kw = dict(file_paths=input_file,
              model_kwargs={'model_dir': model_dir, 'device': 'cpu'},
              fwp_chunk_shape=(5, 5, 3), spatial_pad=1, temporal_pad=1,
              out_pattern=None, device_batch_size=2,
              bias_correct_method='local_qdm_bc',
              bias_correct_kwargs=bc_kwargs)
    eager = ForwardPass.run(ForwardPassStrategy(**kw), 0)
    streamed = ForwardPass.run(ForwardPassStrategy(chunked_io=True, **kw), 0)
    assert sorted(eager) == sorted(streamed) and len(eager) == 8
    for idx in eager:
        np.testing.assert_array_equal(streamed[idx], eager[idx])
