"""The slice as a whole for the Sup3rCC trh chain: the port's
``MultiStepSurfaceMetGan`` (``SurfaceSpatialMetModel`` then a temporal
GAN) through ``generate`` and the chunked ``ForwardPass`` against the
JAX package's, on the fixture of tests/forward_pass/test_exo_chains.py::
test_surface_met_gan_chain (explicit LR / HR topography steps) and of
tests/forward_pass/test_exo_matrix.py::test_output_combine_in_chain (the
steps a surface model gets by default), with the same input files, the
same topography source and the same weights (JAX save directories read
by the port's ``load``). Outputs agree within 1e-4 of each feature's
largest magnitude; the surface member's own output within 1e-5."""

import numpy as np
import pytest
import torch

from sup3r_tpu.models import MultiStepSurfaceMetGan as JaxChain
from sup3r_tpu.models import SurfaceSpatialMetModel as JaxSurface
from sup3r_tpu.utilities.test_helpers import (
    make_fake_h5_file,
    make_fake_nc_file,
)
from sup3r_tpu_torch.models import (
    MultiStepSurfaceMetGan,
    Sup3rGan,
    SurfaceSpatialMetModel,
)
from sup3r_tpu_torch.pipeline.memory import estimate_activation_bytes
from sup3r_tpu_torch.preprocessing import ExoDataHandler
from tests.forward_pass import test_exo_chains as chains
from tests.test_torch_exo_forward_pass import _run_both

torch.set_num_threads(1)

FEATURES = ['temperature_2m', 'relativehumidity_2m']
RTOL = 1e-4


def _feature_close(got, want, rtol=RTOL):
    assert got.shape == want.shape
    for i in range(want.shape[-1]):
        tol = rtol * float(np.abs(want[..., i]).max())
        err = float(np.abs(np.asarray(got[..., i], np.float64)
                           - want[..., i]).max())
        assert err <= tol, (i, err, tol)


@pytest.fixture
def chain_dirs(tmp_path):
    """(input file, topography file, surface dir, temporal dir) of the
    JAX fixture, saved by the JAX package."""
    input_file = make_fake_nc_file(str(tmp_path / 'met.nc'), (8, 8, 4),
                                   FEATURES)
    topo_file = make_fake_h5_file(
        str(tmp_path / 'topo.h5'), (40, 40, 2), ['windspeed_10m'],
        lat_range=(40.2, 38.8), lon_range=(-105.7, -104.1))
    surf_dir = str(tmp_path / 'surf')
    JaxSurface(FEATURES, s_enhance=2).save(surf_dir)
    temp_dir = chains._plain_temporal_gan(tmp_path, 'temp', FEATURES)
    return input_file, topo_file, surf_dir, temp_dir


def _model_kwargs(surf_dir, temp_dir):
    return {'surface_model_kwargs': {'model_dir': surf_dir},
            'temporal_model_kwargs': {'model_dirs': [temp_dir]}}


@pytest.mark.parametrize('chunk,s_pad,t_pad', [
    ((8, 8, 4), 0, 0), ((4, 4, 2), 1, 1)])
def test_surface_chain_fwp_explicit_steps(tmp_path, chain_dirs, chunk,
                                          s_pad, t_pad):
    """test_surface_met_gan_chain: LR topography as step 0's input and
    HR as its layer step, through the chunked pass of both packages (one
    chunk, and padded chunks)."""
    input_file, topo_file, surf_dir, temp_dir = chain_dirs
    steps = [{'model': 0, 'combine_type': 'input', 's_enhance': 1,
              't_enhance': 1},
             {'model': 0, 'combine_type': 'layer', 's_enhance': 2,
              't_enhance': 1}]
    strategy, out = _run_both(
        tmp_path, _model_kwargs(surf_dir, temp_dir),
        {'topography': {'source_file': topo_file, 'steps': steps}},
        file_paths=input_file, model_class='MultiStepSurfaceMetGan',
        fwp_chunk_shape=chunk, spatial_pad=s_pad, temporal_pad=t_pad,
        out_pattern=None)
    model = strategy.get_model()
    assert [type(m).__name__ for m in model.models] == [
        'SurfaceSpatialMetModel', 'Sup3rGan']
    assert model.device.type == 'cpu'
    if chunk == (8, 8, 4):
        assert out[0].shape == (16, 16, 16, 2)
        assert np.isfinite(out[0]).all()


def test_surface_chain_fwp_default_steps(tmp_path, chain_dirs):
    """test_output_combine_in_chain: without explicit steps a surface
    member takes topography as an input and an output step (trap 6: it
    is not a network, whatever the combine types say)."""
    input_file, topo_file, surf_dir, temp_dir = chain_dirs
    strategy, out = _run_both(
        tmp_path, _model_kwargs(surf_dir, temp_dir),
        {'topography': {'source_file': topo_file}},
        file_paths=input_file, model_class='MultiStepSurfaceMetGan',
        fwp_chunk_shape=(8, 8, 4), spatial_pad=0, temporal_pad=0,
        out_pattern=None)
    steps = strategy.exo_data['topography']['steps']
    assert [(s['model'], s['combine_type'], s['s_enhance'])
            for s in steps] == [(0, 'input', 1), (0, 'output', 2)]
    assert out[0].shape == (16, 16, 16, 2)


def _chain_exo(tmp_path, topo_file, chain):
    handler = ExoDataHandler(str(tmp_path / 'met.nc'), 'topography',
                             model=chain, source_file=topo_file,
                             cache_dir=str(tmp_path / 'exo_gen'))
    return handler.data


def test_chain_generate_matches_jax(tmp_path, chain_dirs):
    """``generate`` of both chains on the same 4D input and exo; the
    surface member hands the GAN a tensor on the device."""
    input_file, topo_file, surf_dir, temp_dir = chain_dirs
    kw = _model_kwargs(surf_dir, temp_dir)
    chain = MultiStepSurfaceMetGan.load(**kw, device='cpu')
    jax_chain = JaxChain.load(**kw)
    exo = _chain_exo(tmp_path, topo_file, chain)
    lr = np.random.default_rng(0).random((4, 8, 8, 2)).astype(np.float32)
    lr[..., 0] = 10 + 20 * lr[..., 0]
    lr[..., 1] = 100 * lr[..., 1]
    got = chain.generate(lr, exogenous_data=exo)
    want = jax_chain.generate(lr, exogenous_data=exo)
    assert got.shape == (1, 16, 16, 16, 2)
    _feature_close(got, want)
    surface = chain.models[0]
    hi = surface.generate(lr, exogenous_data=exo.get_model_step_exo(0),
                          fetch=False)
    assert isinstance(hi, torch.Tensor) and hi.shape == (4, 16, 16, 2)
    _feature_close(hi.numpy(), jax_chain.models[0].generate(
        lr, exogenous_data=exo.get_model_step_exo(0)), rtol=1e-5)
    with pytest.raises(AssertionError, match='4D'):
        chain.generate(lr[None], exogenous_data=exo)
    with pytest.raises(AssertionError, match='topography'):
        chain.generate(lr, exogenous_data=None)


def test_memory_counts_the_surface_member(chain_dirs):
    """The planner's estimate of a chain takes its hungriest member; the
    surface member, which has no parameters, counts its input and its HR
    output."""
    _, _, surf_dir, temp_dir = chain_dirs
    chain = MultiStepSurfaceMetGan.load(**_model_kwargs(surf_dir, temp_dir),
                                        device='cpu')
    surface, temporal = chain.models
    lr_shape = (10, 10, 6, 2)
    want_surface = 4 * int(np.prod(lr_shape)) * (1 + 4)
    assert estimate_activation_bytes(surface, lr_shape) == want_surface
    assert estimate_activation_bytes(chain, lr_shape) == max(
        want_surface, estimate_activation_bytes(temporal, (20, 20, 6, 2)))


def test_port_saves_load_in_the_jax_chain(tmp_path, chain_dirs):
    """The port's own save of both members loads in the JAX package's
    chain and gives its output."""
    input_file, topo_file, surf_dir, temp_dir = chain_dirs
    port_surf = str(tmp_path / 'port_surf')
    SurfaceSpatialMetModel.load(surf_dir, device='cpu').save(port_surf)
    port_temp = str(tmp_path / 'port_temp')
    Sup3rGan.load(temp_dir, device='cpu').save(port_temp)
    kw = _model_kwargs(port_surf, port_temp)
    kw['temporal_model_class'] = 'Sup3rGan'
    kw['temporal_model_kwargs'] = {'model_dir': port_temp}
    chain = MultiStepSurfaceMetGan.load(**kw, device='cpu')
    jax_chain = JaxChain.load(**kw)
    exo = _chain_exo(tmp_path, topo_file, chain)
    lr = np.random.default_rng(1).random((4, 8, 8, 2)).astype(np.float32)
    _feature_close(chain.generate(lr, exogenous_data=exo),
                   jax_chain.generate(lr, exogenous_data=exo))
