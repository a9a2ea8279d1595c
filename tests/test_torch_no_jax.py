"""The port stands alone: ``sup3r_tpu_torch`` imports and serves with
jax, jaxlib, flax, optax, the JAX package, pandas, h5py and msgpack all
unimportable — as on the card's machine — and it never drops quietly to
the CPU. The blocked run also saves a model, reloads it, runs the
chunked ForwardPass from a NetCDF3 input to NetCDF output, runs it again
for a MultiStepGan (a topography GAN then LinearInterp) with a NetCDF3
topography source (preprocessing.exo, models.multi_step, models.linear),
takes one
train step and trains one BatchHandler epoch (history, checkpoint with
optimizer state, reload), serves in fast mode, takes a bf16 and a remat
step, trains one epoch over a DualBatchHandler of DualRasterizer
data, runs the Sup3rCC solar chain (SolarMultiStepGan with a SolarCC
temporal member) through the ForwardPass from a daily NetCDF3 input, and
trains a SolarCC epoch over a BatchHandlerCC of DataHandlerH5SolarCC data
from a NetCDF3 file of ghi and clearsky_ghi (preprocessing.samplers,
batch_handlers, data_handlers; the solar package imports, its H5 I/O
needing h5py). A second blocked run (PIL blocked too) serves the
Sup3rCC trh chain (MultiStepSurfaceMetGan: the physics surface model,
whose resampling replaces PIL's, then a temporal GAN) through the
ForwardPass with a NetCDF3 topography source, fuses NetCDF3 station
observations into a Sup3rGanWithObs forward pass (ObsRasterizer), takes
a WithObs train step and trains a Sup3rGanDC epoch over a
BatchHandlerDC. A third blocked run (tensorboard blocked too, as on the
card's machine) trains a Sup3rCondMom over a BatchHandlerMom1 through a
TrainingSession with tensorboard_log (a warning, no logs), a second
moment over a BatchHandlerMom2 whose producer thread runs the first,
serves it through the ForwardPass (model_class='Sup3rCondMom'), profiles
a Sup3rGan epoch with tensorboard_profile, and exports and imports a
reference-format checkpoint (utilities.port). A fourth blocked run
drives the streaming slice: a chunked_io pass, the power-law GCM handler
through chunked_io, and an epoch over a lazy DataHandler. A fifth
blocked run drives the bias slice: a QDM calibration from NetCDF3 files
(a gridded baseline) on device='cpu', its NetCDF3 factor file, a
bias-corrected ForwardPass (eager and chunked_io) and the handler-level
qdm_bc. A sixth blocked run (click blocked too) drives the command line:
``sup3r_tpu_torch/cli.py ... pipeline --monitor`` from a directory
outside the repo with only the blocker on ``PYTHONPATH``, forward-pass
on two nodes, data-collect and qa, the blocker active in the parent and
in every node; and a forward-pass node run as a group of two ranks, the
blocker active in its launcher and both ranks. The first blocked run
also drives the native host helpers (``_native``). A seventh blocked run
drives the mesh slice: two spawned
gloo ranks, the blocker active in each, take a data-parallel train step
(the same losses on both), a dp x sp step on a 1 x 2 mesh (halo
exchanges, a row-parallel Dense and their backwards; the single-process
step's losses) and run a ``use_mesh='spatial'`` forward pass
equal to the parent's single-process pass. An eighth blocked run drives
the names the last slice ported (grid, interp, weights and network
methods, the fake-data helpers) and the world-of-one 'auto' fallback."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sup3r_tpu_torch.configs import generator_st
from sup3r_tpu_torch.models import SolarCC, Sup3rGan

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'sup3r_tpu', 'pandas', 'h5py',
           'msgpack', 'PIL')

_BLOCKER = f'''
import importlib.abc
import importlib.util
import sys

BLOCKED = {BLOCKED!r}


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ModuleNotFoundError(f'{{name}} is blocked')
        return None


sys.meta_path.insert(0, Blocker())
# a module that is not installed has no spec: probes (torch._dynamo's,
# which torch.utils.checkpoint imports) see None, not an error
_find_spec = importlib.util.find_spec
importlib.util.find_spec = lambda name, package=None: (
    None if name.split('.')[0] in BLOCKED else _find_spec(name, package))

import numpy as np
import torch

torch.set_num_threads(1)
'''

_SCRIPT = _BLOCKER + f'''
from sup3r_tpu_torch.configs import generator_st
from sup3r_tpu_torch.models import Sup3rGan

model = Sup3rGan(generator_st(2, (3,), (2, 2), filters=8, n_resblocks=1),
                 [{{'class': 'Flatten'}}, {{'class': 'Dense', 'units': 1}}],
                 meta={{'lr_features': ['u', 'v'],
                       'hr_out_features': ['u', 'v']}},
                 means={{'u': 1.0, 'v': 0.0}}, stdevs={{'u': 2.0, 'v': 1.0}},
                 device='cpu')
lr = np.random.default_rng(0).standard_normal((1, 4, 4, 3, 2))
out = model.generate(lr.astype(np.float32))
assert out.shape == (1, 12, 12, 12, 2) and np.isfinite(out).all()
print('SERVED', out.shape)

from sup3r_tpu_torch import _native

assert _native.available()
arr = np.random.default_rng(1).random((5, 6, 7, 2)).astype(np.float32)
pads = ((1, 2), (2, 1), (1, 1))
np.testing.assert_array_equal(_native.reflect_pad_4d(arr, pads),
                              _native.reflect_pad_4d_numpy(arr, pads))
src = np.random.default_rng(2).random((9, 4)).astype(np.float32)
idx = np.random.default_rng(3).integers(0, 9, (5, 3))
w = np.full((5, 3), 1 / 3, np.float32)
np.testing.assert_allclose(_native.idw_apply(src, idx, w),
                           _native.idw_apply_numpy(src, idx, w), rtol=1e-6)
gids = np.arange(4)
np.testing.assert_allclose(
    _native.gather_scale_transpose(src, gids, 2.0),
    _native.gather_scale_transpose_numpy(src, gids, 2.0), rtol=1e-6)
print('NATIVE HELPERS 3')

import os
import tempfile

from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from sup3r_tpu_torch.preprocessing import LoaderNC
from sup3r_tpu_torch.utilities.test_helpers import make_fake_nc_file

tmp = tempfile.mkdtemp()
model.meta.update(lr_features=['u_100m', 'v_100m'],
                  hr_out_features=['u_100m', 'v_100m'])
model.set_norm_stats({{'u_100m': 0.5, 'v_100m': 0.5}},
                     {{'u_100m': 0.3, 'v_100m': 0.3}})
model.save(os.path.join(tmp, 'model'))
again = Sup3rGan.load(os.path.join(tmp, 'model'), device='cpu')
np.testing.assert_allclose(again.generate(lr.astype(np.float32)),
                           model.generate(lr.astype(np.float32)),
                           rtol=1e-6)
inp = make_fake_nc_file(os.path.join(tmp, 'in.nc'), (8, 8, 6),
                        ['u_100m', 'v_100m'])
strategy = ForwardPassStrategy(
    file_paths=inp, model_kwargs={{'model_dir': os.path.join(tmp, 'model'),
                                  'device': 'cpu'}},
    fwp_chunk_shape=(4, 4, 3), spatial_pad=1, temporal_pad=1,
    device_batch_size=2,
    out_pattern=os.path.join(tmp, 'out', 'chunk_{{file_id}}.nc'))
ForwardPass.run(strategy, 0)
files = sorted(os.listdir(os.path.join(tmp, 'out')))
assert len(files) == 8, files
data = LoaderNC(os.path.join(tmp, 'out', files[0])).data
assert data['u_100m'].shape == (12, 12, 12)
assert np.isfinite(data['u_100m']).all()
print('FORWARD PASS', len(files))

from sup3r_tpu_torch.configs import generator_cc_spatial
from sup3r_tpu_torch.models import LinearInterp, MultiStepGan
from sup3r_tpu_torch.utilities.test_helpers import make_fake_topo_nc_file

topo = make_fake_topo_nc_file(os.path.join(tmp, 'topo.nc'), (30, 30),
                              lat_range=(40.2, 38.8),
                              lon_range=(-105.7, -104.1))
feats = ['u_100m', 'v_100m']
spatial = Sup3rGan(generator_cc_spatial(2, 2, filters=8, n_resblocks=1),
                   [{{'class': 'Flatten'}}, {{'class': 'Dense', 'units': 1}}],
                   meta={{'lr_features': feats + ['topography'],
                         'hr_out_features': feats, 's_enhance': 2,
                         't_enhance': 1}},
                   means={{'u_100m': 0.5, 'v_100m': 0.5, 'topography': 500.0}},
                   stdevs={{'u_100m': 0.3, 'v_100m': 0.3,
                           'topography': 300.0}}, device='cpu')
spatial.init_weights((1, 4, 4, 3), (1, 8, 8, 2))
MultiStepGan([spatial, LinearInterp(feats, 1, 2, device='cpu')]).save(
    os.path.join(tmp, 'chain'))
strategy = ForwardPassStrategy(
    file_paths=inp, model_class='MultiStepGan',
    model_kwargs={{'model_dirs': [os.path.join(tmp, 'chain', f'model_step_{{i}}')
                                 for i in (0, 1)], 'device': 'cpu'}},
    fwp_chunk_shape=(4, 4, 3), spatial_pad=1, temporal_pad=1,
    exo_handler_kwargs={{'topography': {{'source_file': topo}}}},
    out_pattern=os.path.join(tmp, 'chain_out', 'chunk_{{file_id}}.nc'))
ForwardPass.run(strategy, 0)
files = sorted(f for f in os.listdir(os.path.join(tmp, 'chain_out'))
               if f.endswith('.nc'))
assert len(files) == 8, files
data = LoaderNC(os.path.join(tmp, 'chain_out', files[0])).data
assert data['u_100m'].shape == (8, 8, 6)
assert np.isfinite(data['u_100m']).all()
print('CHAIN WITH EXO', len(files))

from sup3r_tpu_torch.preprocessing import BatchHandler
from sup3r_tpu_torch.utilities.test_helpers import make_fake_dset

details = model.run_gradient_descent(
    lr.astype(np.float32), np.zeros((1, 12, 12, 12, 2), np.float32),
    train_gen=True, train_disc=True)
assert sorted(details) == ['loss_disc', 'loss_gen', 'loss_gen_advers',
                           'loss_gen_content'], details
handler = BatchHandler([make_fake_dset((12, 12, 24), ['u_100m', 'v_100m'])],
                       [make_fake_dset((12, 12, 12), ['u_100m', 'v_100m'])],
                       batch_size=1, n_batches=2, s_enhance=3, t_enhance=4,
                       sample_shape=(12, 12, 12))
model.train(handler, input_resolution={{'spatial': '30km',
                                        'temporal': '60min'}},
            n_epoch=1, out_dir=os.path.join(tmp, 'gan_{{epoch}}'))
again = Sup3rGan.load(os.path.join(tmp, 'gan_0'), device='cpu')
assert len(again.history) == 1 and 'val_loss_gen' in again.history
assert again._gen_opt_state['count'] == model._gen_opt_state['count']
print('TRAINED', len(model.history))

model.inference_mode = 'fast'
fast = model.generate(lr.astype(np.float32))
model.inference_mode = 'exact'
exact = model.generate(lr.astype(np.float32))
assert fast.dtype == np.float32 and fast.shape == exact.shape
assert np.abs(fast - exact).max() <= 0.04 * np.abs(exact).max()
print('FAST', fast.shape)

for dtype, remat in (('bfloat16', False), (None, True)):
    model.train_dtype, model.train_remat = dtype, remat
    details = model.run_gradient_descent(
        lr.astype(np.float32), np.zeros((1, 12, 12, 12, 2), np.float32),
        train_gen=True, train_disc=True)
    assert all(np.isfinite(v) for v in details.values()), details
model.train_dtype, model.train_remat = None, False
print('BF16 AND REMAT')

from sup3r_tpu_torch.preprocessing import DualBatchHandler, DualRasterizer

dual = DualRasterizer(
    (make_fake_dset((8, 8, 6), ['u_100m', 'v_100m'], freq='4h'),
     make_fake_dset((24, 24, 24), ['u_100m', 'v_100m'])),
    s_enhance=3, t_enhance=4)
handler = DualBatchHandler([dual], batch_size=1, n_batches=2, s_enhance=3,
                           t_enhance=4, sample_shape=(12, 12, 12))
model.train(handler, input_resolution={{'spatial': '30km',
                                        'temporal': '60min'}},
            n_epoch=1, out_dir=None)
assert len(model.history) == 2
print('DUAL TRAINED', len(model.history))

from sup3r_tpu_torch.configs import generator_cc_temporal
from sup3r_tpu_torch.models import SolarCC, SolarMultiStepGan
from sup3r_tpu_torch.preprocessing import BatchHandlerCC, DataHandlerH5SolarCC
from sup3r_tpu_torch.solar import Solar  # noqa: F401

disc = [{{'class': 'Flatten'}}, {{'class': 'Dense', 'units': 1}}]
solar = Sup3rGan(generator_cc_spatial(1, 2, filters=8, n_resblocks=1,
                                      with_topography=False), disc,
                 meta={{'lr_features': ['clearsky_ratio'],
                       'hr_out_features': ['clearsky_ratio'],
                       's_enhance': 2, 't_enhance': 1}},
                 means={{'clearsky_ratio': 0.5}},
                 stdevs={{'clearsky_ratio': 0.2}}, device='cpu')
solar.init_weights((1, 4, 4, 1), (1, 8, 8, 1))
solar.save(os.path.join(tmp, 'ssm'))
temporal = SolarCC(generator_cc_temporal(1, 8, 4, filters=8, n_resblocks=1,
                                         chan_per_step=8), disc,
                   meta={{'lr_features': ['clearsky_ratio'] + feats,
                         'hr_out_features': ['clearsky_ratio'],
                         's_enhance': 1, 't_enhance': 8}},
                   means={{'clearsky_ratio': 0.5, 'u_100m': 0.5,
                          'v_100m': 0.5}},
                   stdevs={{'clearsky_ratio': 0.2, 'u_100m': 0.3,
                           'v_100m': 0.3}}, device='cpu')
temporal.init_weights((1, 4, 4, 3, 3), (1, 4, 4, 24, 1))
temporal.save(os.path.join(tmp, 'tsm'))
daily = make_fake_nc_file(os.path.join(tmp, 'daily.nc'), (8, 8, 4),
                          ['clearsky_ratio', 'u_100m', 'v_100m'],
                          freq='D')
strategy = ForwardPassStrategy(
    file_paths=daily, model_class='SolarMultiStepGan',
    model_kwargs={{'spatial_solar_model_dirs': [os.path.join(tmp, 'ssm')],
                  'spatial_wind_model_dirs': [os.path.join(
                      tmp, 'chain', 'model_step_0')],
                  'temporal_solar_model_dirs': [os.path.join(tmp, 'tsm')],
                  't_enhance': 24, 'device': 'cpu'}},
    fwp_chunk_shape=(4, 4, 2), spatial_pad=1, temporal_pad=1,
    exo_handler_kwargs={{'topography': {{'source_file': topo}}}},
    out_pattern=os.path.join(tmp, 'solar_out', 'chunk_{{file_id}}.nc'))
ForwardPass.run(strategy, 0)
files = sorted(f for f in os.listdir(os.path.join(tmp, 'solar_out'))
               if f.endswith('.nc'))
assert len(files) == 8, files
data = LoaderNC(os.path.join(tmp, 'solar_out', files[0])).data
assert data['clearsky_ratio'].shape == (8, 8, 48)
assert np.isfinite(data['clearsky_ratio']).all()
print('SOLAR CHAIN', len(files))

rng = np.random.default_rng(0)
cs = 2 + 998 * rng.random((72, 6, 6))
nsrdb = make_fake_nc_file(os.path.join(tmp, 'nsrdb.nc'), (6, 6, 72),
                          ['ghi', 'clearsky_ghi'],
                          data={{'ghi': cs * rng.random(cs.shape),
                                'clearsky_ghi': cs}})
handler = DataHandlerH5SolarCC(nsrdb, features=['clearsky_ratio'])
batcher = BatchHandlerCC([handler], batch_size=1, n_batches=2, s_enhance=1,
                         t_enhance=8, sample_shape=(4, 4, 24))
cc = SolarCC(generator_cc_temporal(1, 8, 4, filters=8, n_resblocks=1,
                                   chan_per_step=8), disc, device='cpu')
cc.train(batcher, input_resolution={{'spatial': '4km',
                                     'temporal': '1440min'}},
         n_epoch=1, out_dir=None)
assert np.isfinite(cc.history['train_loss_gen']).all()
loaded = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
assert not loaded, loaded
print('SOLARCC TRAINED', len(cc.history))
'''


_SCRIPT_TRH_OBS_DC = _BLOCKER + f'''
import os
import tempfile

from sup3r_tpu_torch.configs import generator_cc_temporal
from sup3r_tpu_torch.models import (
    Sup3rGan,
    Sup3rGanDC,
    Sup3rGanWithObs,
    SurfaceSpatialMetModel,
)
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from sup3r_tpu_torch.preprocessing import BatchHandlerDC, LoaderNC
from sup3r_tpu_torch.utilities.test_helpers import (
    make_fake_dset,
    make_fake_nc_file,
    make_fake_topo_nc_file,
)

tmp = tempfile.mkdtemp()
trh = ['temperature_2m', 'relativehumidity_2m']
disc = [{{'class': 'Flatten'}}, {{'class': 'Dense', 'units': 1}}]
rng = np.random.default_rng(0)
data = {{'temperature_2m': 10 + 5 * rng.standard_normal((4, 8, 8)),
        'relativehumidity_2m': 50 + 10 * rng.standard_normal((4, 8, 8))}}
daily = make_fake_nc_file(os.path.join(tmp, 'trh.nc'), (8, 8, 4), trh,
                          freq='D', data=data)
topo = make_fake_topo_nc_file(os.path.join(tmp, 'topo.nc'), (30, 30),
                              lat_range=(40.2, 38.8),
                              lon_range=(-105.7, -104.1))
SurfaceSpatialMetModel(trh, 2, device='cpu').save(os.path.join(tmp, 'sfc'))
temporal = Sup3rGan(generator_cc_temporal(2, 24, 12, filters=8,
                                          n_resblocks=1, chan_per_step=4),
                    disc, meta={{'lr_features': trh, 'hr_out_features': trh,
                                's_enhance': 1, 't_enhance': 24}},
                    means={{'temperature_2m': 10.0,
                           'relativehumidity_2m': 50.0}},
                    stdevs={{'temperature_2m': 5.0,
                            'relativehumidity_2m': 10.0}}, device='cpu')
temporal.init_weights((1, 4, 4, 2, 2), (1, 4, 4, 48, 2))
temporal.save(os.path.join(tmp, 'trh_gan'))
strategy = ForwardPassStrategy(
    file_paths=daily, model_class='MultiStepSurfaceMetGan',
    model_kwargs={{'surface_model_kwargs': {{'model_dir': os.path.join(
        tmp, 'sfc')}}, 'temporal_model_kwargs': {{'model_dirs': [
            os.path.join(tmp, 'trh_gan')]}}, 'device': 'cpu'}},
    fwp_chunk_shape=(4, 4, 2), spatial_pad=1, temporal_pad=1,
    exo_handler_kwargs={{'topography': {{'source_file': topo}}}},
    out_pattern=os.path.join(tmp, 'trh_out', 'chunk_{{file_id}}.nc'))
ForwardPass.run(strategy, 0)
files = sorted(f for f in os.listdir(os.path.join(tmp, 'trh_out'))
               if f.endswith('.nc'))
assert len(files) == 8, files
data = LoaderNC(os.path.join(tmp, 'trh_out', files[0])).data
assert data['temperature_2m'].shape == (8, 8, 48)
assert np.isfinite(data['temperature_2m']).all()
print('TRH CHAIN', len(files))

uv = ['u_100m', 'v_100m']
gen = [{{'class': 'Conv2D', 'filters': 8, 'kernel_size': 3, 'strides': 1,
        'padding': 'same'}},
       {{'class': 'SpatialExpansion', 'spatial_mult': 2}},
       {{'class': 'LeakyReLU', 'alpha': 0.2}},
       {{'class': 'Sup3rConcatObs', 'name': 'u_100m_obs'}},
       {{'class': 'Sup3rObsModel', 'name': 'v_100m_obs', 'filters': 4}},
       {{'class': 'Dropout', 'rate': 0.1}},
       {{'class': 'Conv2D', 'filters': 2, 'kernel_size': 3, 'strides': 1,
        'padding': 'same'}}]
obs_gan = Sup3rGanWithObs(gen, disc, onshore_obs_frac={{'spatial_frac': 0.3}},
                          meta={{'lr_features': uv, 'hr_out_features': uv,
                                'input_resolution': {{'spatial': '12km',
                                                     'temporal': '60min'}},
                                's_enhance': 2, 't_enhance': 1}},
                          means={{f: 0.5 for f in uv}},
                          stdevs={{f: 0.3 for f in uv}}, device='cpu')
obs_gan.init_weights((1, 4, 4, 2), (1, 8, 8, 2))
details = obs_gan.run_gradient_descent(
    rng.random((2, 4, 4, 2)), rng.random((2, 8, 8, 2)), train_gen=True,
    train_disc=True)
assert 0 < details['obs_frac'] < 1 and np.isfinite(details['loss_obs'])
obs_gan.save(os.path.join(tmp, 'obs_gan'))
inp = make_fake_nc_file(os.path.join(tmp, 'uv.nc'), (8, 8, 3), uv)
obs = {{f: rng.random((3, 10, 10)) for f in uv}}
for f in uv:
    obs[f][rng.random((3, 10, 10)) > 0.2] = np.nan
stations = make_fake_nc_file(os.path.join(tmp, 'stations.nc'), (10, 10, 3),
                             uv, data=obs)
strategy = ForwardPassStrategy(
    file_paths=inp, model_class='Sup3rGanWithObs',
    model_kwargs={{'model_dir': os.path.join(tmp, 'obs_gan'),
                  'device': 'cpu'}},
    fwp_chunk_shape=(4, 4, 3), spatial_pad=1, temporal_pad=0,
    exo_handler_kwargs={{f'{{f}}_obs': {{'source_file': stations}}
                        for f in uv}}, out_pattern=None)
raster = strategy.exo_data['u_100m_obs']['steps'][0]['data']
assert np.isnan(raster).any() and np.isfinite(raster).any()
outs = ForwardPass.run(strategy, 0)
assert len(outs) == 4 and all(np.isfinite(o).all() for o in outs.values())
print('OBS FORWARD PASS', len(outs))

handler = BatchHandlerDC([make_fake_dset((16, 16, 24), uv)],
                         [make_fake_dset((16, 16, 24), uv)], batch_size=2,
                         n_batches=2, s_enhance=2, t_enhance=1,
                         sample_shape=(8, 8, 1), n_space_bins=2,
                         n_time_bins=2)
dc = Sup3rGanDC([{{'class': 'Conv2D', 'filters': 8, 'kernel_size': 3,
                  'strides': 1, 'padding': 'same'}},
                 {{'class': 'SpatialExpansion', 'spatial_mult': 2}},
                 {{'class': 'Conv2D', 'filters': 2, 'kernel_size': 3,
                  'strides': 1, 'padding': 'same'}}], disc, device='cpu')
dc.train(handler, input_resolution={{'spatial': '30km',
                                     'temporal': '60min'}},
         n_epoch=1, out_dir=None)
handler.stop()
assert abs(float(np.sum(handler.spatial_weights)) - 1) < 1e-5
loaded = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
assert not loaded, loaded
print('DC TRAINED', len(dc.history))
'''


_SCRIPT_COND_MOM = _BLOCKER.replace(
    f'BLOCKED = {BLOCKED!r}', f'BLOCKED = {BLOCKED + ("tensorboard",)!r}'
) + f'''
import glob
import os
import tempfile
import warnings

from sup3r_tpu_torch.models import Sup3rCondMom, Sup3rGan
from sup3r_tpu_torch.models.utilities import TrainingSession, profile_to_dir
from sup3r_tpu_torch.ops.coarsen import (
    spatial_simple_enhancing,
    temporal_simple_enhancing,
)
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from sup3r_tpu_torch.preprocessing import (
    BatchHandler,
    BatchHandlerMom1,
    BatchHandlerMom2,
)
from sup3r_tpu_torch.utilities.port import (
    export_reference_gan,
    load_reference_gan,
)
from sup3r_tpu_torch.utilities.test_helpers import (
    make_fake_dset,
    make_fake_nc_file,
)

tmp = tempfile.mkdtemp()
uv = ['u_100m', 'v_100m']
res = {{'spatial': '30km', 'temporal': '60min'}}
gen = [{{'class': 'Conv3D', 'filters': 8, 'kernel_size': 3, 'strides': 1,
        'padding': 'same'}},
       {{'class': 'SpatioTemporalExpansion', 'spatial_mult': 2,
        'temporal_mult': 2, 'temporal_method': 'nearest'}},
       {{'class': 'Conv3D', 'filters': 2, 'kernel_size': 3, 'strides': 1,
        'padding': 'same'}}]
x = np.random.default_rng(0).random((1, 4, 4, 3, 2))
assert temporal_simple_enhancing(spatial_simple_enhancing(x, 2), 2,
                                 'linear').shape == (1, 8, 8, 6, 2)

def handler(cls, **kwargs):
    return cls([make_fake_dset((16, 16, 24), uv)],
               [make_fake_dset((16, 16, 24), uv)], batch_size=2, n_batches=2,
               s_enhance=2, t_enhance=2, sample_shape=(8, 8, 4), **kwargs)

mom1 = Sup3rCondMom(gen, device='cpu')
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter('always')
    TrainingSession(handler(BatchHandlerMom1, s_padding=1), mom1,
                    input_resolution=res, n_epoch=1,
                    out_dir=os.path.join(tmp, 'mom1_{{epoch}}'),
                    tensorboard_log=True).run()
assert any('tensorboard' in str(w.message) for w in caught)
assert not os.path.exists(os.path.join(tmp, 'logs'))
print('MOM1 TRAINED', len(mom1.history))
mom2 = Sup3rCondMom(gen, device='cpu')
mom2.train(handler(BatchHandlerMom2, lower_models={{1: mom1}}),
           input_resolution=res, n_epoch=1, out_dir=None)
assert np.isfinite(mom2.history['val_loss_gen']).all()
print('MOM2 TRAINED', len(mom2.history))

inp = make_fake_nc_file(os.path.join(tmp, 'in.nc'), (8, 8, 6), uv)
strategy = ForwardPassStrategy(
    file_paths=inp, model_class='Sup3rCondMom',
    model_kwargs={{'model_dir': os.path.join(tmp, 'mom1_0'),
                  'device': 'cpu'}},
    fwp_chunk_shape=(4, 4, 3), spatial_pad=1, temporal_pad=1,
    out_pattern=None)
outs = ForwardPass.run(strategy, 0)
assert len(outs) == 8 and all(np.isfinite(o).all() for o in outs.values())
print('COND MOM FORWARD PASS', len(outs))

gan = Sup3rGan(gen, [{{'class': 'Flatten'}}, {{'class': 'Dense', 'units': 1}}],
               device='cpu')
gan.train(handler(BatchHandler), input_resolution=res, n_epoch=1,
          out_dir=os.path.join(tmp, 'gan', 'gan_{{epoch}}'),
          tensorboard_profile=True)
traces = glob.glob(os.path.join(tmp, 'gan', 'profile', '*.pt.trace.json'))
assert len(traces) == 1, traces
print('PROFILED', len(traces))
export_reference_gan(gan, os.path.join(tmp, 'ref'))
again = load_reference_gan(os.path.join(tmp, 'ref'),
                           lr_shape=(1, 4, 4, 2, 2), device='cpu')
lr = np.random.default_rng(1).random((1, 4, 4, 3, 2)).astype(np.float32)
np.testing.assert_allclose(again.generate(lr), gan.generate(lr), rtol=1e-6)
loaded = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
assert not loaded, loaded
print('REFERENCE IMPORT')
'''

_SCRIPT_LAZY = _BLOCKER + f'''
import os
import tempfile

from sup3r_tpu_torch.configs import generator_st
from sup3r_tpu_torch.models import Sup3rGan
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from sup3r_tpu_torch.preprocessing import (
    BatchHandler,
    DataHandler,
    DataHandlerNCforCC,
    DataHandlerNCforCCwithPowerLaw,
    LazyGridDataset,
)
from sup3r_tpu_torch.preprocessing.lazy import LazyDailyDataset
from sup3r_tpu_torch.utilities.test_helpers import make_fake_nc_file

tmp = tempfile.mkdtemp()
feats = ['u_100m', 'v_100m']
model = Sup3rGan(generator_st(2, (3,), (2, 2), filters=8, n_resblocks=1),
                 [{{'class': 'Flatten'}}, {{'class': 'Dense', 'units': 1}}],
                 meta={{'lr_features': feats, 'hr_out_features': feats}},
                 means={{'u_100m': 0.5, 'v_100m': 0.5}},
                 stdevs={{'u_100m': 0.3, 'v_100m': 0.3}}, device='cpu')
model.save(os.path.join(tmp, 'model'))
inp = make_fake_nc_file(os.path.join(tmp, 'in.nc'), (8, 8, 6), feats)
kw = dict(model_kwargs={{'model_dir': os.path.join(tmp, 'model'),
                        'device': 'cpu'}},
          fwp_chunk_shape=(4, 4, 3), spatial_pad=1, temporal_pad=1,
          device_batch_size=2, out_pattern=None)
eager = ForwardPass.run(ForwardPassStrategy(file_paths=inp, **kw), 0)
lazy = ForwardPass.run(ForwardPassStrategy(file_paths=inp, chunked_io=True,
                                           **kw), 0)
assert sorted(eager) == sorted(lazy) and len(lazy) == 8
for key in eager:
    np.testing.assert_array_equal(lazy[key], eager[key])
print('CHUNKED IO', len(lazy))

gcm = make_fake_nc_file(os.path.join(tmp, 'gcm.nc'), (8, 8, 6),
                        ['uas', 'vas'])
handler = DataHandlerNCforCCwithPowerLaw(gcm, features=feats, mode='lazy')
assert isinstance(handler.data, LazyGridDataset)
gcm_out = ForwardPass.run(ForwardPassStrategy(
    file_paths=gcm, chunked_io=True,
    input_handler_name='DataHandlerNCforCCwithPowerLaw', **kw), 0)
assert len(gcm_out) == 8
assert all(np.isfinite(v).all() for v in gcm_out.values())
assert issubclass(DataHandlerNCforCCwithPowerLaw, DataHandlerNCforCC)
print('GCM CHUNKED IO', len(gcm_out))

train = DataHandler(make_fake_nc_file(os.path.join(tmp, 'train.nc'),
                                      (12, 12, 24), feats),
                    features=feats, mode='lazy')
bh = BatchHandler([train], [], batch_size=1, n_batches=2, s_enhance=3,
                  t_enhance=4, sample_shape=(12, 12, 12), mode='lazy')
model.train(bh, input_resolution={{'spatial': '30km', 'temporal': '60min'}},
            n_epoch=1, out_dir=os.path.join(tmp, 'lazy_{{epoch}}'))
assert len(model.history) == 1
assert LazyDailyDataset.__module__ == 'sup3r_tpu_torch.preprocessing.lazy'
loaded = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
assert not loaded, loaded
print('LAZY TRAINED', len(model.history))
'''

_SCRIPT_BIAS = _BLOCKER + f'''
import os
import tempfile

from sup3r_tpu_torch.bias import QuantileDeltaMappingCorrection, qdm_bc
from sup3r_tpu_torch.configs import generator_st
from sup3r_tpu_torch.models import Sup3rGan
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from sup3r_tpu_torch.preprocessing import DataHandler
from sup3r_tpu_torch.utilities.test_helpers import (
    make_fake_nc_file,
    write_nc_factor_file,
)

tmp = tempfile.mkdtemp()
feats = ['u_100m', 'v_100m']
rng = np.random.default_rng(0)
base = make_fake_nc_file(os.path.join(tmp, 'base.nc'), (16, 16, 730),
                         ['u_100m'], freq='D', data={{'u_100m': rng.normal(
                             0.5, 0.2, (730, 16, 16))}})
hist, fut = [make_fake_nc_file(
    os.path.join(tmp, f'{{name}}.nc'), (8, 8, 730), ['u_100m'], freq='D',
    data={{'u_100m': rng.normal(0.6, 0.25, (730, 8, 8))}})
    for name in ('hist', 'fut')]
calc = QuantileDeltaMappingCorrection(
    base, hist, fut, 'u_100m', 'u_100m', base_handler='LoaderNC',
    n_quantiles=11, n_time_steps=4, device='cpu')
out = calc.run()
dev = calc.run(use_device=True)
for key in out:
    assert np.isfinite(out[key]).all(), key
    np.testing.assert_allclose(dev[key], out[key], rtol=2e-4, atol=2e-2)
fp = write_nc_factor_file(os.path.join(tmp, 'qdm.nc'), calc.bias_dh.lat_lon,
                          out, calc.factor_cfg())
print('QDM CALIBRATED', sorted(out))

model = Sup3rGan(generator_st(2, (3,), (2, 2), filters=8, n_resblocks=1),
                 [{{'class': 'Flatten'}}, {{'class': 'Dense', 'units': 1}}],
                 meta={{'lr_features': feats, 'hr_out_features': feats}},
                 means={{'u_100m': 0.5, 'v_100m': 0.5}},
                 stdevs={{'u_100m': 0.3, 'v_100m': 0.3}}, device='cpu')
model.save(os.path.join(tmp, 'model'))
inp = make_fake_nc_file(os.path.join(tmp, 'in.nc'), (8, 8, 6), feats)
kw = dict(model_kwargs={{'model_dir': os.path.join(tmp, 'model'),
                        'device': 'cpu'}},
          fwp_chunk_shape=(4, 4, 3), spatial_pad=1, temporal_pad=1,
          device_batch_size=2, out_pattern=None, file_paths=inp)
bc = dict(bias_correct_method='local_qdm_bc', bias_correct_kwargs={{
    'u_100m': {{'bias_fp': fp, 'base_dset': 'u_100m', 'relative': False}}}})
raw = ForwardPass.run(ForwardPassStrategy(**kw), 0)
eager = ForwardPass.run(ForwardPassStrategy(**kw, **bc), 0)
streamed = ForwardPass.run(ForwardPassStrategy(chunked_io=True, **kw, **bc),
                           0)
assert sorted(eager) == sorted(streamed) == sorted(raw) and len(eager) == 8
for key in eager:
    np.testing.assert_array_equal(streamed[key], eager[key])
    assert not np.allclose(eager[key], raw[key])
print('CORRECTED FORWARD PASS', len(eager))

handler = DataHandler(inp, features=feats)
before = np.array(handler.data['u_100m'])
assert qdm_bc(handler, fp, 'u_100m', relative=False) == ['u_100m']
assert not np.allclose(handler.data['u_100m'], before)
loaded = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
assert not loaded, loaded
print('QDM_BC', handler.data['u_100m'].shape)
'''


_RANK_MESH = _BLOCKER + f'''
import os

from sup3r_tpu_torch.models import Sup3rGan
from sup3r_tpu_torch.parallel import get_mesh, get_mesh_2d, shard_batch_spatial
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from sup3r_tpu_torch.utilities.test_helpers import run_rank_scenarios


def step(rank, world, out):
    model = Sup3rGan.load(os.path.join(out, 'model'), device='cpu')
    model.attach_mesh(get_mesh(devices='cpu'))
    rng = np.random.default_rng(0)
    lr = rng.random((4, 4, 4, 3, 2)).astype(np.float32)
    hr = rng.random((4, 12, 12, 12, 2)).astype(np.float32)
    return model.run_gradient_descent(lr[2 * rank:2 * rank + 2],
                                      hr[2 * rank:2 * rank + 2],
                                      train_gen=True, train_disc=True)


def step_2d(rank, world, out):
    model = Sup3rGan.load(os.path.join(out, 'model'), device='cpu')
    mesh = get_mesh_2d(1, 2, devices='cpu')
    model.attach_mesh(mesh)
    rng = np.random.default_rng(0)
    lr = rng.random((4, 4, 4, 3, 2)).astype(np.float32)
    hr = rng.random((4, 12, 12, 12, 2)).astype(np.float32)
    return model.run_gradient_descent(*shard_batch_spatial(mesh, lr, hr),
                                      train_gen=True, train_disc=True)


def spatial(rank, world, out):
    strategy = ForwardPassStrategy(
        file_paths=os.path.join(out, 'in.nc'),
        model_kwargs={{'model_dir': os.path.join(out, 'model'),
                      'device': 'cpu'}},
        fwp_chunk_shape=(4, 4, 3), spatial_pad=1, temporal_pad=1,
        device_batch_size=2, use_mesh='spatial', out_pattern=None)
    out = ForwardPass.run(strategy, 0)
    loaded = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
    return out, loaded


run_rank_scenarios({{'step': step, 'step_2d': step_2d,
                    'spatial': spatial}}, *sys.argv[1:])
'''

_SCRIPT_MESH = _BLOCKER + f'''
import os
import tempfile

from sup3r_tpu_torch.configs import generator_st
from sup3r_tpu_torch.models import Sup3rGan
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from sup3r_tpu_torch.utilities.test_helpers import (
    make_fake_nc_file,
    rank_results,
    spawn_ranks,
)

tmp = tempfile.mkdtemp()
feats = ['u_100m', 'v_100m']
model = Sup3rGan(generator_st(2, (3,), (2, 2), filters=8, n_resblocks=1),
                 [{{'class': 'Flatten'}}, {{'class': 'Dense', 'units': 1}}],
                 meta={{'lr_features': feats, 'hr_out_features': feats}},
                 means={{f: 0.5 for f in feats}},
                 stdevs={{f: 0.3 for f in feats}}, device='cpu')
model.init_weights((1, 4, 4, 3, 2), (1, 12, 12, 12, 2), seed=0)
model.save(os.path.join(tmp, 'model'))
inp = make_fake_nc_file(os.path.join(tmp, 'in.nc'), (8, 8, 6), feats)
with open(os.path.join(tmp, 'rank.py'), 'w') as f:
    f.write({_RANK_MESH!r})
spawn_ranks([sys.executable, os.path.join(tmp, 'rank.py'), tmp], 2, tmp,
            timeout=240)
ranks = rank_results(tmp, 2)
for res in ranks:
    for name in ('step', 'step_2d', 'spatial'):
        assert 'error' not in res[name], res[name]
steps = [res['step'] for res in ranks]
assert steps[0] == steps[1] and np.isfinite(list(steps[0].values())).all()
print('MESH DP STEP', len(steps))
steps_2d = [res['step_2d'] for res in ranks]
rng = np.random.default_rng(0)
one = Sup3rGan.load(os.path.join(tmp, 'model'), device='cpu')
want = one.run_gradient_descent(
    rng.random((4, 4, 4, 3, 2)).astype(np.float32),
    rng.random((4, 12, 12, 12, 2)).astype(np.float32), train_gen=True,
    train_disc=True)
assert steps_2d[0] == steps_2d[1]
for key, value in want.items():
    np.testing.assert_allclose(steps_2d[0][key], value, rtol=2e-4, atol=1e-6)
print('MESH DPxSP STEP', len(steps_2d))
serial = ForwardPass.run(ForwardPassStrategy(
    file_paths=inp, model_kwargs={{'model_dir': os.path.join(tmp, 'model'),
                                  'device': 'cpu'}},
    fwp_chunk_shape=(4, 4, 3), spatial_pad=1, temporal_pad=1,
    out_pattern=None), 0)
for res in ranks:
    out, blocked = res['spatial']
    assert not blocked, blocked
    assert sorted(out) == sorted(serial) and len(out) == 8
    for key in serial:
        np.testing.assert_allclose(out[key], serial[key], rtol=0, atol=1e-4)
loaded = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
assert not loaded, loaded
print('MESH SPATIAL PASS', len(serial))
'''


_SCRIPT_SURFACE = _BLOCKER + f'''
import importlib
import os
import tempfile

for name in ('preprocessing.grid', 'preprocessing.data_handlers',
             'ops.interp', 'models.abstract', 'models.gan',
             'models.network', 'models.weights', 'models.fuse',
             'pipeline.strategy', 'pipeline.forward_pass',
             'utilities.test_helpers'):
    importlib.import_module(f'sup3r_tpu_torch.{{name}}')

from sup3r_tpu_torch.models import Network, Sup3rGan
from sup3r_tpu_torch.models.abstract import AbstractSingleModel
from sup3r_tpu_torch.ops.interp import bilinear_resize
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from sup3r_tpu_torch.utilities import test_helpers

dual = test_helpers.make_fake_dual((4, 4, 3), 2, 2, ['u_100m', 'v_100m'],
                                   with_obs=True)
hr = dual.high_res
flat, coords = hr.flatten()
back = type(hr).unflatten(flat, hr.grid_shape, hr.features, lat_lon=coords)
np.testing.assert_array_equal(back.data, hr.data)
assert hr.compute() is hr and hr.dims[-1] == 'variable'
assert set(dual.obs.qa()) == {{'u_100m_obs', 'v_100m_obs'}}
assert bilinear_resize(hr.data, 4, 12).shape == (4, 12, 6, 2)
tmp = tempfile.mkdtemp()
try:
    test_helpers.make_fake_h5_file(os.path.join(tmp, 'x.h5'), (2, 2, 2),
                                   ['u_100m'])
except ModuleNotFoundError as e:
    assert 'h5py' in str(e)
else:
    raise AssertionError('make_fake_h5_file ran with h5py blocked')
print('DATA NAMES')

model = Sup3rGan([{{'class': 'Conv2D', 'filters': 8, 'kernel_size': 3,
                   'strides': 1, 'padding': 'same'}},
                  {{'class': 'SkipConnection', 'name': 'a'}},
                  {{'class': 'Conv2D', 'filters': 8, 'kernel_size': 3,
                   'strides': 1, 'padding': 'same'}},
                  {{'class': 'SkipConnection', 'name': 'a'}},
                  {{'class': 'SpatialExpansion', 'spatial_mult': 2}}],
                 [{{'class': 'Flatten'}}, {{'class': 'Dense', 'units': 1}}],
                 device='cpu')
model.init_weights((1, 4, 4, 2), (1, 8, 8, 2))
assert len(model.weights['generator']) == len(model.generator_weights)
fp = os.path.join(tmp, 'gen.msgpack')
AbstractSingleModel.save_network_params(model.generator, fp)
loaded = AbstractSingleModel.load_network_params(model.generator, fp)
assert len(loaded) == len(model.generator.layers)
prefix = Network(list(model.generator.layers)[:3])
x = torch.zeros((1, 4, 4, 2))
assert prefix.apply(x, allow_pending_skips=True).shape == (1, 4, 4, 8)
cast = Network.dtype_cast(model.generator_weights, 'bfloat16')
assert all(t.dtype == torch.bfloat16 for t in cast)
print('MODEL NAMES')

model = Sup3rGan([{{'class': 'Conv3D', 'filters': 2, 'kernel_size': 3,
                   'strides': 1, 'padding': 'same'}}],
                 [{{'class': 'Flatten'}}, {{'class': 'Dense', 'units': 1}}],
                 meta={{'lr_features': ['u_100m', 'v_100m'],
                       'hr_out_features': ['u_100m', 'v_100m']}},
                 means={{'u_100m': 0.5, 'v_100m': 0.5}},
                 stdevs={{'u_100m': 0.3, 'v_100m': 0.3}}, device='cpu')
model.init_weights((1, 4, 4, 3, 2), (1, 4, 4, 3, 2))
model.save(os.path.join(tmp, 'model'))
inp = test_helpers.make_fake_nc_file(os.path.join(tmp, 'in.nc'), (8, 8, 6),
                                     ['u_100m', 'v_100m'])
outs = {{}}
os.environ['SUP3R_TPU_HBM_GB'] = '0.000001'
for batch, use_mesh in (('auto', False), (1, 1), (1, False)):
    strategy = ForwardPassStrategy(
        file_paths=inp, model_kwargs={{'model_dir': os.path.join(
            tmp, 'model'), 'device': 'cpu'}}, fwp_chunk_shape=(4, 4, 3),
        spatial_pad=1, temporal_pad=1, device_batch_size=batch,
        use_mesh=use_mesh, out_pattern=None)
    outs[(batch, use_mesh)] = ForwardPass.run(strategy, 0)
    if batch == 'auto':
        assert (strategy.device_batch_size, strategy.use_mesh) == (
            1, 'spatial')
for key in outs:
    for idx, want in outs[(1, False)].items():
        np.testing.assert_allclose(outs[key][idx], want, atol=1e-5)
loaded = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
assert not loaded, loaded
print('AUTO AND TRUTHY MESH', len(outs[(1, False)]))
'''


def _run_blocked(script):
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [ROOT] + [p for p in env.get('PYTHONPATH', '').split(os.pathsep)
                  if p])
    return subprocess.run([sys.executable, '-c', script], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


_SITECUSTOMIZE = f'''
import atexit
import importlib.abc
import os
import sys

BLOCKED = {BLOCKED + ('click',)!r}


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ModuleNotFoundError(f'{{name}} is blocked')
        return None


sys.meta_path.insert(0, Blocker())


@atexit.register
def _report():
    loaded = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
    with open(os.path.join(os.environ['BLOCKED_REPORT_DIR'],
                           f'{{os.getpid()}}.json'), 'w') as f:
        f.write(repr(loaded))
'''


def test_cli_pipeline_runs_with_jax_click_and_friends_blocked(tmp_path):
    """The port's command line runs a forward-pass (two nodes), a NetCDF
    collection and a QA from a directory outside the repo, with jax,
    pandas, h5py, click and the JAX package blocked by a
    ``sitecustomize`` that is the only entry of ``PYTHONPATH``: the
    node processes find the port by themselves."""
    from sup3r_tpu_torch.utilities.test_helpers import make_fake_nc_file

    block_dir, report_dir, run_dir = (tmp_path / d for d in (
        'block', 'report', 'run'))
    for d in (block_dir, report_dir, run_dir):
        d.mkdir()
    (block_dir / 'sitecustomize.py').write_text(_SITECUSTOMIZE)
    feats = ['u_100m', 'v_100m']
    model = Sup3rGan(generator_st(2, (3,), (2, 2), filters=8, n_resblocks=1),
                     [{'class': 'Flatten'}, {'class': 'Dense', 'units': 1}],
                     meta={'lr_features': feats, 'hr_out_features': feats},
                     means={f: 0.5 for f in feats},
                     stdevs={f: 0.3 for f in feats}, device='cpu')
    model.save(str(run_dir / 'model'))
    inp = make_fake_nc_file(str(run_dir / 'in.nc'), (8, 8, 6), feats)
    cfgs = {
        'config_fwp.json': {
            'file_paths': inp, 'fwp_chunk_shape': [4, 4, 3],
            'model_kwargs': {'model_dir': str(run_dir / 'model'),
                             'device': 'cpu'},
            'spatial_pad': 1, 'temporal_pad': 1, 'max_nodes': 2,
            'device_batch_size': 2,
            'out_pattern': './out/chunk_{file_id}.nc',
            'execution_control': {'option': 'local'}},
        'config_collect.json': {'file_paths': './out/chunk_*.nc',
                                'out_file': './collected.nc'},
        'config_qa.json': {'source_file_paths': inp,
                           'out_file_path': './collected.nc',
                           's_enhance': 3, 't_enhance': 4,
                           'features': feats, 'device': 'cpu'},
        'config_pipeline.json': {'pipeline': [
            {'forward-pass': 'config_fwp.json'},
            {'data-collect': 'config_collect.json'},
            {'qa': 'config_qa.json'}]}}
    for name, cfg in cfgs.items():
        (run_dir / name).write_text(json.dumps(cfg))
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env.update(PYTHONPATH=str(block_dir), OMP_NUM_THREADS='1',
               BLOCKED_REPORT_DIR=str(report_dir))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, 'sup3r_tpu_torch', 'cli.py'),
         '-c', 'config_pipeline.json', 'pipeline', '--monitor'],
        cwd=str(run_dir), env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    status = json.loads((run_dir / '.status.json').read_text())
    jobs = [j for k, v in status.items() if not k.startswith('__')
            for j in v.values()]
    assert len(jobs) == 4
    assert all(j['job_status'] == 'successful' for j in jobs)
    assert len(os.listdir(run_dir / 'out')) == 8
    from sup3r_tpu_torch.preprocessing import LoaderNC

    data = LoaderNC(str(run_dir / 'collected.nc')).data
    assert data.shape == (24, 24, 24, 2)
    assert np.isfinite(data['u_100m']).all()
    reports = sorted(report_dir.iterdir())
    # the parent and its four nodes each loaded the blocker, and none
    # of them imported a blocked module
    assert len(reports) == 5, reports
    assert all(r.read_text() == '[]' for r in reports)


def test_rank_group_node_runs_with_jax_click_and_friends_blocked(tmp_path):
    """A forward-pass node run as a group of two gloo ranks
    (``ranks_per_node``, ``use_mesh=True``) from a directory outside the
    repo, with the same ``sitecustomize`` blocker as the only entry of
    ``PYTHONPATH``: the command, the group's launcher and both ranks load
    the blocker and import no blocked module, and the ranks pad their
    chunks with the native helpers."""
    from sup3r_tpu_torch.utilities.test_helpers import make_fake_nc_file

    block_dir, report_dir, run_dir = (tmp_path / d for d in (
        'block', 'report', 'run'))
    for d in (block_dir, report_dir, run_dir):
        d.mkdir()
    (block_dir / 'sitecustomize.py').write_text(_SITECUSTOMIZE)
    feats = ['u_100m', 'v_100m']
    model = Sup3rGan(generator_st(2, (3,), (2, 2), filters=8, n_resblocks=1),
                     [{'class': 'Flatten'}, {'class': 'Dense', 'units': 1}],
                     meta={'lr_features': feats, 'hr_out_features': feats},
                     means={f: 0.5 for f in feats},
                     stdevs={f: 0.3 for f in feats}, device='cpu')
    model.save(str(run_dir / 'model'))
    inp = make_fake_nc_file(str(run_dir / 'in.nc'), (8, 8, 6), feats)
    (run_dir / 'config_fwp.json').write_text(json.dumps({
        'file_paths': inp, 'fwp_chunk_shape': [4, 4, 3],
        'model_kwargs': {'model_dir': str(run_dir / 'model'),
                         'device': 'cpu'},
        'spatial_pad': 1, 'temporal_pad': 1, 'device_batch_size': 2,
        'use_mesh': True, 'out_pattern': './out/chunk_{file_id}.nc',
        'log_file': './logs/fwp_{node_index}.log',
        'execution_control': {'option': 'local', 'ranks_per_node': 2}}))
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env.update(PYTHONPATH=str(block_dir), OMP_NUM_THREADS='1',
               BLOCKED_REPORT_DIR=str(report_dir))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, 'sup3r_tpu_torch', 'cli.py'),
         '-c', 'config_fwp.json', 'forward-pass'],
        cwd=str(run_dir), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert len(os.listdir(run_dir / 'out')) == 8
    for r in range(2):
        text = (run_dir / 'logs' / f'fwp_0_rank{r}.log').read_text()
        assert 'Node summary' in text
    reports = sorted(report_dir.iterdir())
    # the command, the launcher and its two ranks
    assert len(reports) == 4, reports
    assert all(r.read_text() == '[]' for r in reports)


def test_trh_chain_obs_and_dc_run_with_jax_and_friends_blocked():
    proc = _run_blocked(_SCRIPT_TRH_OBS_DC)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'TRH CHAIN 8' in proc.stdout
    assert 'OBS FORWARD PASS 4' in proc.stdout
    assert 'DC TRAINED 1' in proc.stdout


def test_cond_mom_training_and_import_with_jax_and_friends_blocked():
    proc = _run_blocked(_SCRIPT_COND_MOM)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'MOM1 TRAINED 1' in proc.stdout
    assert 'MOM2 TRAINED 1' in proc.stdout
    assert 'COND MOM FORWARD PASS 8' in proc.stdout
    assert 'PROFILED 1' in proc.stdout
    assert 'REFERENCE IMPORT' in proc.stdout


def test_port_serves_with_jax_and_friends_blocked():
    proc = _run_blocked(_SCRIPT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'SERVED (1, 12, 12, 12, 2)' in proc.stdout
    assert 'NATIVE HELPERS 3' in proc.stdout
    assert 'FORWARD PASS 8' in proc.stdout
    assert 'CHAIN WITH EXO 8' in proc.stdout
    assert 'TRAINED 1' in proc.stdout
    assert 'FAST (1, 12, 12, 12, 2)' in proc.stdout
    assert 'BF16 AND REMAT' in proc.stdout
    assert 'DUAL TRAINED 2' in proc.stdout
    assert 'SOLAR CHAIN 8' in proc.stdout
    assert 'SOLARCC TRAINED 1' in proc.stdout


def test_streaming_slice_runs_with_jax_and_friends_blocked():
    """``preprocessing/lazy.py``, the GCM handlers and the chunked_io
    strategy import and run with jax, pandas and h5py blocked: a
    chunked_io pass equal to the eager one, a chunked_io pass of the
    power-law GCM handler over NetCDF3 uas / vas, and a lazy-fed epoch."""
    proc = _run_blocked(_SCRIPT_LAZY)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'CHUNKED IO 8' in proc.stdout
    assert 'GCM CHUNKED IO 8' in proc.stdout
    assert 'LAZY TRAINED 1' in proc.stdout


def test_bias_slice_runs_with_jax_and_friends_blocked():
    """``bias/`` imports and runs with jax, pandas, h5py and PIL blocked:
    a QDM calibration from NetCDF3 files on the CPU (host and torch
    paths), its NetCDF3 factor file, a corrected forward pass (eager and
    chunked_io equal) and ``qdm_bc``."""
    proc = _run_blocked(_SCRIPT_BIAS)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'QDM CALIBRATED' in proc.stdout
    assert 'CORRECTED FORWARD PASS 8' in proc.stdout
    assert 'QDM_BC (8, 8, 6)' in proc.stdout


def test_mesh_slice_runs_with_jax_and_friends_blocked():
    """``parallel/`` imports and runs with jax, pandas, h5py and PIL
    blocked, in the parent and in two spawned gloo ranks: a
    data-parallel step (the same finite losses on both ranks), a 1 x 2
    dp x sp step (the single-process step's losses) and a
    ``use_mesh='spatial'`` pass equal to the single-process pass."""
    proc = _run_blocked(_SCRIPT_MESH)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'MESH DP STEP 2' in proc.stdout
    assert 'MESH DPxSP STEP 2' in proc.stdout
    assert 'MESH SPATIAL PASS 8' in proc.stdout


def test_last_slice_names_run_with_jax_and_friends_blocked():
    """The modules the last slice of the port changed import and run with
    jax, pandas, h5py and PIL blocked: ``GridDataset.qa`` / ``flatten``
    / ``unflatten``, ``bilinear_resize``, ``make_fake_dual`` (the H5
    helper raises for want of h5py), the weights properties,
    ``save_network_params`` / ``load_network_params``, a prefix run with
    ``allow_pending_skips``, ``dtype_cast``, and the world-of-one 'auto'
    fallback and ``use_mesh=1`` passes equal to the plain pass."""
    proc = _run_blocked(_SCRIPT_SURFACE)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'DATA NAMES' in proc.stdout
    assert 'MODEL NAMES' in proc.stdout
    assert 'AUTO AND TRUTHY MESH 8' in proc.stdout


def test_no_card_without_explicit_cpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    gen = generator_st(2, (3,), (2, 2), filters=8, n_resblocks=1)
    disc = [{'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Sup3rGan(gen, disc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Sup3rGan(gen, disc, device='cuda:0')
    assert Sup3rGan(gen, disc, device='cpu').device.type == 'cpu'
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SolarCC(gen, disc)
