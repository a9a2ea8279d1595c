"""The port stands alone: ``sup3r_tpu_torch`` imports and serves with
jax, jaxlib, flax, optax, the JAX package, pandas, h5py and msgpack all
unimportable — as on the card's machine — and it never drops quietly to
the CPU. The blocked run also saves a model, reloads it, runs the
chunked ForwardPass from a NetCDF3 input to NetCDF output, takes one
train step and trains one BatchHandler epoch (history, checkpoint with
optimizer state, reload)."""

import os
import subprocess
import sys

import pytest
import torch

from sup3r_tpu_torch.configs import generator_st
from sup3r_tpu_torch.models import Sup3rGan

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'sup3r_tpu', 'pandas', 'h5py',
           'msgpack')

_SCRIPT = f'''
import importlib.abc
import sys

BLOCKED = {BLOCKED!r}


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ModuleNotFoundError(f'{{name}} is blocked')
        return None


sys.meta_path.insert(0, Blocker())

import numpy as np
import torch

torch.set_num_threads(1)
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
loaded = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
assert not loaded, loaded
print('TRAINED', len(model.history))
'''


def test_port_serves_with_jax_and_friends_blocked():
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [ROOT] + [p for p in env.get('PYTHONPATH', '').split(os.pathsep)
                  if p])
    proc = subprocess.run([sys.executable, '-c', _SCRIPT], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'SERVED (1, 12, 12, 12, 2)' in proc.stdout
    assert 'FORWARD PASS 8' in proc.stdout
    assert 'TRAINED 1' in proc.stdout


def test_no_card_without_explicit_cpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    gen = generator_st(2, (3,), (2, 2), filters=8, n_resblocks=1)
    disc = [{'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Sup3rGan(gen, disc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Sup3rGan(gen, disc, device='cuda:0')
    assert Sup3rGan(gen, disc, device='cpu').device.type == 'cpu'
