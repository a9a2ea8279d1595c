"""``TrainingSession``, the tensorboard writer and ``profile_to_dir`` of
``sup3r_tpu_torch.models.utilities``, as
tests/utilities/test_misc_components.py checks the JAX package's: a
session trains to completion and passes a training error up, a profiled
block writes a trace, ``Sup3rGan.train`` (and the subclasses that
inherit it: ``SolarCC``, ``Sup3rGanWithObs``, ``Sup3rGanDC``) writes
event files and the first epoch's trace, ``Sup3rCondMom.train`` writes
event files, and without ``tensorboard`` training warns and completes."""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from sup3r_tpu_torch.configs import generator_cc_temporal
from sup3r_tpu_torch.models import (
    SolarCC,
    Sup3rCondMom,
    Sup3rGan,
    Sup3rGanDC,
    Sup3rGanWithObs,
)
from sup3r_tpu_torch.models.utilities import (
    TrainingSession,
    make_tb_writer,
    profile_to_dir,
    tb_log_dict,
)
from sup3r_tpu_torch.preprocessing import (
    BatchHandler,
    BatchHandlerCC,
    BatchHandlerDC,
    BatchHandlerMom1,
    DataHandlerH5SolarCC,
)
from sup3r_tpu_torch.utilities.test_helpers import (
    make_fake_dset,
    make_fake_nc_file,
)

torch.set_num_threads(1)

FEATURES = ['u_100m', 'v_100m']
RES = {'spatial': '30km', 'temporal': '60min'}
GEN = [{'class': 'Conv2D', 'filters': 8, 'kernel_size': 3, 'strides': 1,
        'padding': 'same'},
       {'class': 'SpatialExpansion', 'spatial_mult': 2},
       {'class': 'Conv2D', 'filters': 2, 'kernel_size': 3, 'strides': 1,
        'padding': 'same'}]
DISC = [{'class': 'Conv2D', 'filters': 4, 'kernel_size': 3, 'strides': 2,
         'padding': 'same'},
        {'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]


def _handler(cls=BatchHandler, val=False, **kwargs):
    return cls([make_fake_dset((16, 16, 24), FEATURES)],
               [make_fake_dset((16, 16, 24), FEATURES)] if val else None,
               batch_size=2, n_batches=1, s_enhance=2, t_enhance=1,
               sample_shape=(8, 8, 1), **kwargs)


def _events(root):
    return glob.glob(os.path.join(root, 'logs', 'events.out.tfevents.*'))


def _traces(root):
    return glob.glob(os.path.join(root, 'profile', '*.pt.trace.json'))


def test_training_session_runs_to_completion(tmp_path):
    handler = _handler()
    model = Sup3rGan(GEN, DISC, learning_rate=1e-3, device='cpu')
    session = TrainingSession(handler, model, input_resolution=RES,
                              n_epoch=1, out_dir=str(tmp_path / 'm_{epoch}'))
    assert session.run() is model
    assert len(model.history) == 1
    assert os.path.exists(tmp_path / 'm_0' / 'model_params.json')


def test_training_session_propagates_errors():
    handler = _handler()
    session = TrainingSession(handler, Sup3rGan(GEN, DISC, device='cpu'),
                              not_a_real_kwarg=True)
    with pytest.raises(TypeError, match='not_a_real_kwarg'):
        session.run()
    handler.stop()


def test_training_session_trains_a_cond_mom_with_tensorboard(tmp_path):
    handler = _handler(BatchHandlerMom1, val=True, s_padding=1)
    model = Sup3rCondMom(GEN, learning_rate=1e-3, device='cpu')
    TrainingSession(handler, model, input_resolution=RES, n_epoch=2,
                    out_dir=str(tmp_path / 'mom_{epoch}'),
                    tensorboard_log=True).run()
    assert model.history.index == [0, 1]
    assert len(_events(tmp_path)) == 1


def test_profile_to_dir_writes_trace(tmp_path):
    log_dir = str(tmp_path / 'trace')
    with profile_to_dir(log_dir):
        torch.ones((64, 64)).sum()
    files = glob.glob(os.path.join(log_dir, '*.pt.trace.json'))
    assert len(files) == 1
    with open(files[0]) as f:
        assert json.load(f)['traceEvents']
    with profile_to_dir(str(tmp_path / 'none'), enabled=False):
        pass
    assert not os.path.exists(tmp_path / 'none')


def test_tb_log_dict(tmp_path):
    writer = make_tb_writer(str(tmp_path / 'run' / 'gan_{epoch}'))
    tb_log_dict(writer, {'loss': 1.5, 'note': 'text', 'bad': object()}, 0)
    writer.close()
    assert len(_events(tmp_path / 'run')) == 1
    tb_log_dict(None, {'loss': 1.0}, 0)


def _solar_cc(tmp_path):
    rng = np.random.default_rng(0)
    cs = 2 + 998 * rng.random((72, 6, 6))
    nsrdb = make_fake_nc_file(str(tmp_path / 'nsrdb.nc'), (6, 6, 72),
                              ['ghi', 'clearsky_ghi'],
                              data={'ghi': cs * rng.random(cs.shape),
                                    'clearsky_ghi': cs})
    handler = BatchHandlerCC(
        [DataHandlerH5SolarCC(nsrdb, features=['clearsky_ratio'])],
        batch_size=1, n_batches=2, s_enhance=1, t_enhance=8,
        sample_shape=(4, 4, 24))
    model = SolarCC(generator_cc_temporal(1, 8, 4, filters=8, n_resblocks=1,
                                          chan_per_step=8),
                    [{'class': 'Flatten'}, {'class': 'Dense', 'units': 1}],
                    device='cpu')
    return model, handler, {'spatial': '4km', 'temporal': '1440min'}


def _with_obs(tmp_path):
    gen = [*GEN[:2], {'class': 'Sup3rConcatObs', 'name': 'u_100m_obs'},
           GEN[2]]
    model = Sup3rGanWithObs(gen, DISC, device='cpu',
                            onshore_obs_frac={'spatial_frac': [0.2, 0.4]})
    return model, _handler(), RES


def _dc(tmp_path):
    handler = BatchHandlerDC([make_fake_dset((16, 16, 24), FEATURES)],
                             [make_fake_dset((16, 16, 24), FEATURES)],
                             batch_size=2, n_batches=1, s_enhance=2,
                             t_enhance=1, sample_shape=(8, 8, 1),
                             n_space_bins=2, n_time_bins=1)
    return Sup3rGanDC(GEN, DISC, device='cpu'), handler, RES


def _gan(tmp_path):
    return Sup3rGan(GEN, DISC, device='cpu'), _handler(val=True), RES


@pytest.mark.parametrize('make', [_gan, _solar_cc, _with_obs, _dc],
                         ids=['Sup3rGan', 'SolarCC', 'Sup3rGanWithObs',
                              'Sup3rGanDC'])
def test_train_writes_events_and_a_profile(tmp_path, make):
    """``train(tensorboard_log=True, tensorboard_profile=True)``: one
    event file in ``<out_dir>/../logs`` with the history's columns, one
    trace of the first epoch in ``<dirname(out_dir)>/profile``."""
    model, handler, res = make(tmp_path)
    model.train(handler, input_resolution=res, n_epoch=2,
                out_dir=str(tmp_path / 'gan_{epoch}'), tensorboard_log=True,
                tensorboard_profile=True)
    assert model.history.index == [0, 1]
    events = _events(tmp_path)
    assert len(events) == 1
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(events[0])
    acc.Reload()
    tags = set(acc.Tags()['scalars'])
    assert {'elapsed_time', 'train_loss_gen'} <= tags
    assert [e.step for e in acc.Scalars('train_loss_gen')] == [0, 1]
    assert len(_traces(tmp_path)) == 1


def test_train_without_tensorboard_warns_and_completes(tmp_path,
                                                       monkeypatch):
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    for model, handler in (
            (Sup3rGan(GEN, DISC, device='cpu'), _handler()),
            (Sup3rCondMom(GEN, device='cpu'), _handler(BatchHandlerMom1))):
        with pytest.warns(UserWarning, match='tensorboard'):
            model.train(handler, input_resolution=RES, n_epoch=1,
                        out_dir=str(tmp_path / 'm_{epoch}'),
                        tensorboard_log=True)
        assert len(model.history) == 1
    assert not os.path.exists(tmp_path / 'logs')
