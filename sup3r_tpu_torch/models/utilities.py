"""Model-layer utilities: interruptible training sessions, tensorboard
logging and profiling (the port of ``sup3r_tpu/models/utilities.py``).

``make_tb_writer`` / ``tb_log_dict`` write each epoch's history row
through torch's ``SummaryWriter``; without the ``tensorboard`` package
they warn and training goes on unlogged. ``profile_to_dir`` records a
``torch.profiler`` trace of the block into a log directory (a
``*.pt.trace.json`` file that chrome://tracing, Perfetto and
tensorboard's profile plugin read) and logs the program's spans and
counters of the block (``utilities.trace``) beside it.

Reference parity: sup3r/models/utilities.py:30-133.
"""

import contextlib
import logging
import os
import socket
import threading
import time
from warnings import warn

import torch

from sup3r_tpu_torch.utilities import trace

logger = logging.getLogger(__name__)


class TrainingSession:
    """Run ``model.train`` in a thread so that Ctrl-C stops the batch
    handler and the training ends cleanly (reference:
    models/utilities.py:30). An error in training is raised again by
    ``run``."""

    def __init__(self, batch_handler, model, **kwargs):
        self.batch_handler = batch_handler
        self.model = model
        self.kwargs = kwargs
        self._exc = None

    def _target(self):
        try:
            self.model.train(self.batch_handler, **self.kwargs)
        except Exception as e:  # raised again in run()
            self._exc = e

    def run(self):
        """Train until completion or KeyboardInterrupt; returns the
        model."""
        thread = threading.Thread(target=self._target, daemon=True,
                                  name='training_session')
        thread.start()
        try:
            while thread.is_alive():
                thread.join(timeout=0.5)
        except KeyboardInterrupt:
            logger.info('Interrupt received; stopping the batch handler')
            self.batch_handler.stop()
            thread.join(timeout=30)
        if self._exc is not None:
            raise self._exc
        return self.model


def make_tb_writer(out_dir):
    """A ``SummaryWriter`` logging to ``<out_dir>/../logs``, or None
    (with a warning) when the ``tensorboard`` package is not
    importable."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        msg = ('tensorboard_log was requested but tensorboard is not '
               f'importable ({e}); training goes on without it')
        logger.warning(msg)
        warn(msg)
        return None
    pardir = os.path.abspath(os.path.join(out_dir or '.', os.pardir))
    log_dir = os.path.join(pardir, 'logs')
    os.makedirs(log_dir, exist_ok=True)
    logger.info('TensorBoard logs -> %s', log_dir)
    return SummaryWriter(log_dir=log_dir)


def tb_log_dict(writer, entry, step):
    """Write a loss-details dict as scalars (strings as text); a None
    writer is a no-op."""
    if writer is None:
        return
    for name, value in entry.items():
        try:
            if isinstance(value, str):
                writer.add_text(name, value, step)
            else:
                writer.add_scalar(name, float(value), step)
        except (TypeError, ValueError):
            continue
    writer.flush()


@contextlib.contextmanager
def profile_to_dir(log_dir, enabled=True):
    """Record the block with ``torch.profiler`` (host ops, and the
    card's kernels and copies where there is one) and write its trace to
    ``<log_dir>/<host>_<pid>.<ms>.pt.trace.json``; log the table of the
    program's spans and counters that the block added (name, count,
    total and self ms; ``utilities.trace``). ``enabled=False`` is a
    no-op."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    before = trace.snapshot()
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, f'{socket.gethostname()}_{os.getpid()}.'
                                 f'{int(time.time() * 1e3)}.pt.trace.json')
    prof.export_chrome_trace(path)
    logger.info('Wrote a torch.profiler trace to %s', path)
    logger.info('Program spans of the trace:\n%s',
                '\n'.join(trace.table(trace.snapshot(), before)))
