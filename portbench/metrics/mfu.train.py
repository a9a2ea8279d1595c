"""mfu.train: the GAN step's model operations (forward, dgrad and wgrad
of both networks as the step runs them, from the layer lists) times the
window's steps, a second of the window, as a share of the card's
fp32-accurate peak."""

from portbench.metrics._mfu import mfu


def read(record):
    return mfu(record, 'train')
