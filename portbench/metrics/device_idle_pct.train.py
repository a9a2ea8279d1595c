"""device_idle_pct.train: the share of a profiled stretch of whole steps
in which no operation ran on the card."""

from portbench.metrics._idle import idle


def read(record):
    return idle(record, 'train')
