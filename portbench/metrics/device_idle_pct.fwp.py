"""device_idle_pct.fwp: the share of a profiled stretch of whole passes
in which no operation ran on the card."""

from portbench.metrics._idle import idle


def read(record):
    return idle(record, 'fwp')
