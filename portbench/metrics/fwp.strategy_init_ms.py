"""fwp.strategy_init_ms: ms of ``ForwardPassStrategy.__post_init__`` a
pass (the program's span ``strategy.init``: the model's lookup, the
input read, the chunk plan, exogenous rasters)."""

from portbench.metrics._program_trace import per_unit


def read(record):
    return per_unit(record, 'fwp', 'spans', 'strategy.init')
