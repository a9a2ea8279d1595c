"""On the card, at each cell's own size: the control (the plain
reference computed with TF32 on, in the program's place) and, for the
training cell, the planted half-batch fault fail at least one of the
cell's limits on three seeds."""

import pytest

from portbench import control, harness
from portbench.tests.tiny import REPO

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


@pytest.mark.card
@pytest.mark.parametrize('cell, mode', [
    ('st3x4x.fwp.node', 'tf32'),
    ('st3x4x.train.b16', 'tf32'),
    ('st3x4x.train.b16', 'half_batch'),
])
def test_control_fails_a_limit(card, cell, mode):
    found = harness.find_cell(harness.load_json(REPO / 'BENCHMARK.json'),
                              cell)
    limits = found['traffic']['limits']
    for seed in SEEDS:
        if found['traffic']['kind'] == 'fwp':
            readings = control.fwp_control(found, seed, card)
        else:
            readings = control.train_control(found, seed, card, mode)
        assert any(readings[k] > v for k, v in limits.items()
                   if k in readings), (seed, readings, limits)
