"""Tests of the benchmark. CPU tests hold the plain reference to the
program at small sizes and drive the harness without a card; tests
marked ``card`` need an NVIDIA card and skip without one (the fixture
decides, never the module's import)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs an NVIDIA card; skips without one')


@pytest.fixture
def card():
    """The card's device name; skips the test where there is no card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (run on the chip)')
    return 'cuda'
