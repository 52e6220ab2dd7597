"""The benchmark's own tests: `python -m pytest benchmark/tests -q` on the
CPU; `python -m pytest benchmark/tests -m chip -s -q` on a machine with a
card runs the control's readings there as well."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """The card, or a skip where torch sees none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the control's readings run on the card")
    return torch.device("cuda", 0)
