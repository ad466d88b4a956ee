"""The benchmark's own tests: CPU tests at small sizes, and tests marked
``cuda`` that need the card (they skip without one).

    python -m pytest solverbench/tests          # here, on the CPU
    python -m pytest -m cuda solverbench/tests  # on the card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the tiny sizes the CPU tests run each configuration at
TINY = {"adv_diff_fd_3072": {"n": 32}, "dg1_upwind_tri_1280": {"m": 8}}
CELLS = ("adv_diff_fd_3072.rhs", "dg1_upwind_tri_1280.rhs")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the benchmark's runs on the "
        "card); skips without one")


@pytest.fixture
def card():
    """Skip unless a CUDA device is there (decided here, never while a
    module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tiny_spec(workload, **size):
    """The cell's spec with its operator cut to a CPU test's size."""
    from solverbench import harness

    spec = harness.load_spec(workload)
    args = spec["config"]["problem"]["args"]
    args.update(size or TINY[spec["config"]["name"]])
    return spec
