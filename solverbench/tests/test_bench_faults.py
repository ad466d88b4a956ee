"""A run whose timed path is broken underneath reads ``correct`` false:
the harness's look for a card is skipped (the CPU runs the program) and
the rest of a run is driven, once for each fault a cell can have."""

import pytest
import torch

import pflare_tpu_torch as pt
from conftest import CELLS, tiny_spec
from solverbench import harness

SOLVE = pt.PCAIR.solve


def unchanged(self, b, *a, **kw):
    """The solve returns its state unchanged: x stays at its zero start."""
    res = SOLVE(self, b, *a, **kw)
    res.x = torch.zeros_like(res.x)
    return res


def half_rows(self, b, *a, **kw):
    """Half of the rows of x left out."""
    res = SOLVE(self, b, *a, **kw)
    res.x = res.x.clone()
    res.x[res.x.shape[0] // 2:] = 0
    return res


def altered(self, b, *a, **kw):
    """One entry of the answer altered where it is produced."""
    res = SOLVE(self, b, *a, **kw)
    res.x = res.x.clone()
    res.x[res.x.shape[0] // 3] += 1.0
    return res


def unconverged(self, b, *a, **kw):
    """The solve reports that it did not reach its rtol."""
    res = SOLVE(self, b, *a, **kw)
    res.converged = False
    return res


FAULTS = {"unchanged": unchanged, "half_rows": half_rows,
          "altered": altered, "unconverged": unconverged}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_broken_path_is_not_correct(workload, fault, monkeypatch):
    spec = tiny_spec(workload)
    sound = harness.run_cell(spec, 5, 0.3, False, "cpu")
    assert sound["correct"] is True
    monkeypatch.setattr(pt.PCAIR, "solve", FAULTS[fault])
    res = harness.run_cell(spec, 5, 0.3, False, "cpu")
    assert res["correct"] is False, res["checks"]
