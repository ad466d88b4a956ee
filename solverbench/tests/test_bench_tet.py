"""The tetrahedral DG(1) cell's frozen generator gives the program's
matrix today, bit for bit, and its two counter metrics read the
program's counters."""

import collections
import os
import sys

import numpy as np
import pytest

import pflare_tpu_torch as pt
from conftest import ROOT
from solverbench import harness
from test_bench_problems import same

TESTS = os.path.join(ROOT, "tests")


def _frozen():
    return harness._load("generators", "dg1_upwind_tet_mesh")


@pytest.mark.parametrize("m", [3, 4])
def test_dg1_upwind_tet_is_the_programs(m):
    """The frozen mesh is ``tests/torch_cases.py::tet_mesh``'s in a
    scrambled order, and the frozen assembly on it is the program's."""
    if TESTS not in sys.path:
        sys.path.insert(0, TESTS)
    from torch_cases import tet_mesh

    gen = _frozen()
    pts, cells = gen.mesh_tet(m, 0, 0.2)
    want_pts, want_cells = tet_mesh(m, 0, 0.2)
    assert np.array_equal(pts, want_pts)
    assert len(cells) == len(want_cells)
    assert not np.array_equal(cells, want_cells)
    assert (sorted(map(tuple, cells.tolist()))
            == sorted(map(tuple, want_cells.tolist())))
    assert same(gen.dg1_upwind_tet(pts, cells),
                pt.dg1_upwind_advection(pts, cells))
    assert same(harness.generator("dg1_upwind_tet_mesh")(m=m),
                pt.dg1_upwind_advection(pts, cells))


def test_counter_metrics_read_the_programs_counters(monkeypatch):
    """``multilane_slot_pct.rhs`` and ``setup_chunks`` read the program's
    counters at read time: None where a counter is empty or missing (a
    program without it), else the share of slots read with two or more
    lanes a row and the total of the passes."""
    from pflare_tpu_torch.sparse import dell, ell

    share = harness.reader("multilane_slot_pct.rhs")
    chunks = harness.reader("setup_chunks")
    monkeypatch.setattr(ell, "SLOTS_BY_LANES", collections.Counter())
    monkeypatch.setattr(dell, "SETUP_CHUNKS", collections.Counter())
    assert share({}) is None and chunks({}) is None
    ell.SLOTS_BY_LANES.update({1: 300, 2: 100, 8: 600})
    dell.SETUP_CHUNKS.update({"spgemm": 7, "restrict": 2})
    assert share({}) == pytest.approx(70.0) and chunks({}) == 9
    monkeypatch.delattr(ell, "SLOTS_BY_LANES")
    monkeypatch.delattr(dell, "SETUP_CHUNKS")
    assert share({}) is None and chunks({}) is None
