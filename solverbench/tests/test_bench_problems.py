"""The frozen generators give the program's matrices today, bit for bit."""

import numpy as np
import pytest

import pflare_tpu_torch as pt
from solverbench import problems

N = 64


def same(A, B):
    return (A.shape == B.shape and np.array_equal(A.indptr, B.indptr)
            and np.array_equal(A.indices, B.indices)
            and np.array_equal(A.data, B.data))


def test_adv_diff_2d_is_the_programs():
    assert same(problems.adv_diff_2d(N), pt.adv_diff_2d(N))


def test_mesh_tri_is_chip_smokes():
    import chip_smoke

    for got, want in zip(problems.mesh_tri(N, 0),
                         chip_smoke.mesh_tri(np, N, 0)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3])
def test_dg1_upwind_tri_is_the_programs(seed):
    pts, cells = problems.mesh_tri(N, seed)
    assert same(problems.dg1_upwind_tri(pts, cells),
                pt.dg1_upwind_advection(pts, cells))


def test_generators_by_name():
    assert same(problems.GENERATORS["dg1_upwind_tri_mesh"](m=16),
                pt.dg1_upwind_advection(*problems.mesh_tri(16, 0)))
