"""The comparison that decides ``correct`` separates the program's
answers from the control's, at a size a test run holds.

The control is the reference in the program's place one precision below
the configuration's float32: the exact solution rounded to TF32 (and to
bfloat16), the best any program computing in that precision could
return.  Each cell's limit lies between the program's readings and the
control's."""

import numpy as np
import pytest

from conftest import CELLS, tiny_spec
from solverbench import harness, problems, reference

SIZES = {"adv_diff_fd_3072": {"n": 128}, "dg1_upwind_tri_1280": {"m": 24}}
SEEDS = (2**31 + 1, 2**31 + 2, 2**31 + 3)


def test_round_mantissa():
    x = np.array([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                  -3.14159, 0.0])
    got = reference.round_mantissa(x, 10)
    # ties go to even
    assert got.tolist()[:4] == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9]
    assert abs(got[4] + 3.14159) <= 3.14159 * 2**-11 and got[5] == 0.0
    assert np.array_equal(reference.round_mantissa(x, 23),
                          x.astype(np.float32))


@pytest.mark.parametrize("workload", CELLS)
def test_program_reads_under_the_limit_control_over_it(workload):
    spec = tiny_spec(workload, **SIZES[spec_config(workload)])
    limit = spec["checks"]["max_rel_residual"]["limit"]
    cell = harness.Cell(spec, SEEDS[0], "cpu")
    for seed in SEEDS:
        cell.reseed(seed)
        answers = []
        for _ in range(3):
            _, (x, b) = cell.request()
            answers.append((x.double().numpy(), b.double().numpy()))
        got = harness.judge(spec["checks"], cell.A, answers, 0)
        assert got["max_rel_residual"]["value"] <= limit
        for precision in ("tf32", "bfloat16"):
            worst = reference.control_residual(cell.A, seed, precision)
            assert worst > limit, (precision, worst, limit)


def spec_config(workload):
    return workload.split(".")[0]


def test_control_reads_what_rounding_costs():
    A = problems.adv_diff_2d(64)
    tf32 = reference.control_residual(A, 7, "tf32")
    bf16 = reference.control_residual(A, 7, "bfloat16")
    assert 1e-4 < tf32 < 1e-3 and bf16 > 4 * tf32
