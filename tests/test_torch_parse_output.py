"""The port's printed stats and timers -> tools/parse_output.py round
trip: the twin of tests/test_parse_output.py with the same assertions
(grid complexity in (1, 3), every timer present, the phase sum within
the total setup, level count and iterations, the getters equal to the
parsed values), plus a same-pattern re-setup, whose ``Reuse plan`` and
``Re-setup *`` timers (the port's own labels) obey the same sum rule.
"""

import io
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from parse_output import parse_output  # noqa: E402

from pflare_tpu_torch import AIROptions, PCAIR, adv_diff_2d  # noqa: E402
from pflare_tpu_torch import native  # noqa: E402
from pflare_tpu_torch.utils.timers import LABELS, get_timers  # noqa: E402

torch.set_num_threads(1)


def _captured_run(reuse: bool = False):
    """A 30^2 setup with stats and timers printed (and with ``reuse`` a
    perturbed same-pattern re-setup after it), then a GMRES solve."""
    from pflare_tpu_torch.utils.timers import reset_timers

    reset_timers()   # the timers are global and cumulative by design
    A = adv_diff_2d(30)
    pc = PCAIR(AIROptions(print_stats_timings=True, a_lump=True,
                          a_drop=1e-5, strong_threshold=0.99,
                          reuse_sparsity=reuse),
               dtype=torch.float64, device="cpu")
    buf = io.StringIO()
    with redirect_stdout(buf):
        pc.setup(A)
        if reuse:
            A2 = A.copy()
            A2.data = A2.data * (1.0 + 0.01 * np.sin(np.arange(A2.nnz)))
            pc.setup(A2, structure="same")
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    res = pc.solve(b, rtol=1e-5, max_it=10)
    text = buf.getvalue() + f"\niterations: {res.iterations}\n"
    return pc, res, text


@pytest.mark.parametrize("reuse", [False, True],
                         ids=["setup", "same-pattern re-setup"])
def test_parser_round_trip(reuse):
    pc, res, text = _captured_run(reuse)
    parsed = parse_output(text)
    assert parsed["n_levels"] == pc.n_levels
    # the reference CI bound (reference: python/run_parse_tests.py:7)
    assert 1.0 < parsed["complexities"]["grid"] < 3.0
    assert parsed["complexities"]["operator"] >= 1.0
    assert parsed["complexities"]["cycle"] > 0
    assert parsed["complexities"]["storage"] > 0
    if reuse:
        assert parsed["complexities"]["reuse_storage"] > 0.0
    else:
        assert parsed["complexities"]["reuse_storage"] == 0.0
    assert parsed["iterations"] == res.iterations
    assert parsed["iterations"] <= 10
    # every timer the setup ran is printed and parses; total setup
    # dominates its phases
    want = {LABELS[name][: -len(" time")] for name in get_timers()}
    assert want == set(parsed["timings"])
    if reuse:
        assert "Reuse plan" in want
        # the plan re-setup runs on the native host kernels; without
        # them the generic reuse path re-runs the numeric setup
        if native.get_lib() is not None:
            assert {k for k in want if k.startswith("Re-setup")}
    assert parsed["timings"]["Total setup"] > 0
    phase_sum = sum(v for k, v in parsed["timings"].items()
                    if k != "Total setup")
    assert phase_sum <= parsed["timings"]["Total setup"] * 1.001


def test_parser_matches_stats_getters():
    pc, _, text = _captured_run()
    parsed = parse_output(text)
    s = pc.stats()
    assert abs(parsed["complexities"]["grid"]
               - s["grid_complexity"]) < 1e-5
    assert abs(parsed["complexities"]["operator"]
               - s["operator_complexity"]) < 1e-5
    assert abs(parsed["complexities"]["cycle"]
               - s["cycle_complexity"]) < 1e-5
    assert abs(parsed["complexities"]["storage"]
               - s["storage_complexity"]) < 1e-5
    assert parsed["n_levels"] == s["levels"]
