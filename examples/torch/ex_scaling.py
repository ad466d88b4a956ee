"""Iteration-count scaling study on the GPU: the PyTorch twin of
examples/ex_scaling.py.  AIRG stays flat as the grid refines (counterpart
of the reference's run_tests_medium group, reference:
tests/Makefile:1117-1140): right GMRES at rtol 1e-10 within 6 iterations
at every size, in float64.  The setup runs on the host, the solve on the
device (timed to completion).

Run: python examples/torch/ex_scaling.py [grid_size ...] [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch

import pflare_tpu_torch as pt
from pflare_tpu_torch.utils.timers import device_sync_read


def main(sizes=(100, 200, 400), device="cuda", dtype=torch.float64):
    """One setup and solve a size; returns the printed rows and the last
    size's preconditioner ``pc``."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run with --device cpu")
    print(f"{'grid':>8s} {'dofs':>9s} {'its':>4s} {'grid cx':>8s} "
          f"{'setup s':>8s} {'solve s':>8s}")
    rows = []
    for n in sizes:
        A = pt.adv_diff_2d(n)
        b = np.random.default_rng(0).standard_normal(A.shape[0])
        t0 = time.perf_counter()
        pc = pt.PCAIR(pt.AIROptions(a_lump=True, a_drop=1e-5,
                                    strong_threshold=0.99),
                      dtype=dtype, device=device)
        pc.setup(A)
        t_setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = pc.solve(b, rtol=1e-10, atol=1e-50, side="right", max_it=6)
        device_sync_read(res.x)
        t_solve = time.perf_counter() - t0
        s = pc.stats()
        flag = "" if res.converged else "  NOT CONVERGED"
        print(f"{n:>5d}^2 {A.shape[0]:>9d} {res.iterations:>4d} "
              f"{s['grid_complexity']:>8.2f} {t_setup:>8.2f} "
              f"{t_solve:>8.2f}{flag}")
        rows.append({"n": n, "dofs": A.shape[0], "levels": pc.n_levels,
                     "iterations": res.iterations,
                     "converged": res.converged,
                     "grid_complexity": s["grid_complexity"],
                     "setup_s": t_setup, "solve_s": t_solve})
    return {"rows": rows, "pc": pc}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*", type=int, default=[100, 200, 400])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(tuple(args.sizes), device=args.device)
