"""AIRG on 2D upwinded advection on the GPU: the PyTorch twin of
examples/ex_airg_advection.py (the reference's flagship use case,
counterpart of python/ex2.py + the adv_diff_fd driver).

The setup runs on the host (numpy, scipy and the native C++ kernels);
the V-cycle and right-preconditioned GMRES run on the device, in float64,
with the top operator on the DIA kernel and the banded levels on the
banded kernel.

Run: python examples/torch/ex_airg_advection.py [grid_size] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch

import pflare_tpu_torch as pt


def main(n_grid=100, device="cuda", dtype=torch.float64):
    """Set up, view and solve; returns the printed numbers, the solution
    ``x`` (numpy, float64) and the preconditioner ``pc``."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run with --device cpu")
    A = pt.adv_diff_2d(n_grid)
    print(f"2D advection, {A.shape[0]} unknowns, {A.nnz} nonzeros")

    pc = pt.PCAIR(pt.AIROptions(a_lump=True, a_drop=1e-5,
                                strong_threshold=0.99),
                  dtype=dtype, device=device)
    pc.setup(A)
    pc.view()

    b = np.random.default_rng(0).standard_normal(A.shape[0])
    res = pc.solve(b, rtol=1e-10, atol=1e-50, side="right")
    print(f"converged={res.converged} in {res.iterations} iterations")
    print("residual history:", ["%.2e" % v for v in res.history])
    return {"unknowns": A.shape[0], "nnz": A.nnz, "levels": pc.n_levels,
            "converged": res.converged, "iterations": res.iterations,
            "history": res.history, "x": res.x.double().cpu().numpy(),
            "pc": pc}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("grid_size", nargs="?", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.grid_size, device=args.device)
