"""Polynomial-coefficient checkpoint/restore on the GPU: the PyTorch
twin of examples/ex_getcoeffs.py (counterpart of python/ex6f_getcoeffs.py;
reference: tests/ex6_getcoeffs.c, src/PCPFLAREINV.c:484-563): extract the
GMRES-polynomial coefficients from a configured preconditioner and
rebuild an identical one from them, without re-running the coefficient
iteration.

Run: python examples/torch/ex_getcoeffs.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch

import pflare_tpu_torch as pt


def main(device="cuda", dtype=torch.float64):
    """Get and set on PCPFLAREINV, then the per-level coefficients of a
    PCAIR hierarchy; returns the printed numbers."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run with --device cpu")
    A = pt.adv_1d(400)
    b = np.random.default_rng(0).standard_normal(A.shape[0])

    # one-level PFLAREINV: get/set on the PC
    pc = pt.PCPFLAREINV(matrix_free=True, poly_order=10, dtype=dtype,
                        device=device)
    pc.setup(A)
    coeffs = pc.get_poly_coeffs()
    print(f"extracted {len(coeffs)} coefficients: {np.asarray(coeffs)[:4]} ...")

    pc2 = pt.PCPFLAREINV(matrix_free=True, poly_order=10, dtype=dtype,
                         device=device)
    pc2.set_poly_coeffs(coeffs)      # injected: setup skips the iteration
    pc2.setup(A)
    y1 = pc.apply(b).double().cpu().numpy()
    y2 = pc2.apply(b).double().cpu().numpy()
    same = bool(np.allclose(y1, y2, atol=1e-14))
    print("restored preconditioner identical:", same)
    out = {"coefficients": np.asarray(coeffs), "restored_identical": same,
           "restore_max_abs_diff": float(np.abs(y1 - y2).max()),
           "level_orders": {}}

    # per-level coefficients of a full AIR hierarchy
    pcair = pt.PCAIR(pt.AIROptions(max_levels=4), dtype=dtype, device=device)
    pcair.setup(pt.adv_diff_2d(32))
    for lvl in range(pcair.n_levels - 1):
        c = pcair.get_poly_coefficients(lvl)
        if c is not None:
            order = len(np.asarray(c).ravel()) - 1
            print(f"level {lvl}: order-{order} smoothing polynomial")
        else:
            order = None
            print(f"level {lvl}: diagonal A_ff (MATDIAGONAL fast path, "
                  "no polynomial)")
        out["level_orders"][lvl] = order
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
