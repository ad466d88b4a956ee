"""Standalone CF splitting + diag-dominant submatrix extraction: the
PyTorch twin of examples/ex_cf_splitting.py (counterpart of
python/ex2_cf_splitting.py and compute_diag_dom_submatrix, reference:
docs/new_methods.md:60-168).

The splittings are host work (numpy and the native C++ kernels), as in
the JAX package; ``device`` is checked like every twin's, and no tensor
goes to it.

Run: python examples/torch/ex_cf_splitting.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch

import pflare_tpu_torch as pt
from pflare_tpu_torch.sparse import diag_dominance_ratio


def main(device="cuda", dtype=torch.float64):
    """Four splittings and the diagonally dominant submatrix; returns
    the printed counts."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run with --device cpu")
    A = pt.adv_diff_2d(50, curved_velocity=True).astype(
        np.float32 if dtype == torch.float32 else np.float64)
    out = {"splittings": {}}
    for t in (pt.CFSplittingType.PMISR_DDC, pt.CFSplittingType.PMIS,
              pt.CFSplittingType.PMIS_DIST2, pt.CFSplittingType.AGG):
        fine, coarse = pt.compute_cf_splitting(A, cf_splitting_type=t)
        print(f"{t.name:12s}: {len(fine)} F / {len(coarse)} C "
              f"({100 * len(coarse) / A.shape[0]:.0f}% coarse)")
        out["splittings"][t.name] = (len(fine), len(coarse))

    sub, idx = pt.compute_diag_dom_submatrix(A, max_dd_ratio=0.5)
    r = diag_dominance_ratio(sub, np.ones(sub.shape[0], dtype=bool))
    print(f"diag-dom submatrix: {sub.shape[0]} rows, max ratio "
          f"{r.max():.3f} (target < 0.5)")
    out.update(diag_dom_rows=sub.shape[0], diag_dom_max_ratio=float(r.max()))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
