"""Every PCPFLAREINV inverse type on the same problem, on the GPU: the
PyTorch twin of examples/ex_pflareinv_options.py (counterpart of
python/ex_pcpflareinv_options.py).  Assembled polynomials and SAI/ISAI
run through the gather SpMV, matrix-free ones as SpMVs of A.

Run: python examples/torch/ex_pflareinv_options.py [--device cpu]
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
    """GMRES with each inverse type, assembled and matrix-free; returns
    {(type name, "assembled" or "mf"): (converged, iterations)}."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run with --device cpu")
    A = pt.random_diag_dominant(400, 0.02, seed=3)
    b = np.random.default_rng(0).standard_normal(400)
    out = {}
    for t in pt.InverseType:
        for mf in (False, True):
            if mf and t in (pt.InverseType.SAI, pt.InverseType.ISAI,
                            pt.InverseType.WJACOBI, pt.InverseType.JACOBI):
                continue
            pc = pt.PCPFLAREINV(inverse_type=t, poly_order=6, matrix_free=mf,
                                dtype=dtype, device=device)
            pc.setup(A)
            res = pc.solve(b, rtol=1e-8, max_it=100)
            tag = "mf" if mf else "assembled"
            print(f"{t.name:16s} {tag:9s} converged={res.converged} "
                  f"its={res.iterations}")
            out[(t.name, tag)] = (res.converged, res.iterations)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
