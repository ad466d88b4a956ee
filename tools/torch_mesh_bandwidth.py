#!/usr/bin/env python3
"""Whether the RCM-reordered top operator of a phase-14 mesh takes the
banded kernel.

    python3 tools/torch_mesh_bandwidth.py [--m 1024] [--operator fv|dg1]

Builds chip_smoke.py phase 14's mesh (``chip_smoke.mesh_tri``: 2 m^2
jittered Delaunay triangles, scrambled), assembles the FV or DG(1)
operator, reorders it by reverse Cuthill-McKee as ``PCAIR`` does under
``reorder="rcm"`` and prints one JSON line: the DoF, nonzeros, the
slots a row K, the bandwidth w, the window W, K * W against the
banded envelope's 12,288, ``BandedSpMV.viable`` and ``DIA.viable``, and
the seconds of the mesh, the assembly and the reorder.  Host work only;
needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=1024)
    ap.add_argument("--operator", choices=("fv", "dg1"), default="fv")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    import pflare_tpu_torch as tpf
    from chip_smoke import mesh_tri
    from pflare_tpu_torch.sparse import DIA, BandedSpMV
    from pflare_tpu_torch.sparse.banded import TILE_ROWS

    t0 = time.perf_counter()
    pts, cells = mesh_tri(np, args.m)
    t_mesh = time.perf_counter() - t0
    assemble = {"fv": tpf.fv_upwind_advection,
                "dg1": tpf.dg1_upwind_advection}[args.operator]
    t0 = time.perf_counter()
    A = assemble(pts, cells)
    t_asm = time.perf_counter() - t0
    t0 = time.perf_counter()
    pat = sp.csr_matrix((np.ones(A.nnz), A.indices, A.indptr), shape=A.shape)
    perm = np.asarray(reverse_cuthill_mckee(sp.csr_matrix(pat + pat.T),
                                            symmetric_mode=True))
    Ap = sp.csr_matrix(A[perm][:, perm])
    t_rcm = time.perf_counter() - t0
    K = int(np.diff(Ap.indptr).max())
    w = BandedSpMV.bandwidth(Ap)
    W = -(-(2 * w + TILE_ROWS) // 128) * 128
    print(json.dumps({
        "m": args.m, "operator": args.operator, "dof": A.shape[0],
        "nnz": A.nnz, "K": K, "w": w, "W": W, "K_times_W": K * W,
        "envelope": 12288, "banded_viable": BandedSpMV.viable(Ap),
        "dia_viable": DIA.viable(Ap), "mesh_s": t_mesh,
        "assemble_s": t_asm, "rcm_s": t_rcm}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
