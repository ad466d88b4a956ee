#!/usr/bin/env python3
"""Time the port's banded SpMV kernel with and without its empty-slot skip.

    python3 tools/torch_banded_skip.py [--grids 512,2048]

``pflare_tpu_torch/csrc/banded_spmv.cu`` skips the read of x for a slot
whose value is 0.  This script builds the source twice with nvcc: as it
is, and with that test taken out, so that every slot reads x.  For each
grid it sets up the main path's hierarchy (the options of chip_smoke.py)
to three levels, so that level 1 is a full level, and times both builds
on every banded operator of level 1 in f32.  Times are device times by
CUDA graph replay (``chip_smoke.graph_ms``) over enough copies of the
operator to fill twice the L2, as chip_smoke.py times its kernels, in
the order as-is, no-skip, no-skip, as-is; the better of each pair is
printed.  Needs one CUDA device; prints one JSON line per operator.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKIP_TEST = "d[v] != T(0) && "


def matvec(torch, cuda, lib, M, x):
    K, n_pad = M.data.shape
    y = torch.empty(M.n, dtype=M.data.dtype, device=M.data.device)
    cuda.launch("banded_spmv", M.data.dtype, M.data.data_ptr(),
                M.lcols.data_ptr(), x.data_ptr(), y.data_ptr(), M.n, n_pad,
                M.n_cols, K, M.w, M.W, cuda.stream_handle(M.data.device),
                lib=lib)
    return y


def compare(torch, cuda, tbanded, chip_smoke, libs, rng, grid, name, M):
    """Both builds against the plain version, then timed, on one operator."""
    x = torch.as_tensor(rng.standard_normal(M.n_cols), dtype=torch.float32,
                        device=M.data.device)
    ref = tbanded.banded_spmv_plain(M.data, M.lcols, x, M.n, M.w, M.W)
    op_bytes = M.data.numel() * 8
    copies = min(chip_smoke.R,
                 max(1, math.ceil(2 * chip_smoke.L2_BYTES / op_bytes)))
    mats = [M] + [type(M)(M.data.clone(), M.lcols.clone(), M.n, M.n_cols,
                          M.w, M.W) for _ in range(copies - 1)]
    fns = {}
    for tag, dll in libs.items():
        y = matvec(torch, cuda, dll, M, x)
        rel = float((y - ref).norm() / ref.norm())
        if not rel <= 1e-6:
            raise SystemExit(f"{tag} build disagrees with the plain version "
                             f"on level 1 {name}: {rel:.3e}")
        fns[tag] = [lambda dll=dll, C=C: matvec(torch, cuda, dll, C, x)
                    for C in mats]
    t = [chip_smoke.graph_ms(torch, fns[tag])
         for tag in ("skip", "no_skip", "no_skip", "skip")]
    nnz = int(torch.count_nonzero(M.data))
    return {"grid": grid, "operator": f"level 1 {name}", "n": M.n,
            "K": M.data.shape[0], "W": M.W,
            "pad_share": 1 - nnz / M.data.numel(), "copies": copies,
            "skip_ms": min(t[0], t[3]), "no_skip_ms": min(t[1], t[2])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grids", default="512,2048",
                    help="comma-separated grid sides")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    sys.path.insert(0, REPO)
    import chip_smoke
    import pflare_tpu_torch as tpf
    from pflare_tpu_torch import cuda
    from pflare_tpu_torch.sparse import BandedSpMV
    from pflare_tpu_torch.sparse import banded as tbanded

    text = open(os.path.join(cuda.CSRC, "banded_spmv.cu")).read()
    if text.count(SKIP_TEST) != 1:
        raise SystemExit("the empty-slot test is not in the kernel source")
    src = os.path.join(cuda.BUILD_DIR, "banded_no_skip.cu")
    os.makedirs(cuda.BUILD_DIR, exist_ok=True)
    with open(src, "w") as f:
        f.write(text.replace(SKIP_TEST, ""))
    libs = {"skip": cuda.load("banded_spmv"),
            "no_skip": cuda.load("banded_spmv", src=src, tag="no_skip")}

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    for grid in (int(g) for g in args.grids.split(",")):
        pc = tpf.PCAIR(chip_smoke.bench_options(tpf, max_levels=3),
                       dtype=torch.float32, device=dev)
        pc.setup(tpf.adv_diff_2d(grid).astype(np.float32))
        level1 = pc.upload().levels[1]
        ops = [(k, level1[k]) for k in ("A_ff", "A_fc", "R", "P")]
        if level1["inv_Aff"].kind == "assembled":
            ops.append(("inv_Aff", level1["inv_Aff"].mat))
        for name, M in ops:
            if isinstance(M, BandedSpMV):
                print(json.dumps(compare(torch, cuda, tbanded, chip_smoke,
                                         libs, rng, grid, name, M)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
