#!/usr/bin/env python3
"""Host and device memory, and seconds, of each step of a same-pattern
re-setup of the main path.

    python3 tools/torch_resetup_memory.py [--grid 2048] [--amount 3]
                                          [--device cuda]

The options are those of chip_smoke.py phase 11 (b): the main path's
(a_lump, a_drop 1e-5, strong threshold 0.99, 10 levels, order-24
matrix-free Newton coarse solve) with ``reuse_sparsity``, the given
``reuse_amount`` and ``reuse_poly_coeffs``, set up from the f64 matrix
for an f32 solve.  Steps: the first setup, the host re-setup of a
perturbed matrix (``setup(A2, "same")``), the upload, and with amount 3
the device re-setup's plan build and two installs.  After each step one
JSON line: the step's seconds (to completion), the process's resident
host memory (GiB, from /proc/self/status) and the peak device memory
(GiB, ``torch.cuda.max_memory_allocated``, on a card).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_gib() -> dict:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return {"host_resident_gib": int(line.split()[1]) / 2**20}
    return {}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=2048)
    ap.add_argument("--amount", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    import pflare_tpu_torch as tpf

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"

    def step(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        if cuda:
            torch.cuda.synchronize()
        row = {"step": name, "seconds": time.perf_counter() - t0,
               **host_gib()}
        if cuda:
            row["device_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            row["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(row), flush=True)
        return out

    A = tpf.adv_diff_2d(args.grid)
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 0.01 * np.random.default_rng(6)
                         .standard_normal(A.nnz))
    opts = tpf.AIROptions(
        a_lump=True, a_drop=1e-5, strong_threshold=0.99, max_levels=10,
        coarsest_inverse_type=tpf.InverseType.NEWTON, coarsest_poly_order=24,
        coarsest_matrix_free_polys=True, reuse_sparsity=True,
        reuse_amount=args.amount, reuse_poly_coeffs=True)
    pc = tpf.PCAIR(opts, dtype=torch.float32, device=dev)
    step("first setup", pc.setup, A)
    step("host re-setup", pc.setup, A2, "same")
    step("upload", pc.upload)
    if args.amount >= 3:
        plan = step("plan build", pc.build_device_resetup)
        print(json.dumps({"plan_device_gib": plan.device_bytes / 2**30}))
        step("install (first)", plan.install, pc, A2)
        step("install (warm)", plan.install, pc, A2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
