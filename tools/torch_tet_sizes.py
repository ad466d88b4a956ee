#!/usr/bin/env python3
"""The device set-up of 3-D DG(1) upwind advection on tetrahedra, size by
size: what decides how large a mesh one card sets up.

    python3 tools/torch_tet_sizes.py --m 16,24,32 [--solves 3]
        [--stop-after 150] [--device cuda] [--out FILE]

For each m: the benchmark's operator (``solverbench/generators/
dg1_upwind_tet_mesh.py``, kept in ``solverbench/_cache/operators/`` as the
benchmark keeps it), then ``PCAIR(AIROptions(reorder="auto"), jit=True,
dtype=float32).setup_device(A)`` with the card's peak memory reset before
it, then ``--solves`` right-GMRES solves to 1e-5 of seeded right-hand
sides.  Prints one JSON line an m: the DoF, the levels, the set-up's
seconds and peak bytes, the solves' iterations and the peak after them.
Sizes after one whose set-up took more than ``--stop-after`` seconds or
ran out of memory are skipped.  A first set-up at m = 8 warms the card up
and is not reported.  The set-up's seconds by level and phase are
``tools/torch_trace_cell.py``'s.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def run(m, solves, torch, pt, harness, dev):
    cuda = dev.type == "cuda"
    A = harness.operator({"generator": "dg1_upwind_tet_mesh",
                          "args": {"m": m, "mesh_seed": 0, "jitter": 0.2}},
                         harness.OPERATOR_CACHE)
    row = {"m": m, "dofs": A.shape[0], "nnz": int(A.nnz)}
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    pc = pt.PCAIR(pt.AIROptions(reorder="auto"), jit=True,
                  dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    pc.setup_device(A)
    if cuda:
        torch.cuda.synchronize()
    row["setup_s"] = time.perf_counter() - t0
    row["setup_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                               if cuda else None)
    row["levels"] = pc.n_levels
    gen = torch.Generator(device=dev)
    gen.manual_seed(2147483711 + m)
    row["its"] = []
    for _ in range(solves):
        b = torch.randn(A.shape[0], generator=gen, dtype=torch.float32,
                        device=dev)
        row["its"].append(int(pc.solve(b, ksp="gmres", side="right",
                                       rtol=1e-5, max_it=300).iterations))
    row["peak_bytes"] = (torch.cuda.max_memory_allocated(dev) if cuda
                         else None)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", default="16,24,32")
    ap.add_argument("--solves", type=int, default=3)
    ap.add_argument("--stop-after", type=float, default=150.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import pflare_tpu_torch as pt
    from solverbench import harness

    dev = torch.device(args.device)
    if dev.type == "cuda":
        from pflare_tpu_torch import cuda

        cuda.build_all()
    rows = [{"card": card() if dev.type == "cuda" else "cpu"}]
    print(json.dumps(rows[0]), flush=True)
    run(8, args.solves, torch, pt, harness, dev)
    for m in (int(s) for s in args.m.split(",")):
        try:
            row = run(m, args.solves, torch, pt, harness, dev)
        except torch.cuda.OutOfMemoryError as e:
            row = {"m": m, "out_of_memory": str(e)[:400]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rows, f, indent=1)
        if "out_of_memory" in row or row["setup_s"] > args.stop_after:
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
