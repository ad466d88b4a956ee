#!/usr/bin/env python3
"""Richardson and GMRES with PCAIR on the DG(1) operator of chip_smoke.py
phase 14 (b), on the card.

    python3 tools/torch_mesh_richardson.py [--m 512] [--sides 256,384]

The mesh is phase 14's (``chip_smoke.mesh_tri``: 2 m^2 jittered Delaunay
triangles, scrambled), the operator ``dg1_upwind_advection``, the options
``AIROptions(reorder="auto")`` plus the variant's.  Each line is one JSON
object with the residual norms (relative to the first) of a solve to
rtol 1e-5:

- the host-built hierarchy in f32 and f64, Richardson (12 iterations) on
  the card and on its CPU twin (``PCAIR.on`` before the upload);
- option variants in f32 (``a_lump``, F-C-F smoothing, ``ddc_fraction``
  0.2, 16 levels, strong threshold 0.99), Richardson with a cap of 30;
- the default at the grid sides of ``--sides``;
- right GMRES (cap 30) on the host-built and the device-built
  (``setup_device``) hierarchy, and Richardson on the device-built one.

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VARIANTS = (("a_lump", dict(a_lump=True)),
            ("F-C-F smoothing", dict(smooth_order=(1, -1, 1))),
            ("ddc_fraction 0.2", dict(ddc_fraction=0.2)),
            ("16 levels", dict(max_levels=16)),
            ("strong threshold 0.99", dict(strong_threshold=0.99)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=512)
    ap.add_argument("--sides", default="256,384")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    import pflare_tpu_torch as tpf
    from chip_smoke import mesh_tri
    from pflare_tpu_torch import cuda

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cuda.build_all()
    dev = torch.device("cuda")
    matrices = {}

    def operator(m):
        if m not in matrices:
            matrices[m] = tpf.dg1_upwind_advection(*mesh_tri(np, m))
        return matrices[m]

    def run(label, pc, A, b, ksp="richardson", max_it=30, **extra):
        kw = dict(side="right") if ksp == "gmres" else {}
        t0 = time.perf_counter()
        res = pc.solve(b, ksp=ksp, rtol=1e-5, max_it=max_it, **kw)
        h = np.asarray(res.history)
        true = float(np.linalg.norm(A @ res.x.double().cpu().numpy() - b)
                     / np.linalg.norm(b))
        print(json.dumps({
            "case": label, "ksp": ksp, "device": str(pc.device),
            "levels": pc.n_levels, "iterations": res.iterations,
            "converged": bool(res.converged), "true_residual": true,
            "seconds": time.perf_counter() - t0,
            "relative_norms": (h / h[0]).tolist(), **extra}), flush=True)
        return h

    def setup(A, dtype=torch.float32, device_built=False, **opts):
        pc = tpf.PCAIR(tpf.AIROptions().replace(reorder="auto", **opts),
                       dtype=dtype, device=dev)
        t0 = time.perf_counter()
        (pc.setup_device if device_built else pc.setup)(A)
        torch.cuda.synchronize()
        return pc, time.perf_counter() - t0

    A = operator(args.m)
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    tag = f"m={args.m}, {A.shape[0]} DoF"
    for dtype in (torch.float32, torch.float64):
        pc, t = setup(A, dtype)
        cpu = pc.on("cpu")
        name = str(dtype).split(".")[-1]
        h = run(f"{tag} default {name}", pc, A, b, max_it=12, setup_s=t)
        hc = run(f"{tag} default {name}", cpu, A, b, max_it=12)
        print(json.dumps({"case": f"{tag} default {name}",
                          "card_against_cpu_max_relative_difference":
                              float(np.max(np.abs(h - hc) / hc))}))
        del pc, cpu
    for label, opts in VARIANTS:
        pc, t = setup(A, **opts)
        run(f"{tag} {label}", pc, A, b, setup_s=t)
        del pc
    for side in (int(s) for s in args.sides.split(",") if s):
        As = operator(side)
        bs = np.random.default_rng(1).standard_normal(As.shape[0])
        pc, t = setup(As)
        run(f"m={side}, {As.shape[0]} DoF default", pc, As, bs, setup_s=t)
        del pc
    for device_built in (False, True):
        pc, t = setup(A, device_built=device_built)
        label = f"{tag} default, {'device' if device_built else 'host'}-built"
        run(label, pc, A, b, ksp="gmres", setup_s=t)
        if device_built:
            run(label, pc, A, b)
        del pc
    return 0


if __name__ == "__main__":
    sys.exit(main())
