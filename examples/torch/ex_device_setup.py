"""Device-resident first setup + sharded solve on the GPU: the PyTorch
twin of examples/ex_device_setup.py.

1. ``pc.setup_device(A)`` -- pattern discovery ON the device (strength
   graph, PMISR, DDC, extraction, polynomial assembly, Z, RAP as torch
   ops; sparse/dell.py), the analogue of the reference's Kokkos setup for
   device matrices (reference: docs/gpus.md).
2. ``pc.setup(A, mesh=...)`` -- the distributed setup: PMISR's Luby
   rounds sharded over the mesh and the power-basis QR by TSQR
   (reference: src/PMISR_Module.F90:476-643, src/TSQR.F90:65).
3. ``pc.solve_device(b, mesh=...)`` -- the hierarchy sharded with the
   processor-agglomeration schedule, the banded halo Krylov matvec
   (reference: src/AIR_MG_Setup.F90:645-907, src/Repartition.F90).

``make_mesh(8)`` puts 8 row shards on one device (``cuda:0``), each with
its own row block, and every halo exchange is a counted device copy;
``make_mesh(8, devices=["cuda:0", ..., "cuda:3"])`` would spread them
over four cards, two a card, each card holding its own shards' blocks,
the exchanges between cards peer copies and the sharded solve eager
(``jit=False``).  The whole script runs in float32, as the JAX example
does.

Run: python examples/torch/ex_device_setup.py [grid_size] [--device cpu]
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
from pflare_tpu_torch.parallel import make_mesh
from pflare_tpu_torch.parallel.repartition import active_shards_schedule
from pflare_tpu_torch.utils.timers import device_sync_read


def main(n_grid=64, device="cuda", dtype=torch.float32):
    """Device setup and solve, then the mesh setup and the sharded solve
    against the unsharded one; returns the printed numbers."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run with --device cpu")
    A = pt.adv_diff_2d(n_grid)
    n = A.shape[0]
    mesh = make_mesh(8, device=device)
    print(f"2D advection, {n} unknowns, 8 shards on {mesh.device}")
    opts = pt.AIROptions(a_lump=True, a_drop=1e-5, strong_threshold=0.99,
                         max_levels=6)

    # ~~~~~ 1. device-resident first setup ~~~~~
    t0 = time.perf_counter()
    pc_dev = pt.PCAIR(opts, dtype=dtype, device=device)
    pc_dev.setup_device(A)
    device_sync_read(pc_dev.upload().top.data)
    t_dev = time.perf_counter() - t0
    print(f"device setup: {t_dev:.2f}s, {pc_dev.n_levels} levels")
    levels = []
    for lvl in pc_dev.hierarchy.levels:
        print(f"  n={lvl.n:6d}  F={lvl.n_f:6d}  C={lvl.n_c:6d}  "
              f"nnz(A)={lvl.nnz_A}")
        levels.append((lvl.n, lvl.n_f, lvl.n_c, lvl.nnz_A))
    b = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    x, norms = pc_dev.solve_device(b, max_it=10)
    rel = float(np.linalg.norm(A @ x.double().cpu().numpy()
                               - b.astype(np.float64))
                / np.linalg.norm(b))
    print(f"device-built hierarchy solve: true rel residual {rel:.2e}")

    # ~~~~~ 2. distributed setup + 3. sharded solve ~~~~~
    pc = pt.PCAIR(opts, dtype=dtype, device=device)
    pc.setup(A, mesh=mesh)          # sharded Luby rounds + TSQR
    sizes = [lvl.n for lvl in pc.hierarchy.levels]
    sched = active_shards_schedule(sizes, 8, opts.process_eq_limit,
                                   opts.processor_agglom_factor)
    print(f"level sizes {sizes}; active shards per level {sched}")
    b2 = np.random.default_rng(0).standard_normal(n)
    x1, n1 = pc.solve_device(b2, max_it=12)              # unsharded
    x2, n2 = pc.solve_device(b2, max_it=12, mesh=mesh)   # sharded
    diff = float((x1 - x2).abs().max())
    print(f"sharded-vs-single max abs diff: {diff:.3e}")
    return {"device_setup_s": t_dev, "device_levels": levels,
            "device_n_levels": pc_dev.n_levels, "device_true_residual": rel,
            "level_sizes": sizes, "schedule": list(sched),
            "sharded_max_abs_diff": diff,
            "norms": n1.double().cpu().numpy(),
            "sharded_norms": n2.double().cpu().numpy()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("grid_size", nargs="?", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.grid_size, device=args.device)
