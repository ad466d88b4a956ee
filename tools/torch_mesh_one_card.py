#!/usr/bin/env python3
"""The 4-shard 2048^2 f32 solve of ``chip_smoke.py`` phase 15 (b) on one
card, graphed and eager, for the package of a given tree, so that two
trees can be compared in one call on one card.

    python3 tools/torch_mesh_one_card.py [--root DIR] [--reps 7]
                                         [--out FILE]

``--root``: the tree whose ``pflare_tpu_torch`` is imported (default:
this checkout); the options come from this checkout's
``chip_smoke.bench_options``.  Sets up phase 7's 2048^2 f32 hierarchy,
shards it on ``make_mesh(4)`` (every shard on the card) and runs 10
Richardson iterations of ``solve_device``: for each mode, one warm solve,
then ``--reps`` timed to completion (wall by ``time.perf_counter``
around the solve and its read), then one under torch.profiler
(``chip_smoke.profiled``: wall and device busy time).  Checks that the
graphed x equals the eager x bit for bit and prints the DIA and banded
launches an iteration of each mode.  Prints the card's name and power
limit and, last, one JSON line of the numbers, also written to
``--out`` where given.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="the tree whose pflare_tpu_torch is imported")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out", help="a JSON file for the numbers")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import pflare_tpu_torch as tpf
    from pflare_tpu_torch import cuda
    from pflare_tpu_torch.parallel import make_mesh
    from pflare_tpu_torch.sparse import banded as tbanded
    from pflare_tpu_torch.sparse import dia as tdia
    from pflare_tpu_torch.utils.timers import device_sync_read

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    if not os.path.abspath(tpf.__file__).startswith(root + os.sep):
        raise SystemExit(f"imported {tpf.__file__}, not from {root}")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"# {card}; tree {root}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"# kernels built in {cuda.build_all():.3f} s", flush=True)
    dev = torch.device("cuda", 0)
    A2k = tpf.adv_diff_2d(2048)
    pc = tpf.PCAIR(smoke.bench_options(tpf, max_levels=10),
                   dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    pc.setup(A2k.astype(np.float32))
    pc.upload()
    torch.cuda.synchronize()
    print(f"# 2048^2 f32 setup and upload {time.perf_counter() - t0:.3f} s",
          flush=True)
    b = np.random.default_rng(1).standard_normal(A2k.shape[0])
    mesh = make_mesh(4)

    def run():
        return pc.solve_device(b, max_it=10, ksp="richardson", mesh=mesh)

    out = {"card": card, "root": root, "reps": args.reps}
    xs = {}
    for mode, jit in (("graphs", True), ("eager", False)):
        pc.jit = jit
        device_sync_read(*run())
        walls = []
        for _ in range(args.reps):
            for mod in (tdia, tbanded):
                mod.KERNEL_LAUNCHES = 0
            t0 = time.perf_counter()
            x, norms = run()
            device_sync_read(x, norms)
            walls.append(time.perf_counter() - t0)
        launches = {k: m.KERNEL_LAUNCHES / 10 for k, m in
                    (("dia", tdia), ("banded", tbanded))}
        xs[mode] = x
        prof = smoke.profiled(torch, run, f"4 shards on one card ({mode})")
        out[mode] = {"wall_ms": [w * 1e3 for w in walls],
                     "median_wall_ms": statistics.median(walls) * 1e3,
                     "launches_per_iteration": launches,
                     "profiled_wall_ms": prof["wall_s"] * 1e3,
                     "busy_ms": prof["busy_ms"]}
        print(f"# {mode}: wall to completion median "
              f"{out[mode]['median_wall_ms']:.3f} ms of {args.reps} ("
              + ", ".join(f"{w * 1e3:.3f}" for w in walls)
              + f"), profiled {prof['wall_s'] * 1e3:.3f} ms, busy "
              f"{prof['busy_ms']:.3f} ms; launches an iteration {launches}",
              flush=True)
    pc.jit = True
    out["graph_x_equals_eager"] = bool(torch.equal(xs["graphs"],
                                                   xs["eager"]))
    print(f"# graphed x bit for bit the eager x: "
          f"{out['graph_x_equals_eager']}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    if not out["graph_x_equals_eager"]:
        raise SystemExit("the graphed x differs from the eager x")


if __name__ == "__main__":
    main()
