#!/usr/bin/env python3
"""Time the port's host setup of the lAIR fcf hierarchy with and without
strong-R dropping.

    python3 tools/torch_lair_setup.py [--grid 1024] [--thresholds 0.01,0]

The options are those of chip_smoke.py phase 10 (b): the main path's
(a_lump, a_drop 1e-5, strong threshold 0.99, 10 levels, order-24
matrix-free Newton coarse solve) with z_type=LAIR and fcf smoothing, and
``strong_r_threshold`` from the list (0 turns the dropping off).  For
each threshold it sets up adv_diff_2d(grid) in f32 for the CPU and prints
one JSON line: the setup seconds, their ``utils/timers.py`` split, the
upload seconds and the level sizes.  Host work only; needs no card.
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
    ap.add_argument("--grid", type=int, default=1024)
    ap.add_argument("--thresholds", default="0.01,0")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    import pflare_tpu_torch as tpf
    from pflare_tpu_torch.utils.timers import get_timers, reset_timers

    A = tpf.adv_diff_2d(args.grid).astype(np.float32)
    for thr in (float(t) for t in args.thresholds.split(",")):
        opts = tpf.AIROptions(
            a_lump=True, a_drop=1e-5, strong_threshold=0.99, max_levels=10,
            coarsest_inverse_type=tpf.InverseType.NEWTON,
            coarsest_poly_order=24, coarsest_matrix_free_polys=True,
            z_type=tpf.ZType.LAIR,
            strong_r_threshold=thr).with_smooth_type("fcf")
        pc = tpf.PCAIR(opts, dtype=torch.float32, device="cpu")
        reset_timers()
        t0 = time.perf_counter()
        pc.setup(A)
        t_setup = time.perf_counter() - t0
        timers = get_timers()
        t0 = time.perf_counter()
        pc.upload()
        t_upload = time.perf_counter() - t0
        print(json.dumps({
            "grid": args.grid, "strong_r_threshold": thr,
            "setup_s": t_setup, "timers_s": timers, "upload_s": t_upload,
            "levels": [lv.n for lv in pc.hierarchy.levels]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
