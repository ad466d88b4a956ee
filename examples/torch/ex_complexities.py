"""Hierarchy statistics on the GPU: the PyTorch twin of
examples/ex_complexities.py (counterpart of
python/ex_pcair_complexities.py; reference: src/AIR_MG_Stats.F90): grid,
operator, cycle and storage complexities, the quantities the reference
prints under -pc_air_print_stats_timings and asserts in CI (grid
complexity < 3.0, python/run_parse_tests.py).

The statistics read the host hierarchy; ``device`` and ``dtype`` are
those of each PCAIR's solve.

Run: python examples/torch/ex_complexities.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import torch

import pflare_tpu_torch as pt


def main(device="cuda", dtype=torch.float64):
    """Three option sets at 64^2, the 8^2 CI case and a view; returns the
    printed statistics."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run with --device cpu")
    out = {"sets": {}}
    for label, opts in {
        "defaults": pt.AIROptions(),
        "lump + drop": pt.AIROptions(a_lump=True, a_drop=1e-4),
        "matrix-free smoothing": pt.AIROptions(matrix_free_polys=True),
    }.items():
        pc = pt.PCAIR(opts, dtype=dtype, device=device)
        pc.setup(pt.adv_diff_2d(64))
        s = pc.stats()
        print(f"{label}: levels={s['levels']} "
              f"grid={s['grid_complexity']:.2f} "
              f"op={s['operator_complexity']:.2f} "
              f"cycle={s['cycle_complexity']:.2f} "
              f"storage={s['storage_complexity']:.2f}")
        out["sets"][label] = s

    # the reference's CI assertion runs on small 8x8 advection cases
    # (reference: python/run_parse_tests.py:47,128-133)
    pc8 = pt.PCAIR(pt.AIROptions(), dtype=dtype, device=device)
    pc8.setup(pt.adv_diff_2d(8))
    gc = pc8.stats()["grid_complexity"]
    print(f"\n8x8 CI case: grid complexity {gc:.3f} (< 3.0 asserted)")
    assert gc < 3.0
    out["ci_grid_complexity"] = gc

    # the full view() output (the -pc_air_print_stats_timings analogue)
    print()
    pc.view()
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
