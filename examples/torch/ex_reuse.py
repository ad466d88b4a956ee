"""Setup reuse across matrix re-assemblies, solved on the GPU: the
PyTorch twin of examples/ex_reuse.py (counterpart of
tests/reuse_preconditioner.c + docs/reuse.md).  The re-setup runs on the
host on the stored CF splitting and patterns; each solve uploads the
hierarchy it was given.

Run: python examples/torch/ex_reuse.py [--device cpu]
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


def main(device="cuda", dtype=torch.float64):
    """First setup, same-pattern re-setup and a frozen setup; returns the
    printed times and iterations."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run with --device cpu")
    A = pt.adv_diff_2d(100)
    b = np.random.default_rng(0).standard_normal(A.shape[0])

    pc = pt.PCAIR(pt.AIROptions(reuse_sparsity=True), dtype=dtype,
                  device=device)
    t0 = time.perf_counter()
    pc.setup(A)
    t_full = time.perf_counter() - t0
    its0 = pc.solve(b, rtol=1e-8).iterations

    # "time step": same pattern, perturbed values
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 0.01 * np.sin(np.arange(A2.nnz)))
    t0 = time.perf_counter()
    pc.setup(A2, structure="same")
    t_reuse = time.perf_counter() - t0
    its1 = pc.solve(b, rtol=1e-8).iterations

    print(f"full setup   {t_full:.3f}s, solve {its0} its")
    print(f"reuse setup  {t_reuse:.3f}s ({t_full / t_reuse:.1f}x faster), "
          f"solve {its1} its")

    # freeze semantics: no re-setup at all
    pc.freeze(True)
    t0 = time.perf_counter()
    pc.setup(A2)
    t_frozen = time.perf_counter() - t0
    print(f"frozen setup {t_frozen:.6f}s (no-op)")
    return {"full_setup_s": t_full, "reuse_setup_s": t_reuse,
            "frozen_setup_s": t_frozen, "iterations": its0,
            "iterations_reuse": its1}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
