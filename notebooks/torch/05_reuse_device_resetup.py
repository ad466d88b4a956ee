# %% [markdown]
# # Reuse: pattern-cached re-setup and the device re-setup, on a GPU
#
# Time-dependent problems re-assemble the same sparsity with new values
# every step.  The reference reuses the CF splitting, the drop patterns
# and the SpGEMM products so re-setup costs a fraction of first-time setup
# (reference: docs/reuse.md).  The PyTorch twin of
# notebooks/05_reuse_device_resetup.py has the same two tiers:
#
# 1. **Host reuse** (`pc.setup(A2, structure="same")`): numeric-only
#    rebuild against stored patterns and plans, then an upload.
# 2. **Device re-setup** (`pc.build_device_resetup()`): the whole numeric
#    re-setup -- submatrices, approximate inverses, Z, R, RAP, coarse
#    drop/lump -- as torch ops on the card, from the new matrix values.
#
# Set `device = "cpu"` in the parameters cell to run it without a card.

# %%
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch

import pflare_tpu_torch as pt
from pflare_tpu_torch.utils.timers import device_sync_read

# %% tags=["parameters"]
device = "cuda"          # "cpu" runs each kernel's plain PyTorch version
dtype = torch.float64
n_grid = 64

# %%
if torch.device(device).type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device: set device = 'cpu'")
results = {}

# %% [markdown]
# ## Setup with reuse enabled

# %%
A = pt.adv_diff_2d(n_grid)
opts = pt.AIROptions(reuse_sparsity=True, reuse_amount=3,
                     reuse_poly_coeffs=True)
pc = pt.PCAIR(opts, dtype=dtype, device=device)
t0 = time.perf_counter()
pc.setup(A)
print(f"first setup: {time.perf_counter()-t0:.3f}s, {pc.n_levels} levels")
results["levels"] = pc.n_levels

# %% [markdown]
# ## Tier 1: host numeric re-setup (same pattern, new values)

# %%
rng = np.random.default_rng(0)
A2 = A.copy()
A2.data = A2.data * (1 + 1e-3 * rng.standard_normal(A2.nnz))
t0 = time.perf_counter()
pc.setup(A2, structure="same")
print(f"host re-setup: {time.perf_counter()-t0:.3f}s")

b = np.ones(A.shape[0])
r = pc.solve(b, rtol=1e-8, max_it=20)
print("solve after host re-setup:", r.iterations, "iterations")
results["host_resetup_iterations"] = r.iterations

# %% [markdown]
# ## Tier 2: device re-setup
#
# The plan is built once on the host: every static map (drop positions,
# product triples, operator layouts) becomes an index tensor on the
# device.  Each later re-setup takes the new matrix values and rebuilds
# the whole device hierarchy with gathers, products and segment sums in a
# fixed order (the card's sums equal the CPU's bit for bit), with no read
# of a device value on the host.

# %%
plan = pc.build_device_resetup()
results["steps"] = []
for step in range(3):
    A_t = A.copy()
    A_t.data = A_t.data * (1 + 0.02 * (step + 1) * rng.standard_normal(A.nnz))
    t0 = time.perf_counter()
    plan.install(pc, A_t)
    device_sync_read(pc.upload().top.data)
    dt = time.perf_counter() - t0
    r = pc.solve(b, rtol=1e-8, max_it=20)
    print(f"step {step}: device re-setup {dt*1e3:.1f} ms "
          f"(first call builds the plan's tables), solve {r.iterations} its")
    results["steps"].append((A_t, r.iterations))

# %% [markdown]
# Freezing (`pc.freeze(True)`) skips re-setup entirely -- the
# `KSPSetReusePreconditioner` analogue.  The card's times for both tiers
# at 512^2 and 2048^2 are in PERF.md (chip_smoke.py phases 11 and 12).

# %% [markdown]
# ## The envelope
#
# The device re-setup plan covers AIRG / lAIR / SAI-lAIR restrictors,
# one-point / ideal / symmetric (P = R^T) transfers, every inverse kind
# (assembled power/Arnoldi/Newton, SAI/ISAI re-solves, matrix-free,
# diagonal, the dense LU coarse inverse), strong-R dropping and
# improve_w/z iterations.  For a FIRST-time setup on the card,
# `pc.setup_device(A)` runs pattern discovery itself on the device (see
# docs/gpu.md).
