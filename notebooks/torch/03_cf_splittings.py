# %% [markdown]
# # CF splittings: PMISR-DDC and friends, solved on a GPU
#
# AIR's effectiveness hinges on the F/C partition: the F-F block A_ff must
# be cheap to invert approximately.  PMISR picks an *independent set* as the
# F points (so A_ff has no strong off-diagonal couplings) and the DDC second
# pass flips the least diagonally-dominant F rows to C.
#
# The PyTorch twin of notebooks/03_cf_splittings.py: the splittings are
# host work (numpy and the native C++ kernels); the solves that compare
# them run on the device.  Set `device = "cpu"` in the parameters cell to
# run it without a card.

# %%
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch

import pflare_tpu_torch as pt
from pflare_tpu_torch.cf import ddc, pmisr, strength_matrix
from pflare_tpu_torch.sparse import diag_dominance_ratio

# %% tags=["parameters"]
device = "cuda"          # "cpu" runs each kernel's plain PyTorch version
dtype = torch.float64
n_grid = 60

# %%
if torch.device(device).type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device: set device = 'cpu'")
results = {}
A = pt.adv_diff_2d(n_grid, curved_velocity=True)

# %% [markdown]
# ## Strength graph and first-pass PMISR

# %%
S = strength_matrix(A, theta=0.5, symmetrize=True)
cf = pmisr(S, max_luby_steps=-1)
f_mask = cf == pt.F_POINT
print(f"{f_mask.sum()} F / {(~f_mask).sum()} C")
r = diag_dominance_ratio(A, f_mask)
print(f"A_ff dominance ratio: max {r.max():.3f}, mean {r.mean():.3f}")
results["pmisr"] = (int(f_mask.sum()), float(r.max()), float(r.mean()))

# %% [markdown]
# ## DDC cleanup improves A_ff conditioning

# %%
cf2, _ = ddc(A, cf.copy(), fraction_swap=0.1)
r2 = diag_dominance_ratio(A, cf2 == pt.F_POINT)
print(f"after DDC: max {r2.max():.3f}, mean {r2.mean():.3f}")
results["ddc"] = (int((cf2 == pt.F_POINT).sum()), float(r2.max()),
                  float(r2.mean()))

# %% [markdown]
# ## Splitting families compared inside the solver

# %%
b = np.random.default_rng(0).standard_normal(A.shape[0])
results["solves"] = {}
for t in (pt.CFSplittingType.PMISR_DDC, pt.CFSplittingType.PMIS,
          pt.CFSplittingType.PMIS_DIST2, pt.CFSplittingType.AGG):
    pc = pt.PCAIR(pt.AIROptions(cf_splitting_type=t), dtype=dtype,
                  device=device)
    pc.setup(A)
    res = pc.solve(b, rtol=1e-8, max_it=40)
    s = pc.stats()
    print(f"{t.name:12s}: {res.iterations:2d} its, "
          f"grid cx {s['grid_complexity']:.2f}")
    results["solves"][t.name] = (res.iterations, s["grid_complexity"])

# %% [markdown]
# ## Diagonally-dominant submatrix extraction
#
# The standalone `compute_diag_dom_submatrix` repeatedly splits until every
# remaining row is diagonally dominant below the target ratio -- useful for
# building block preconditioners (reference: docs/new_methods.md:136-168).

# %%
sub, idx = pt.compute_diag_dom_submatrix(A, max_dd_ratio=0.6)
rs = diag_dominance_ratio(sub, np.ones(sub.shape[0], dtype=bool))
print(f"{sub.shape[0]} of {A.shape[0]} rows kept, max ratio {rs.max():.3f}")
results["diag_dom"] = (sub.shape[0], float(rs.max()))
