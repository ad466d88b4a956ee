# %% [markdown]
# # Introduction: solving advection with AIR reduction multigrid, on a GPU
#
# Classical multigrid fails on strongly asymmetric systems -- advection,
# streaming, space-time problems.  PCAIR builds a *reduction* multigrid with
# an Approximate Ideal Restriction: the restrictor annihilates the
# fine-grid influence exactly in the ideal limit, so iteration counts stay
# flat as the problem grows (the PyTorch twin of
# notebooks/01_intro_pcair.py, tutorial counterpart of the reference's
# notebooks/).
#
# This walkthrough builds each hierarchy on the host and solves on an
# NVIDIA GPU in float64.  Set `device = "cpu"` in the parameters cell to
# run it without a card.

# %%
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch

import pflare_tpu_torch as pt

# %% tags=["parameters"]
device = "cuda"          # "cpu" runs each kernel's plain PyTorch version
dtype = torch.float64
n_grid = 100
sizes = (50, 100, 150)

# %%
if torch.device(device).type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device: set device = 'cpu'")
results = {}

# %% [markdown]
# ## The problem: 2D upwinded advection
#
# Pure advection at angle theta = pi/4, Dirichlet inflow on the left/bottom,
# outflow on the top/right.  The matrix is a lower-triangular-ish stencil --
# the classic case where Gauss-Seidel-in-flow-order would work but nothing
# symmetric does.

# %%
A = pt.adv_diff_2d(n_grid)
print(A.shape, A.nnz, "nonzeros")

# %% [markdown]
# ## Unpreconditioned GMRES stagnates

# %%
E = pt.ELL.from_scipy(A, dtype=dtype).to(device)
b = torch.as_tensor(np.random.default_rng(0).standard_normal(A.shape[0]),
                    dtype=dtype, device=device)
res = pt.gmres(E, b, rtol=1e-8, max_it=60)
print("no PC:", res.converged, res.iterations, "its")
results["no_pc"] = (res.converged, res.iterations)

# %% [markdown]
# ## AIRG: iteration counts flat in problem size

# %%
results["airg"] = {}
for n in sizes:
    An = pt.adv_diff_2d(n)
    pc = pt.PCAIR(pt.AIROptions(a_lump=True, a_drop=1e-5,
                                strong_threshold=0.99),
                  dtype=dtype, device=device)
    pc.setup(An)
    bn = np.random.default_rng(0).standard_normal(An.shape[0])
    r = pc.solve(bn, rtol=1e-10, atol=1e-50, side="right")
    s = pc.stats()
    print(f"n={n}^2: {r.iterations} its, grid cx {s['grid_complexity']:.2f}, "
          f"levels {pc.n_levels}")
    results["airg"][n] = (r.iterations, s["grid_complexity"], pc.n_levels)

# %% [markdown]
# ## What the hierarchy looks like

# %%
pc.view()
