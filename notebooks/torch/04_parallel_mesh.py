# %% [markdown]
# # Row meshes on a GPU: sharded SpMV, halo exchange, distributed TSQR
#
# The reference parallelises by distributing matrix rows over MPI ranks
# with PetscSF halo exchanges and a custom-reduction TSQR (tutorial
# counterpart of the reference's notebooks/; design map in SURVEY.md §2.4).
# The PyTorch twin of notebooks/04_parallel_mesh.py keeps that
# decomposition as a *row mesh*: `make_mesh(8)` cuts the rows into 8
# blocks ("shards"), one `torch.device` each, here all 8 on `cuda:0`;
# `make_mesh(8, devices=[...])` spreads them over several cards in
# contiguous runs, each card holding its own shards' blocks.  Every
# exchange between shards -- the halo slabs of a banded partition, the
# all-gather of a vector, the R factors of a TSQR -- is a copy (between
# cards a peer copy), counted in the mesh's log (`mesh.log`; the bytes
# between cards under `"peer"`), where the TPU version has `ppermute`
# shifts and `psum`s over ICI.
#
# Set `device = "cpu"` in the parameters cell to run it without a card.

# %%
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch

import pflare_tpu_torch as pt
from pflare_tpu_torch.parallel import (HaloSpMV, make_mesh, shard_ell,
                                       shard_hierarchy, shard_vec, tsqr_r)

# %% tags=["parameters"]
device = "cuda"          # "cpu" runs each kernel's plain PyTorch version
dtype = torch.float64
n_grid = 64

# %%
if torch.device(device).type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device: set device = 'cpu'")
results = {}
mesh = make_mesh(8, device=device)
print("shards:", mesh.size, "on", mesh.device)

# %% [markdown]
# ## A row-sharded operator
#
# `shard_ell` cuts the ELL operator into one row block per shard; each
# block multiplies the all-gathered vector (the GSPMD path's analogue).

# %%
A = pt.adv_diff_2d(n_grid)
E = shard_ell(pt.ELL.from_scipy(A, dtype=dtype).to(device), mesh)
x = shard_vec(torch.ones(A.shape[0], dtype=dtype), mesh)
y = E.matvec(x)
ok = bool(np.allclose(y[: A.shape[0]].cpu().numpy(), A @ np.ones(A.shape[0])))
print("sharded SpMV matches scipy:", ok)
results["sharded_spmv_matches"] = ok

# %% [markdown]
# ## Halo exchange
#
# For banded partitions (structured levels, RCM-ordered meshes) the
# reference's PetscSF neighbour exchange becomes two copies per shard: each
# shard receives one slab from each neighbour and multiplies with locally
# rewritten column indices.  No all-gather.

# %%
h = HaloSpMV(A, mesh)
xr = np.random.default_rng(0).standard_normal(A.shape[0])
err = float(np.abs((h @ xr).cpu().numpy() - A @ xr).max())
print("halo SpMV max err:", err)
print("exchanges:", mesh.traffic(h.op.label))
results["halo_max_err"] = err

# %% [markdown]
# ## Distributed TSQR
#
# The power-basis GMRES coefficients need one tall-skinny QR of the Krylov
# block.  The reference reduces per-rank R factors with a deliberately
# non-commutative MPI op for bitwise reproducibility; here each shard QRs
# its rows and the small R factors are combined in shard order
# (deterministic).

# %%
K = torch.as_tensor(np.random.default_rng(1).standard_normal((1024, 8)),
                    device=device)
R = tsqr_r(K, mesh)
R_ref = np.linalg.qr(K.cpu().numpy(), mode="r")
# R is unique up to row signs
same = bool(np.allclose(np.abs(R.cpu().numpy()), np.abs(R_ref), atol=1e-10))
print("TSQR |R| matches:", same)
results["tsqr_matches"] = same

# %% [markdown]
# ## A sharded hierarchy
#
# `shard_hierarchy` places every level's operators on the mesh; levels
# smaller than `process_eq_limit * n_shards` keep fewer active shards (the
# reference's processor agglomeration).  The V-cycle then runs on the
# sharded levels end to end.

# %%
pc = pt.PCAIR(pt.AIROptions(max_levels=4), dtype=dtype, device=device)
pc.setup(A)
levels, coarse_inv, schedule = shard_hierarchy(pc.hierarchy, mesh,
                                               dtype=dtype)
from pflare_tpu_torch.air.smooth import vcycle_kaskade

b = shard_vec(torch.ones(A.shape[0], dtype=dtype), mesh)
z = vcycle_kaskade(levels, coarse_inv, b, (2,))
print("active shards per level:", schedule)
print("sharded V-cycle output norm:", float(torch.linalg.norm(z)))
results["vcycle_norm"] = float(torch.linalg.norm(z))
results["schedule"] = list(schedule)
