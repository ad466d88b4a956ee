# %% [markdown]
# # GMRES polynomial approximate inverses (PCPFLAREINV), on a GPU
#
# A GMRES polynomial q(A) minimises ||b - A q(A) b|| over polynomials of a
# fixed degree: the best one-shot Krylov approximation to A^-1.  Three bases
# trade stability against communication:
#
# - **power**: one QR reduction total (communication-avoiding); stable to
#   ~order 10
# - **arnoldi**: one reduction per order; stable higher
# - **newton**: applied as a product over harmonic-Ritz roots
#   (Leja-ordered, extra roots added for conditioning); stable to order
#   100+, and matrix-free application needs no dot products at all --
#   ideal for a multigrid coarse solve.
#
# The PyTorch twin of notebooks/02_polynomial_inverses.py: the
# coefficients are computed on the host, every application runs on the
# device.  Set `device = "cpu"` in the parameters cell to run it without a
# card.

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
n = 500

# %%
if torch.device(device).type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device: set device = 'cpu'")
results = {}
A = pt.random_diag_dominant(n, 0.02, seed=1)
E = pt.ELL.from_scipy(A, dtype=dtype).to(device)
b = torch.as_tensor(np.random.default_rng(0).standard_normal(n),
                    dtype=dtype, device=device)

# %% [markdown]
# ## Iteration counts vs basis and order
#
# A matrix-free inverse shares the Krylov operator `E` on the device.

# %%
results["mf"] = {}
for t in (pt.InverseType.POWER, pt.InverseType.ARNOLDI, pt.InverseType.NEWTON):
    for order in (2, 6, 12):
        inv = pt.build_inverse(A, t, poly_order=order, matrix_free=True)
        inv = inv.to(device, dtype, mat=E)
        r = pt.gmres(E, b, M=inv.apply, rtol=1e-8, max_it=100)
        print(f"{t.name:8s} order {order:2d}: {r.iterations} its")
        results["mf"][(t.name, order)] = r.iterations

# %% [markdown]
# ## Assembled fixed-sparsity inverses
#
# Assembling q(A) with every power restricted to the sparsity of
# A^`sparsity_order` gives a single-SpMV application at bounded storage --
# the smoother AIRG uses on every level.

# %%
inv = pt.build_inverse(A, pt.InverseType.ARNOLDI, poly_order=6,
                       sparsity_order=1)
print("assembled nnz:", inv.host_csr.nnz, "vs A nnz:", A.nnz)
r = pt.gmres(E, b, M=inv.to(device, dtype).apply, rtol=1e-8, max_it=100)
print("assembled, sparsity 1:", r.iterations, "its")
results["assembled"] = (inv.host_csr.nnz, r.iterations)

# %% [markdown]
# ## Coefficient save/restore
#
# Coefficients can be extracted and re-injected to reproduce a
# preconditioner exactly (e.g. across processes).

# %%
pc = pt.PCPFLAREINV(matrix_free=True, dtype=dtype, device=device)
pc.setup(A)
coeffs = pc.get_poly_coeffs()
print("saved coefficients:", np.round(coeffs, 4))
results["coefficients"] = np.asarray(coeffs)
