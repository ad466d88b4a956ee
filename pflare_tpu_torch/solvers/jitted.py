"""Device-resident solvers: a fixed number of iterations, no host syncs.

The reference traces these into one XLA program
(pflare_tpu/solvers/jitted.py); PyTorch runs eagerly, so here they are
Python loops whose every step only enqueues device work.  Residual norms
stay on the device until the caller reads them.
"""

from __future__ import annotations

import torch


def richardson_fixed(matvec, precond, b, max_it: int, x0=None):
    """``max_it`` preconditioned Richardson iterations with
    unpreconditioned residual norms.  Returns (x, norms[max_it + 1]):
    norms[k] is ||b - A x_k||."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    norms = [torch.linalg.norm(r)]
    for _ in range(max_it):
        x = x + precond(r)
        r = b - matvec(x)
        norms.append(torch.linalg.norm(r))
    return x, torch.stack(norms)


def fgmres_fixed(matvec, precond, b, max_it: int, x0=None):
    """FGMRES(max_it) without restart, on the device.  Returns (x,
    norms[max_it + 1]): norms[k] is the least-squares residual estimate
    after k iterations, and the caller finds the convergence point.  Two
    Gram-Schmidt passes every iteration, unconditionally (a fast-converging
    preconditioned GMRES cancels most of w within a few iterations); the
    small least-squares problems are solved on the device too."""
    dtype, device = b.dtype, b.device
    x = torch.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x) if x0 is not None else b
    beta = torch.linalg.norm(r0)
    one = torch.ones((), dtype=dtype, device=device)
    V = [r0 / torch.where(beta > 0, beta, one)]
    Z = []
    m = max_it
    H = torch.zeros((m + 1, m), dtype=dtype, device=device)
    norms = [beta]
    for j in range(m):
        z = precond(V[j])
        Z.append(z)
        w = matvec(z)
        for _ in range(2):
            for i in range(j + 1):
                h = torch.dot(V[i], w)
                H[i, j] += h
                w = w - h * V[i]
        hj1 = torch.linalg.norm(w)
        H[j + 1, j] = hj1
        V.append(w / torch.where(hj1 > 0, hj1, one))
        g = torch.zeros(j + 2, dtype=dtype, device=device)
        g[0] = beta
        Hj = H[: j + 2, : j + 1]
        y = torch.linalg.lstsq(Hj, g[:, None]).solution[:, 0]
        norms.append(torch.linalg.norm(g - Hj @ y))
    g = torch.zeros(m + 1, dtype=dtype, device=device)
    g[0] = beta
    y = torch.linalg.lstsq(H, g[:, None]).solution[:, 0]
    update = torch.zeros_like(b)
    for i in range(m):
        update = update + y[i] * Z[i]
    return x + update, torch.stack(norms)


def gmres_right_fixed(matvec, precond, b, max_it: int, x0=None):
    """Right-preconditioned GMRES, fixed iterations, on the device: with a
    fixed preconditioner right GMRES is FGMRES."""
    return fgmres_fixed(matvec, precond, b, max_it, x0=x0)
