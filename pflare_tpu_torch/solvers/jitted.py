"""Device-resident solvers.

The reference traces these into one XLA program
(pflare_tpu/solvers/jitted.py).  Here ``richardson_fixed``,
``fgmres_fixed`` and ``gmres_right_fixed`` run a fixed number of
iterations whose every step only enqueues device work (residual norms
stay on the device until the caller reads them), so that on a card
``PCAIR(jit=True)`` captures each whole solve into one CUDA graph
(utils/graphs.py); elsewhere they run as Python loops.
``gmres_stationary`` is restarted GMRES with early exit: it reads one
Hessenberg column back an Arnoldi step, the one host round trip a
convergence test needs, and takes its operator and residual applications
as programs of the caller's (``program``).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import torch

# device-to-host reads made by gmres_stationary (the tests and chip_smoke.py
# count them)
HOST_READS = 0


def _read(t) -> np.ndarray:
    """One counted device-to-host read."""
    global HOST_READS
    HOST_READS += 1
    return t.cpu().numpy()


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
    preconditioned GMRES cancels most of w within a few iterations).

    The small least-squares problems (the reference's ``lstsq``) are
    solved by Givens rotations applied to each new Hessenberg column as it
    comes, as PETSc's GMRES does, in tensor operations with no host read,
    so that the solve captures into one CUDA graph.  A column with an exact
    breakdown (nothing left to rotate) keeps the identity rotation: its
    component of the rotated right-hand side stays in the residual
    estimate, and its entry of the solution is 0 (``gmres_stationary``'s
    guard)."""
    dtype, device = b.dtype, b.device
    x = torch.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x) if x0 is not None else b
    beta = torch.linalg.norm(r0)
    one = torch.ones((), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    V = [r0 / torch.where(beta > 0, beta, one)]
    Z = []
    m = max_it
    H = torch.zeros((m + 1, m), dtype=dtype, device=device)
    Rt = torch.zeros((m, m), dtype=dtype, device=device)   # rotated H
    cs, sn = [], []
    g = [beta]             # the rotated right-hand side, entry by entry
    lost = zero            # its part in the rows of broken-down columns
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
        col = list(H[: j + 2, j].unbind())
        for i in range(j):     # the stored rotations
            a, bb = col[i], col[i + 1]
            col[i] = cs[i] * a + sn[i] * bb
            col[i + 1] = -sn[i] * a + cs[i] * bb
        a, bb = col[j], col[j + 1]
        rho = torch.hypot(a, bb)
        live = rho > 0
        safe = torch.where(live, rho, one)
        cs.append(torch.where(live, a / safe, one))
        sn.append(torch.where(live, bb / safe, zero))
        col[j] = cs[j] * a + sn[j] * bb
        Rt[: j + 1, j] = torch.stack(col[: j + 1])
        gj = g[j]
        g[j] = cs[j] * gj
        g.append(-sn[j] * gj)
        lost = torch.where(live, lost, torch.hypot(lost, gj))
        norms.append(torch.hypot(lost, g[j + 1]))
    # the solution of the triangular system, broken-down columns patched
    # to a unit diagonal and a zero right-hand side
    diag = Rt.diagonal()
    alive = diag != 0
    Rt = Rt + torch.diag(torch.where(alive, zero, one))
    rhs = torch.where(alive, torch.stack(g[:m]), zero)
    y = torch.linalg.solve_triangular(Rt, rhs[:, None], upper=True)[:, 0]
    update = torch.zeros_like(b)
    for i in range(m):
        update = update + y[i] * Z[i]
    return x + update, torch.stack(norms)


def gmres_right_fixed(matvec, precond, b, max_it: int, x0=None):
    """Right-preconditioned GMRES, fixed iterations, on the device: with a
    fixed preconditioner right GMRES is FGMRES."""
    return fgmres_fixed(matvec, precond, b, max_it, x0=x0)


def gmres_stationary(matvec, precond, b, x0, rtol, atol, max_it: int,
                     restart: int, side: str = "left", program=None):
    """Restarted GMRES(``restart``) with a stationary preconditioner, the
    reference's default solver (pflare_tpu/solvers/jitted.py:76-207).

    Arnoldi orthogonalises by blocked two-pass classical Gram-Schmidt
    against the basis built so far, the first j + 1 rows of a
    preallocated ``[restart + 1, n]`` tensor (``h = V @ w; w -= h @ V``,
    twice): two matrix-vector products a pass instead of one dot a basis
    vector.  (The reference multiplies by all rows, the unused ones zero;
    the sums are the same.)  Each step reads the new Hessenberg column
    and ``||w||`` back in one tensor; the incremental Givens rotations
    (with the reference's guard for an exact breakdown) and the
    convergence test run on the host in the solve's dtype.  The inner
    loop stops at the restart, at
    ``max_it`` or once the rotated residual is <= tol; each cycle ends
    with the true (right) or preconditioned (left) residual norm, which
    overwrites its last estimate.  ``rtol`` is relative to the
    (preconditioned) RHS norm, falling back to ||r0|| and then 1 for a
    zero RHS.  The residual that ends one cycle starts the next, so a
    solve makes iterations + cycles + 1 host reads.

    ``program(fn, name)`` turns each of the three device programs of a
    step into the callable the solve runs: "op" (the preconditioned
    operator), "resid" (x, b -> the residual the method monitors) and
    "precond"; ``PCAIR(jit=True)`` gives each a CUDA graph, the default
    runs them as they are.

    Returns (x, total_it, hist, converged): hist[k] is the residual norm
    after k iterations (max_it + 1 entries, zero beyond total_it)."""
    if side not in ("left", "right"):
        raise ValueError(f"unknown side {side!r}")
    m = restart
    dtype, device = b.dtype, b.device
    npdt = torch.empty(0, dtype=dtype).numpy().dtype
    one = torch.ones((), dtype=dtype, device=device)
    if program is None:
        def program(fn, name):
            return fn

    def _op(v):
        return precond(matvec(v)) if side == "left" else matvec(precond(v))

    def _resid(x, b):
        r = b - matvec(x)
        return precond(r) if side == "left" else r

    op, resid = program(_op, "op"), program(_resid, "resid")
    pre = program(precond, "precond")
    b_eff = pre(b) if side == "left" else b
    x = torch.zeros_like(b) if x0 is None else x0
    r = resid(x, b)
    rn_t = torch.linalg.norm(r)
    rhs_norm, rn = _read(torch.stack([torch.linalg.norm(b_eff), rn_t]))
    if not rhs_norm > 0:
        rhs_norm = rn if rn > 0 else npdt.type(1.0)
    tol = max(npdt.type(rtol) * rhs_norm, npdt.type(atol))
    hist = np.zeros(max_it + 1, dtype=npdt)
    hist[0] = rn
    V = torch.empty((m + 1, b.shape[0]), dtype=dtype, device=device)
    diag = np.arange(m)
    tot = 0
    done = rn <= tol
    while not done and tot < max_it:
        V[0] = r / torch.where(rn_t > 0, rn_t, one)
        H = np.zeros((m + 1, m), dtype=npdt)
        cs = np.zeros(m, dtype=npdt)
        sn = np.zeros(m, dtype=npdt)
        g = np.zeros(m + 1, dtype=npdt)
        g[0] = res = rn
        j = 0
        while j < m and tot + j < max_it and res > tol:
            w = op(V[j])
            Vj = V[: j + 1]
            h1 = torch.mv(Vj, w)
            w = w - torch.mv(Vj.T, h1)
            h2 = torch.mv(Vj, w)
            w = w - torch.mv(Vj.T, h2)
            hj1 = torch.linalg.norm(w)
            V[j + 1] = w / torch.where(hj1 > 0, hj1, one)
            hcol = np.zeros(m + 1, dtype=npdt)
            hcol[: j + 2] = _read(torch.cat([h1 + h2, hj1[None]]))
            for i in range(j):     # the stored rotations
                hi, hi1 = hcol[i], hcol[i + 1]
                hcol[i] = cs[i] * hi + sn[i] * hi1
                hcol[i + 1] = -sn[i] * hi + cs[i] * hi1
            a, bb = hcol[j], hcol[j + 1]
            rho = np.hypot(a, bb)
            gj = g[j]
            if rho > 0:
                cs[j], sn[j] = a / rho, bb / rho
                hcol[j] = cs[j] * a + sn[j] * bb
                g[j + 1] = -sn[j] * gj
                g[j] = cs[j] * gj
                res = abs(g[j + 1])
            else:
                # exact breakdown: the column adds nothing, and the residual
                # stays at its value before the step
                cs[j], sn[j] = 1, 0
                res = abs(gj)
            hcol[j + 1] = 0
            H[:, j] = hcol
            hist[tot + j + 1] = res
            j += 1
        # back-substitution: the diagonal of unused and breakdown columns
        # is patched to 1 and their g entry to 0, so y there is 0
        Hs = H[:m, :m]
        alive = (diag < j) & (np.abs(Hs[diag, diag]) > 0)
        Hs[diag, diag] = np.where(alive, Hs[diag, diag], 1)
        y = sla.solve_triangular(Hs, np.where(alive, g[:m], 0), lower=False)
        update = torch.mv(V[:j].T, torch.as_tensor(y[:j], dtype=dtype,
                                                   device=device))
        x = x + (pre(update) if side == "right" else update)
        tot += j
        r = resid(x, b)
        rn_t = torch.linalg.norm(r)
        rn = _read(rn_t)[()]
        hist[tot] = rn
        done = rn <= tol
    return x, tot, hist, bool(done)
