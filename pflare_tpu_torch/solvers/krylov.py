"""Restarted GMRES and Richardson, the outer Krylov iterations.

The host-driven solvers of the reference (pflare_tpu/solvers/krylov.py,
the path ``pc.solve(..., eager=True)`` takes there): the operator and the
preconditioner run on the device, while the Hessenberg, the Givens
rotations and every convergence decision live on the host, norms read
back every iteration.  Semantics follow PETSc: left preconditioning
monitors the preconditioned residual, right preconditioning the true
residual; rtol is relative to the (preconditioned) RHS norm.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


def as_operator(A):
    """Accept a matrix container or a callable; return its matvec."""
    if callable(A) and not hasattr(A, "matvec"):
        return A
    return A.matvec


@dataclass
class SolveResult:
    x: object
    iterations: int
    converged: bool
    residual_norms: list = field(default_factory=list)

    @property
    def history(self):
        return np.asarray(self.residual_norms)


# device-to-host reads made by the host-driven solvers (the tests and
# chip_smoke.py count them)
HOST_READS = 0


def _scalar(t) -> float:
    """One counted device-to-host read of a 0-d tensor."""
    global HOST_READS
    HOST_READS += 1
    return float(t)


def _norm(v):
    return _scalar(torch.linalg.norm(v))


def richardson(A, b, x0=None, M=None, rtol=1e-5, atol=1e-50, max_it=1000,
               scale=1.0) -> SolveResult:
    """x_{k+1} = x_k + scale * M(b - A x_k), monitoring the
    unpreconditioned residual norm."""
    matvec = as_operator(A)
    M = M or (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    r0_norm = _norm(r)
    norms = [r0_norm]
    if r0_norm == 0.0:
        return SolveResult(x, 0, True, norms)
    for it in range(1, max_it + 1):
        x = x + scale * M(r)
        r = b - matvec(x)
        rn = _norm(r)
        norms.append(rn)
        if rn <= max(rtol * r0_norm, atol):
            return SolveResult(x, it, True, norms)
    return SolveResult(x, max_it, False, norms)


def _mgs(V, w, H, j):
    """Modified Gram-Schmidt of w against V[0..j] writing H[:, j], with
    DGKS-style selective reorthogonalization: when the orthogonalization
    cancels most of w (fast-converging preconditioned GMRES does this
    within a handful of iterations), the remainder is dominated by
    rounding noise and the Krylov basis silently degenerates -- the
    residual estimate plateaus while the true residual drifts up.  A
    second pass restores orthogonality (PETSc: KSPGMRESSetCGSRefinementType
    ifneeded; the reference relies on PETSc's GMRES here)."""
    wnorm0 = _norm(w)
    for i in range(j + 1):
        hij = _scalar(torch.dot(V[i], w))
        H[i, j] = hij
        w = w - hij * V[i]
    hj1 = _norm(w)
    if hj1 < 0.5 * wnorm0 and wnorm0 > 0.0:
        for i in range(j + 1):
            c = _scalar(torch.dot(V[i], w))
            H[i, j] += c
            w = w - c * V[i]
        hj1 = _norm(w)
    return w, hj1


def _givens_step(H, cs, sn, g, j):
    """Apply the stored Givens rotations to column j of H, compute the new
    rotation eliminating H[j+1, j], and update the residual vector g
    in place.  Returns |g[j+1]| -- the LS residual after j+1 steps.
    O(j) per iteration (PETSc's KSPGMRES update; replaces the previous
    full lstsq per iteration, which re-solved an O(m^3) problem)."""
    for i in range(j):
        t = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
        H[i + 1, j] = -sn[i] * H[i, j] + cs[i] * H[i + 1, j]
        H[i, j] = t
    a, bb = H[j, j], H[j + 1, j]
    rho = np.hypot(a, bb)
    if rho == 0.0:
        # exact breakdown: the new column adds nothing to the range, so
        # the LS residual stays at its pre-step value -- reporting the
        # rotated g[j+1]=0 would falsely signal inner convergence
        cs[j], sn[j] = 1.0, 0.0
        return abs(float(g[j]))
    cs[j], sn[j] = a / rho, bb / rho
    H[j, j] = cs[j] * a + sn[j] * bb
    H[j + 1, j] = 0.0
    g[j + 1] = -sn[j] * g[j]
    g[j] = cs[j] * g[j]
    return abs(float(g[j + 1]))


def _givens_solve(H, g, m):
    """Back-substitute the rotated (upper-triangular) H for y."""
    y = np.zeros(m)
    for i in range(m - 1, -1, -1):
        s = g[i] - H[i, i + 1 : m] @ y[i + 1 : m]
        y[i] = s / H[i, i] if H[i, i] != 0.0 else 0.0
    return y


def gmres(A, b, x0=None, M=None, side="left", restart=30, rtol=1e-5,
          atol=1e-50, max_it=10000) -> SolveResult:
    """Restarted GMRES with left, right or flexible preconditioning
    (PETSc-style defaults).

    ``M`` applies the (approximate) inverse preconditioner.  Arnoldi uses
    modified Gram-Schmidt; the small least-squares problem is maintained
    incrementally with Givens rotations (O(m) per iteration).
    ``side="flexible"`` is right preconditioning that keeps each
    direction M(v_j) and sums those at the update, so M may change from
    one iteration to the next (FGMRES).
    """
    if side not in ("left", "right", "flexible"):
        raise ValueError(f"unknown side {side!r}")
    matvec = as_operator(A)
    M = M or (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0

    def residual(x):
        r = b - matvec(x)
        return M(r) if side == "left" else r

    r = residual(x)
    r0_norm = _norm(r)
    if side == "left":
        b0 = M(b)
        rhs_norm = _norm(b0)
    else:
        rhs_norm = _norm(b)
    if rhs_norm == 0.0:
        # FGMRES measures a zero RHS against 1, as the reference does
        rhs_norm = r0_norm if r0_norm > 0 and side != "flexible" else 1.0
    tol = max(rtol * rhs_norm, atol)
    norms = [r0_norm]
    if r0_norm <= tol:
        return SolveResult(x, 0, True, norms)

    total_it = 0
    while total_it < max_it:
        # start a cycle
        r = residual(x)
        beta = _norm(r)
        if beta <= tol:
            return SolveResult(x, total_it, True, norms)
        V = [r / beta]
        Z = []      # the flexible directions M(v_j)
        H = np.zeros((restart + 1, restart))
        cs = np.zeros(restart)
        sn = np.zeros(restart)
        g = np.zeros(restart + 1)
        g[0] = beta
        m_used = 0
        for j in range(restart):
            if total_it >= max_it:
                break
            v = V[j]
            if side == "left":
                w = M(matvec(v))
            elif side == "right":
                w = matvec(M(v))
            else:
                Z.append(M(v))
                w = matvec(Z[-1])
            w, hj1 = _mgs(V, w, H, j)
            H[j + 1, j] = hj1
            m_used = j + 1
            total_it += 1
            res_norm = _givens_step(H, cs, sn, g, j)
            norms.append(res_norm)
            if res_norm <= tol or hj1 < 1e-30:
                break
            V.append(w / hj1)
        # update x
        if m_used > 0:
            y = _givens_solve(H, g, m_used)
            basis = Z if side == "flexible" else V
            update = basis[0] * float(y[0])
            for i in range(1, m_used):
                update = update + basis[i] * float(y[i])
            if side == "right":
                update = M(update)
            x = x + update
        r = residual(x)
        rn = _norm(r)
        norms[-1] = rn
        if rn <= tol:
            return SolveResult(x, total_it, True, norms)
    return SolveResult(x, total_it, False, norms)


def fgmres(A, b, x0=None, M=None, restart=30, rtol=1e-5, atol=1e-50,
           max_it=10000) -> SolveResult:
    """Restarted flexible GMRES: ``gmres`` with ``side="flexible"``."""
    return gmres(A, b, x0=x0, M=M, side="flexible", restart=restart,
                 rtol=rtol, atol=atol, max_it=max_it)
