"""GMRES polynomial coefficients (power & Arnoldi bases) + the Horner applier.

Reference: src/Gmres_Poly.F90.  The coefficients are a setup-phase product
computed on the host in numpy: the Krylov basis is built with scipy
matvecs, and the tiny dense factorisations (QR of the tall-skinny power
basis, Hessenberg least squares) run in float64 -- O(order^2) scalars,
exactly the work the reference does in LAPACK.  The device first setup
(air/device_setup.py) builds the basis with device matvecs instead:
``arnoldi_fixed_device`` runs the whole Arnoldi on the device and reads
back the Hessenberg once, and ``coefficients_power`` takes a QR reduce
that factors the power basis there; the coefficient solves stay on the
host.  Only ``horner`` runs in the solve, on torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import tolerances


def box_muller(n: int, dtype=np.float64, seed: int = 17) -> np.ndarray:
    """Normal random RHS via Box-Muller, deterministic seed (reference:
    src/Gmres_Poly.F90:139-209: N(0,1) preserves white noise in the
    eigenspace).  Follows the matrix precision: an f64 start vector
    against an f32 matrix makes scipy upcast the matrix data on every
    matvec."""
    rng = np.random.default_rng(seed)
    u1 = rng.random(n)
    u2 = rng.random(n)
    z = np.sqrt(-2.0 * np.log1p(-u1)) * np.cos(2.0 * np.pi * u2)
    return z.astype(np.float64 if dtype is None else np.dtype(dtype))


def arnoldi_host(matvec, n, poly_order, dtype, lucky_tol, compute_cn=False,
                 rel_tol=None, seed: int = 17):
    """Plain Arnoldi storing the unrotated H (and optionally C_n with
    V_n = K_n C_n) -- reference: src/Gmres_Poly.F90:308-456.

    Returns (beta, H, m, C, y): H is (order+2, order+1) numpy; m is the
    numerically reached order; C maps Krylov to Arnoldi coordinates; y the
    LS solution when rel_tol is active.
    """
    subspace = poly_order + 1
    r0 = box_muller(n, dtype, seed)
    beta = float(np.linalg.norm(r0))
    # preallocated basis in the MATRIX precision (each V[: j + 1] below is
    # a view); the Hessenberg/LS stay float64
    V = np.empty((subspace + 1, n), dtype=r0.dtype)
    V[0] = r0 / beta
    H = np.zeros((subspace + 1, subspace))
    C = np.zeros((subspace + 1, subspace + 1)) if compute_cn else None
    if compute_cn:
        C[0, 0] = 1.0 / beta
    y = np.zeros(subspace)
    m = 0
    for j in range(subspace):
        w = matvec(V[j])
        if compute_cn:
            c_j = np.zeros(subspace + 1)
            c_j[1 : j + 2] = C[: j + 1, j]
        # all Hessenberg entries in one batched dot (one reduction)
        Vstack = V[: j + 1]
        h = np.asarray(Vstack @ w)
        H[: j + 1, j] = h
        w = w - np.tensordot(h.astype(w.dtype), Vstack, axes=1)
        if compute_cn:
            for i in range(j + 1):
                c_j[: i + 1] -= C[: i + 1, i] * H[i, j]
        hj1 = float(np.linalg.norm(w))
        H[j + 1, j] = hj1
        m = j + 1
        if hj1 < lucky_tol:
            if rel_tol is not None:
                y = _ls_solve_arnoldi(beta, m, H)
            break
        V[j + 1] = w / hj1
        if compute_cn:
            C[: j + 2, j + 1] = c_j[: j + 2] / hj1
        if rel_tol is not None:
            y = _ls_solve_arnoldi(beta, m, H)
            res = np.linalg.norm(H[: m + 1, :m] @ y[:m] - beta * np.eye(m + 1)[:, 0])
            if res / beta < rel_tol:
                break
    return beta, H, m, C, y


def _ls_solve_arnoldi(beta, m, H):
    g0 = np.zeros(m + 1)
    g0[0] = beta
    y_m, *_ = np.linalg.lstsq(H[: m + 1, :m], g0, rcond=None)
    y = np.zeros(H.shape[1])
    y[:m] = y_m
    return y


def coefficients_arnoldi(matvec, n, poly_order, dtype=np.float64,
                         seed: int = 17) -> np.ndarray:
    """Arnoldi-basis polynomial coefficients per Nachtigal et al. 1992
    (reference: src/Gmres_Poly.F90:460-548): coeffs = C_n[1:m,1:m] @ y."""
    tol = tolerances(dtype)
    beta, H, m, C, y = arnoldi_host(
        matvec, n, poly_order, dtype, tol.lucky, compute_cn=True,
        rel_tol=tol.arnoldi, seed=seed,
    )
    coeffs = np.zeros(poly_order + 1)
    coeffs[:] = (C[: poly_order + 1, : poly_order + 1] @ y[: poly_order + 1])[
        : poly_order + 1
    ]
    return coeffs


def coefficients_power(matvec, n, poly_order, dtype=np.float64,
                       seed: int = 17, start=None,
                       qr_reduce=None) -> np.ndarray:
    """Power-basis coefficients with a single QR (reference:
    src/Gmres_Poly.F90:552-776): build K_{m+1} = [b, Ab, ..., A^m b] and
    solve min || beta e1 - R[:,1:] g || with a rank-revealing lstsq (the
    power basis may be rank deficient).  The device path passes ``start``
    (b as a device tensor) and ``qr_reduce``, which takes the list of
    basis columns and returns R (the reference's TSQR slot,
    pflare_tpu/inverse/gmres_poly.py:236-291); by default K is factored
    on the host in float64."""
    subspace = poly_order + 1
    b = box_muller(n, dtype, seed) if start is None else start
    cols = [b]
    for _ in range(subspace):
        cols.append(matvec(cols[-1]))
    if qr_reduce is None:
        K = np.stack(cols, axis=1)  # [n, subspace+1]
        R = np.linalg.qr(np.asarray(K, dtype=np.float64), mode="r")
    else:
        R = np.asarray(qr_reduce(cols), dtype=np.float64)
    # R has min(n, subspace+1) rows: tiny matrices (order clamped to n-1)
    # give a wide K whose R is n x (subspace+1)
    g0 = np.zeros(R.shape[0])
    g0[0] = R[0, 0]
    g, *_ = np.linalg.lstsq(R[:, 1:], g0, rcond=tolerances(dtype).rcond)
    out = np.zeros(subspace)
    out[: len(g)] = g[:subspace]
    return out


def qr_r_device(cols) -> np.ndarray:
    """R of the QR of the basis columns stacked on their device, in their
    dtype (the device ``qr_reduce`` of ``coefficients_power``); only R
    crosses to the host."""
    return torch.linalg.qr(torch.stack(cols, dim=1), mode="r")[1].cpu(
    ).numpy()


def arnoldi_fixed_device(mv, r0, subspace: int):
    """The whole Arnoldi on the device at a fixed shape (the device setup
    path, pflare_tpu/inverse/gmres_poly.py:115-176): V is a preallocated
    [subspace+1, n] basis and each step a masked modified Gram-Schmidt
    update; a lucky breakdown scales by zero, which reproduces
    H[j+1, j] ~ 0 for the host's coefficient solves.  ``mv``: the
    operator's product (with any diagonal scaling applied).  Returns
    (beta, H) as host float64, read back once."""
    n = r0.shape[0]
    beta = torch.linalg.vector_norm(r0)
    V = r0.new_zeros((subspace + 1, n))
    V[0] = r0 / beta
    H = r0.new_zeros((subspace + 1, subspace))
    rows = torch.arange(subspace + 1, device=r0.device)
    for j in range(subspace):
        w = mv(V[j])
        h = torch.where(rows <= j, V @ w, 0.0)
        w = w - h @ V
        hj1 = torch.linalg.vector_norm(w)
        H[:, j] = h
        H[j + 1, j] = hj1
        scale = torch.where(hj1 > 0, 1.0 / torch.where(hj1 > 0, hj1, 1.0),
                            0.0)
        V[j + 1] = w * scale
    packed = torch.cat([beta.reshape(1), H.reshape(-1)]).cpu().numpy(
    ).astype(np.float64)
    return float(packed[0]), packed[1:].reshape(subspace + 1, subspace)


def reached_order(H, subspace, lucky_tol) -> int:
    """The numerically reached Arnoldi order: the first j with H[j+1, j]
    below the lucky-breakdown tolerance (else the full subspace)."""
    for j in range(subspace):
        if H[j + 1, j] < lucky_tol:
            return j + 1
    return subspace


def cn_from_h(beta, H, subspace) -> np.ndarray:
    """The Krylov-to-Arnoldi map C_n (V_n = K_n C_n) from the Hessenberg
    alone: the recurrence of ``arnoldi_host`` replayed on the host."""
    C = np.zeros((subspace + 1, subspace + 1))
    C[0, 0] = 1.0 / beta
    for j in range(subspace):
        hj1 = H[j + 1, j]
        if hj1 == 0.0:
            break
        c_j = np.zeros(subspace + 1)
        c_j[1 : j + 2] = C[: j + 1, j]
        for i in range(j + 1):
            c_j[: i + 1] -= C[: i + 1, i] * H[i, j]
        C[: j + 2, j + 1] = c_j[: j + 2] / hj1
    return C


def coefficients_arnoldi_from_h(beta, H, poly_order,
                                dtype=np.float64) -> np.ndarray:
    """Arnoldi-basis coefficients from a precomputed (beta, H), replaying
    ``coefficients_arnoldi``'s early-stop least-squares schedule on the
    host."""
    tol = tolerances(dtype)
    subspace = poly_order + 1
    C = cn_from_h(beta, H, subspace)
    y = np.zeros(subspace)
    for j in range(subspace):
        m = j + 1
        y = _ls_solve_arnoldi(beta, m, H)
        if H[j + 1, j] < tol.lucky:
            break
        res = np.linalg.norm(H[: m + 1, :m] @ y[:m]
                             - beta * np.eye(m + 1)[:, 0])
        if res / beta < tol.arnoldi:
            break
    return (C[: poly_order + 1, : poly_order + 1]
            @ y[: poly_order + 1])[: poly_order + 1]


def trim_high_order_zeros(coeffs: np.ndarray) -> np.ndarray:
    """Drop exactly-zero high-order coefficients (an early Arnoldi stop),
    so the matrix-free applier skips their matvecs (reference:
    src/Gmres_Poly.F90:90-135)."""
    nz = np.nonzero(coeffs)[0]
    if len(nz) == 0:
        return coeffs[:1]
    return coeffs[: nz[-1] + 1]


def horner(matvec, coefficients, x):
    """y = (c0 + c1 A + c2 A^2 + ...) x via Horner (reference:
    src/Gmres_Poly.F90:1418-1484)."""
    order = coefficients.shape[0] - 1
    y = coefficients[order] * x
    for k in range(order - 1, -1, -1):
        y = matvec(y) + coefficients[k] * x
    return y
