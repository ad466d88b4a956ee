"""Newton-basis GMRES polynomial: harmonic Ritz roots + stable applier.

Reference: src/Gmres_Poly_Newton.F90.  The roots are computed on host
(tiny dense eigenproblem); the data-dependent application order (real roots
vs complex-conjugate pairs, skipping numerically-zero roots) is resolved at
SETUP time into a static program, so the device apply is a fixed chain of
matvecs and axpys with no host decisions inside the solve.
"""

from __future__ import annotations

import numpy as np

from .gmres_poly import arnoldi_host
from ..params import tolerances


def modified_leja(real_roots, imag_roots):
    """Modified Leja ordering, conjugate pairs kept adjacent (reference:
    src/Gmres_Poly_Newton.F90:21-141).  Returns index order."""
    n = len(real_roots)
    mag = np.sqrt(real_roots**2 + imag_roots**2)
    sorted_ = np.zeros(n, dtype=bool)
    indices = []
    # running sum of log10-distances from every candidate to the chosen
    # set, updated per push (vectorised over candidates; the accumulation
    # order over `indices` matches the reference's inner loop exactly)
    acc = np.zeros(n)

    def push(i):
        indices.append(i)
        sorted_[i] = True
        a = real_roots - real_roots[i]
        b = imag_roots - imag_roots[i]
        sq = a * a + b * b
        with np.errstate(divide="ignore"):
            acc[:] += np.where(sq > 0, 0.5 * np.log10(
                np.where(sq > 0, sq, 1.0)), -np.inf)

    i0 = int(np.argmax(mag))
    push(i0)
    if imag_roots[i0] != 0.0:
        push(i0 + 1 if imag_roots[i0] > 0 else i0 - 1)

    while len(indices) < n:
        val = np.where(sorted_, -np.inf, 1.0 + acc)
        best = int(np.argmax(val))
        if val[best] < 0 or not np.isfinite(val[best]):
            # only repeated roots left: take next unsorted
            best = int(np.nonzero(~sorted_)[0][0])
        push(best)
        if imag_roots[indices[-1]] != 0.0 and len(indices) < n:
            last = indices[-1]
            push(last + 1 if imag_roots[last] > 0 else last - 1)
    return np.asarray(indices)


def cluster_eigenvalues(real_roots, imag_roots, rel_tol, abs_tol):
    """Merge numerically-identical eigenvalues into cluster centroids;
    compact non-zeros to the front (reference:
    src/Gmres_Poly_Newton.F90:145-245)."""
    n = len(real_roots)
    used = np.zeros(n, dtype=bool)
    out_r, out_i = [], []
    for i in range(n):
        if used[i]:
            continue
        if real_roots[i] == 0.0 and imag_roots[i] == 0.0:
            used[i] = True
            continue
        sr, si, csize = real_roots[i], imag_roots[i], 1
        used[i] = True
        mag_i = np.hypot(real_roots[i], imag_roots[i])
        for j in range(i + 1, n):
            if used[j]:
                continue
            if real_roots[j] == 0.0 and imag_roots[j] == 0.0:
                used[j] = True
                continue
            mag_j = np.hypot(real_roots[j], imag_roots[j])
            dist = np.hypot(real_roots[j] - real_roots[i],
                            imag_roots[j] - imag_roots[i])
            scale = max(mag_i, mag_j, 1.0)
            if dist <= abs_tol + rel_tol * scale:
                sr += real_roots[j]
                si += imag_roots[j]
                csize += 1
                used[j] = True
        out_r.append(sr / csize)
        out_i.append(si / csize)
    rr = np.zeros(n)
    ri = np.zeros(n)
    rr[: len(out_r)] = out_r
    ri[: len(out_i)] = out_i
    return rr, ri


def compute_extra_roots(real_roots, imag_roots, tol_zero):
    """Add copies of roots with large product-of-factors for high-order
    stability (reference: src/Gmres_Poly_Newton.F90:250-374)."""
    n = len(real_roots)
    pof = np.ones(n)
    overflow = np.zeros(n)
    extra_pairs = np.zeros(n, dtype=int)
    for k in range(n):
        a, b = real_roots[k], imag_roots[k]
        if b < 0:
            continue
        if abs(a) < tol_zero or a * a + b * b < tol_zero:
            continue
        for i in range(n):
            if i == k:
                continue
            c, d = real_roots[i], imag_roots[i]
            if abs(c) < tol_zero or c * c + d * d < tol_zero:
                continue
            denom = c * c + d * d
            div_real = (a * c + b * d) / denom
            div_imag = (b * c - a * d) / denom
            div_mag = np.hypot(1 - div_real, div_imag)
            if div_mag > 0 and np.log10(max(pof[k], 1e-300)) + np.log10(div_mag) > 307:
                overflow[k] += int(np.log10(pof[k]))
                pof[k] = 1.0
            pof[k] *= div_mag
        lg = np.log10(pof[k]) if pof[k] > 0 else -np.inf
        if lg > 4 or overflow[k] != 0:
            extra_pairs[k] = int(np.ceil((lg + overflow[k] - 4.0) / 14.0))
    out_r = list(real_roots)
    out_i = list(imag_roots)
    for i in range(n):
        for _ in range(extra_pairs[i]):
            out_r.append(real_roots[i])
            out_i.append(imag_roots[i])
            if imag_roots[i] > 0:
                out_r.append(real_roots[i])
                out_i.append(-imag_roots[i])
    return np.asarray(out_r), np.asarray(out_i)


def newton_roots(matvec, n, poly_order, dtype, add_roots=True, seed: int = 17,
                 precomputed=None):
    """Harmonic Ritz values in modified-Leja order (reference:
    src/Gmres_Poly_Newton.F90:379-712).  Returns (real, imag) arrays.
    ``matvec`` is a host (scipy) product: the Arnoldi runs on the host,
    unless ``precomputed`` gives its (beta, H, m), as the device setup
    does from ``gmres_poly.arnoldi_fixed_device``."""
    tol = tolerances(dtype)
    if precomputed is not None:
        beta, H, m = precomputed
    else:
        beta, H, m, _, _ = arnoldi_host(matvec, n, poly_order, dtype,
                                        tol.lucky, seed=seed)
    d = poly_order + 1
    # Harmonic Ritz: H_sq + f e_d^T with f = H[d,d-1]^2 * (H_sq^-T e_d)
    H_sq = H[:d, :d].copy()
    e_d = np.zeros(d)
    e_d[d - 1] = 1.0
    sol, *_ = np.linalg.lstsq(H_sq.T, e_d, rcond=tol.rcond)
    sol = sol * H[d, d - 1] ** 2
    H_sq[:, d - 1] += sol
    ev = np.linalg.eigvals(H_sq)
    wr, wi = ev.real.copy(), ev.imag.copy()
    # numpy returns conjugate pairs adjacent with +imag first (LAPACK geev)

    H_norm = np.linalg.norm(H[: m + 1, :m])
    rel_tol = np.sqrt(tol.eps)
    abs_tol = tol.eps * max(H_norm, beta)
    small = wr**2 + wi**2 < (abs_tol + rel_tol * H_norm) ** 2
    wr[small] = 0.0
    wi[small] = 0.0
    wr, wi = cluster_eigenvalues(wr, wi, rel_tol, abs_tol)

    nz = (wr != 0.0) | (wi != 0.0)
    n_nz = int(nz.sum())
    if n_nz == 0:
        return wr, wi
    rr, ri = wr[nz], wi[nz]
    if add_roots:
        rr, ri = compute_extra_roots(rr, ri, tol.zero)
        # perturb duplicates for unique Leja ordering
        pr, pi = rr.copy(), ri.copy()
        for i in range(n_nz):
            k = 0
            for j in range(n_nz, len(rr)):
                if rr[j] == rr[i] and abs(ri[j]) == abs(ri[i]):
                    k += 1
                    pr[j] = rr[j] + k * tol.leja_perturb
        order = modified_leja(pr, pi)
    else:
        order = modified_leja(rr.copy(), ri.copy())
    out_r = np.zeros(len(rr) + (len(wr) - n_nz))
    out_i = np.zeros_like(out_r)
    out_r[: len(rr)] = rr[order]
    out_i[: len(rr)] = ri[order]
    return out_r, out_i


def build_newton_program(real_roots, imag_roots, tol_zero):
    """Resolve Loe Algorithm 3 (reference: src/Gmres_Poly_Newton.F90:763-875)
    into a static instruction list.

    Ops: ('real', theta) -- y += x/theta; x -= A x/theta (1 matvec)
         ('cc', a, s)    -- combined conjugate pair, s = a^2+b^2 (2 matvecs,
                            1 if it is the final pair)
         ('real_last', theta) -- final real root, no trailing matvec.
    """
    steps = []
    n = len(real_roots)
    i = 0
    while i <= n - 2:
        if imag_roots[i] == 0.0:
            if abs(real_roots[i]) < tol_zero:
                i += 1
                continue
            steps.append(("real", float(real_roots[i])))
            i += 1
        else:
            s = real_roots[i] ** 2 + imag_roots[i] ** 2
            if s < tol_zero:
                i += 2
                continue
            last_pair = i > n - 3
            steps.append(("cc_last" if last_pair else "cc",
                          float(real_roots[i]), float(s)))
            i += 2
    if n >= 1 and imag_roots[n - 1] == 0.0 and abs(real_roots[n - 1]) > tol_zero:
        steps.append(("real_last", float(real_roots[n - 1])))
    return tuple(steps)


def newton_apply(matvec, steps, x):
    """Apply the Newton-basis polynomial inverse (the static program from
    ``build_newton_program``)."""
    t = x
    y = None
    for op in steps:
        if op[0] == "real":
            theta = op[1]
            y = t / theta if y is None else y + t / theta
            t = t - matvec(t) / theta
        elif op[0] in ("cc", "cc_last"):
            a, s = op[1], op[2]
            t2 = matvec(t)
            t2 = 2.0 * a * t - t2
            y = t2 / s if y is None else y + t2 / s
            if op[0] == "cc":
                t = t - matvec(t2) / s
        else:  # real_last
            theta = op[1]
            y = t / theta if y is None else y + t / theta
    if y is None:
        y = x * 0
    return y


def newton_residual_apply(matvec, steps, x):
    """The residual polynomial pi(A) x (Loe Alg. 1; reference:
    src/Gmres_Poly_Newton.F90:1003-1090)."""
    y = x
    for op in steps:
        if op[0] in ("real", "real_last"):
            y = y - matvec(y) / op[1]
        else:
            a, s = op[1], op[2]
            t2 = matvec(y)
            y = y + (matvec(t2) - 2.0 * a * t2) / s
    return y
