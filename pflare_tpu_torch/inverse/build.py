"""Approximate-inverse builder and applier.

Reference: src/Approx_Inverse_Setup.F90:33-553.  ``build_inverse`` runs on
the host: it computes the polynomial's coefficients or Newton roots with
scipy matvecs and, for an assembled inverse, accumulates the polynomial on
a fixed sparsity in the native host kernels.  The result is a host
``Inverse`` (numpy and scipy members); ``Inverse.to`` gives the device
form whose ``apply`` the solve calls.

Kinds: ``diagonal`` (JACOBI, WJACOBI, order-0 polynomials), ``assembled``
(POWER, ARNOLDI, NEWTON and NEUMANN on a fixed sparsity; SAI, ISAI),
``dense`` (LU), ``poly_mf`` (POWER/ARNOLDI matrix-free, Horner),
``newton_mf`` (NEWTON matrix-free) and ``neumann_mf`` (NEUMANN
matrix-free, Horner over v - A v / d).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch

from ..params import InverseType, tolerances
from ..sparse import ELL, SparsityPattern
from ..sparse.spgemm import FixedSparsityPolyPlan
from .gmres_poly import (coefficients_arnoldi, coefficients_power, horner,
                         trim_high_order_zeros)
from .newton import (build_newton_program, newton_apply, newton_residual_apply,
                     newton_roots)
from .sai import sai_inverse


class Inverse:
    """An applier for an approximate inverse.

    kind: 'diagonal' | 'assembled' | 'dense' | 'poly_mf' | 'newton_mf' |
    'neumann_mf'.  ``scaled`` marks right diagonal scaling q(D^-1 A) D^-1
    (reference: src/Gmres_Poly.F90:1375-1414).  On the host ``diag`` and
    ``coefficients`` are numpy arrays, the operator is the scipy
    ``mat_src`` and a dense inverse is the array ``mat``; after ``to`` they
    are tensors and ``mat`` is a device container (a dense tensor for
    'dense').
    """

    def __init__(self, kind, mat=None, coefficients=None, steps=(),
                 diag=None, scaled=False, host_csr=None, mat_src=None):
        self.kind = kind
        self.mat = mat
        self.coefficients = coefficients
        self.steps = steps
        self.diag = diag
        self.scaled = scaled
        # host copy of an assembled inverse (the setup's SpGEMMs use it)
        self.host_csr = host_csr
        # host matrix a device operator is built from
        self.mat_src = mat_src

    def to(self, device, dtype, mat=None) -> "Inverse":
        """Device form with float tensors of ``dtype``.  ``mat`` supplies the
        device operator (the full-space level operator, or the Krylov
        operator a matrix-free inverse shares); without it an assembled or
        matrix-free inverse runs on a gather ELL of its host matrix, as the
        reference's lazily built operator does
        (pflare_tpu/inverse/build.py:67-74)."""

        def tensor(a):
            if a is None:
                return None
            return torch.tensor(np.asarray(a), dtype=dtype, device=device)

        if self.kind == "dense":
            mat = tensor(self.mat)
        elif mat is None and self.kind != "diagonal":
            src = self.mat_src if self.mat_src is not None else self.host_csr
            mat = ELL.from_scipy(src, dtype=dtype).to(device)

        return Inverse(self.kind, mat=mat,
                       coefficients=tensor(self.coefficients),
                       steps=self.steps, diag=tensor(self.diag),
                       scaled=self.scaled, host_csr=self.host_csr)

    def _matvec(self):
        mv = self.mat.matvec
        if self.scaled:
            diag = self.diag
            return lambda v: mv(v) / diag
        return mv

    def apply(self, x):
        if self.kind == "dense":
            return self.mat @ x
        if self.kind == "assembled":
            return self.mat.matvec(x)
        if self.kind == "diagonal":
            return self.diag * x
        if self.kind == "poly_mf":
            xin = x / self.diag if self.scaled else x
            return horner(self._matvec(), self.coefficients, xin)
        if self.kind == "neumann_mf":
            diag = self.diag
            mv = self.mat.matvec
            return horner(lambda v: v - mv(v) / diag, self.coefficients,
                          x / diag)
        if self.kind == "newton_mf":
            xin = x / self.diag if self.scaled else x
            return newton_apply(self._matvec(), self.steps, xin)
        raise ValueError(self.kind)

    def apply_residual(self, x):
        """pi(A) x, the residual polynomial of a matrix-free Newton inverse
        (reference: src/Gmres_Poly_Newton.F90:966)."""
        if self.kind != "newton_mf":
            raise ValueError("the residual polynomial is applied only for "
                             "newton_mf")
        xin = x / self.diag if self.scaled else x
        y = newton_residual_apply(self._matvec(), self.steps, xin)
        return y * self.diag if self.scaled else y

    def __call__(self, x):
        return self.apply(x)

    @property
    def num_matvecs(self):
        """Matvecs per application (for stats/cycle complexity)."""
        if self.kind in ("assembled", "diagonal", "dense"):
            return 1
        if self.kind in ("poly_mf", "neumann_mf"):
            return int(self.coefficients.shape[0]) - 1
        if self.kind == "newton_mf":
            return sum(2 if s[0] == "cc" else 1
                       for s in self.steps if s[0] != "real_last")
        return 0


def _clamp_orders(n_global, poly_order, sparsity_order):
    """reference: src/Gmres_Poly.F90:64-76."""
    if poly_order + 1 > n_global:
        poly_order = max(int(n_global) - 1, 0)
    sparsity_order = min(sparsity_order, max(poly_order, 1))
    return poly_order, sparsity_order


def build_inverse(A_scipy: sp.csr_matrix, inverse_type: InverseType,
                  poly_order: int = 6, sparsity_order: int = 1,
                  matrix_free: bool = False, diag_scale: bool = False,
                  coefficients=None, seed: int = 17,
                  poly_plan=None) -> Inverse:
    """Compute a host approximate inverse of ``A_scipy``.  The precision
    follows the matrix: an f32 matrix gives an f32 Krylov basis and f32
    tolerances.  ``coefficients`` skips the polynomial iteration (the
    reference's coefficient reuse protocol, src/Approx_Inverse_Setup.F90:
    52-64).  ``poly_plan``, a ``FixedSparsityPolyPlan`` stored by a
    reuse-enabled setup, evaluates an assembled power or Arnoldi
    polynomial on its stored plan when it still fits the matrix."""
    inverse_type = InverseType(inverse_type)
    A = A_scipy
    n = A.shape[0]
    dtype = A.data.dtype
    poly_order, sparsity_order = _clamp_orders(n, poly_order, sparsity_order)
    tol = tolerances(dtype)

    if inverse_type == InverseType.LU:
        # exact dense inverse (coarse grids)
        Minv = sla.inv(A.toarray())
        return Inverse("dense", mat=Minv, host_csr=sp.csr_matrix(Minv))

    if inverse_type in (InverseType.JACOBI, InverseType.WJACOBI):
        d = np.asarray(A.diagonal())
        weight = 1.0
        if inverse_type == InverseType.WJACOBI:
            # hypre weight 3/(4 ||D^-1/2 A D^-1/2||_inf)
            # (reference: src/Weighted_Jacobi.F90:44-66)
            inv_ds = np.where(np.abs(d) > 0, 1.0 / np.sqrt(np.abs(d)), 0.0)
            Dm = sp.diags(inv_ds)
            weight = 3.0 / (4.0 * float(np.abs(Dm @ A @ Dm).sum(axis=1).max()))
        return Inverse("diagonal", diag=np.where(d != 0, weight / d, 0.0))

    if inverse_type in (InverseType.SAI, InverseType.ISAI):
        # PATTERN powers: value products could cancel entries exactly and
        # make the sparsity value-dependent
        S1 = _pattern_ones(A)
        S = S1
        for _ in range(sparsity_order - 1):
            S = sp.csr_matrix(S @ S1)
            S.data[:] = 1.0
        M = sai_inverse(A, incomplete=(inverse_type == InverseType.ISAI),
                        sparsity=S)
        return Inverse("assembled", host_csr=M)

    if inverse_type == InverseType.NEUMANN:
        d = np.asarray(A.diagonal())
        ones = np.ones(poly_order + 1)
        if matrix_free:
            return Inverse("neumann_mf", coefficients=ones, diag=d,
                           mat_src=A)
        # assembled: p(N)|_S D^-1 with N = I - D^-1 A
        # (reference: src/Neumann_Poly.F90:177-212)
        N = sp.csr_matrix(sp.eye(n, format="csr", dtype=A.data.dtype)
                          - sp.diags(1.0 / d) @ A)
        N.sort_indices()
        plan = FixedSparsityPolyPlan(
            SparsityPattern(N.indptr, N.indices, N.shape), poly_order,
            sparsity_order)
        M_host = sp.csr_matrix(plan.execute_host(N, ones) @ sp.diags(1.0 / d))
        return Inverse("assembled", host_csr=M_host)

    d_np = np.asarray(A.diagonal()) if diag_scale else None
    if diag_scale:
        matvec = lambda v: (A @ v) / d_np
    else:
        matvec = lambda v: A @ v

    if inverse_type in (InverseType.NEWTON, InverseType.NEWTON_NO_EXTRA):
        if coefficients is not None:
            wr, wi = np.asarray(coefficients[0]), np.asarray(coefficients[1])
        else:
            wr, wi = newton_roots(
                matvec, n, poly_order, dtype,
                add_roots=(inverse_type == InverseType.NEWTON), seed=seed)
        steps = build_newton_program(wr, wi, tol.zero)
        roots = np.stack([wr, wi])
        if matrix_free:
            return Inverse("newton_mf", steps=steps, diag=d_np,
                           scaled=diag_scale, coefficients=roots, mat_src=A)
        # assembled Newton: the factored polynomial accumulated in the
        # Newton basis with every product restricted to the fixed sparsity
        # (reference: src/Gmres_Poly_Newtonk.kokkos.cxx:15)
        A_use = _diag_scaled(A, d_np) if diag_scale else A
        M_host = _newton_fixed_sparsity_host(A_use, wr, wi, sparsity_order,
                                             poly_order, tol.zero)
        if diag_scale:
            M_host = sp.csr_matrix(M_host @ sp.diags(1.0 / d_np))
        return Inverse("assembled", host_csr=M_host, coefficients=roots)

    if coefficients is not None:
        coeffs = np.asarray(coefficients, dtype=np.float64)
    elif inverse_type == InverseType.POWER:
        coeffs = coefficients_power(matvec, n, poly_order, dtype, seed=seed)
    else:
        coeffs = coefficients_arnoldi(matvec, n, poly_order, dtype, seed=seed)

    if matrix_free:
        return Inverse("poly_mf", coefficients=trim_high_order_zeros(coeffs),
                       diag=d_np, scaled=diag_scale, mat_src=A)
    return _assemble_poly(A, coeffs, sparsity_order, diag_scale, d_np,
                          poly_plan)


def _diag_scaled(A, d_np):
    A_use = sp.csr_matrix(sp.diags(1.0 / d_np) @ A)
    A_use.sort_indices()
    return A_use


def _assemble_poly(A, coeffs, sparsity_order, diag_scale, d_np,
                   poly_plan=None):
    """Assembled polynomial inverse (fixed sparsity, reference:
    src/Gmres_Poly.F90:1522-1813); numeric-only on ``poly_plan`` when it
    has A's nonzero count and the polynomial's order."""
    n = A.shape[0]
    poly_order = len(coeffs) - 1
    if poly_order == 0:
        inv_diag = np.full(n, float(coeffs[0]))
        if diag_scale:
            inv_diag = inv_diag / d_np
        return Inverse("diagonal", diag=inv_diag, coefficients=coeffs)
    A_use = _diag_scaled(A, d_np) if diag_scale else A
    if (poly_plan is not None and poly_plan.pat_A.nnz == A_use.nnz
            and poly_plan.order == poly_order):
        M_host = poly_plan.execute_host(A_use, coeffs)
    else:
        M_host = _fixed_sparsity_poly_host(A_use, coeffs, sparsity_order)
    if diag_scale:
        M_host = sp.csr_matrix(M_host @ sp.diags(1.0 / d_np))
    return Inverse("assembled", host_csr=M_host, coefficients=coeffs)


def _pattern_ones(A: sp.csr_matrix) -> sp.csr_matrix:
    out = sp.csr_matrix(
        (np.ones(A.nnz), A.indices, A.indptr), shape=A.shape)
    out.has_sorted_indices = A.has_sorted_indices
    return out


def _poly_sparsity(A: sp.csr_matrix, sparsity_order, poly_order):
    """(s_indptr, s_indices) of S = union(I, A, ..., A^sparsity_order)
    (reference: the fixed sparsity of mat_mult_powers_share_sparsity,
    src/Gmres_Poly.F90:777-920).  Fast path: sparsity_order 1 with a full
    structural diagonal means S is exactly A's pattern -- no work."""
    so = max(1, min(sparsity_order, poly_order))
    if so == 1:
        n = A.shape[0]
        rows = np.repeat(np.arange(n), np.diff(A.indptr))
        has = np.zeros(n, dtype=bool)
        has[rows[A.indices == rows]] = True
        if has.all():
            return A.indptr, A.indices
        missing = np.nonzero(~has)[0]
        eye = sp.csr_matrix(
            (np.ones(len(missing)), (missing, missing)), shape=A.shape)
        S = sp.csr_matrix(_pattern_ones(A) + eye)
        S.sort_indices()
        return S.indptr, S.indices
    S = _pattern_ones(A)
    power = S
    for _ in range(so - 1):
        power = (power @ S).tocsr()
        S = (S + power).tocsr()
    eye = sp.eye(A.shape[0], format="csr")
    S = sp.csr_matrix(S + eye)
    S.sort_indices()
    return S.indptr, S.indices


def _fixed_sparsity_poly_host(A: sp.csr_matrix, coeffs, sparsity_order
                              ) -> sp.csr_matrix:
    """Every power restricted onto S = union(diag, A, ..., A^so), summed
    with the coefficients: one native per-row sweep, or the scipy SpGEMM +
    mask fallback."""
    from ..native import poly_on_sparsity_native

    poly_order = len(coeffs) - 1
    s_indptr, s_indices = _poly_sparsity(A, sparsity_order, poly_order)
    data = poly_on_sparsity_native(A, s_indptr, s_indices, coeffs)
    if data is not None:
        M = sp.csr_matrix((data, s_indices.copy(), s_indptr.copy()),
                          shape=A.shape)
        M.has_sorted_indices = True
        return M
    S_mask = sp.csr_matrix((np.ones(len(s_indices)), s_indices, s_indptr),
                           shape=A.shape)
    A_on_S = sp.csr_matrix(A.multiply(S_mask))
    acc = coeffs[1] * A_on_S
    P = A_on_S
    for k in range(2, poly_order + 1):
        P = sp.csr_matrix((P @ A).multiply(S_mask))
        acc = acc + coeffs[k] * P
    n = min(A.shape)
    eye = sp.csr_matrix((np.ones(n), (np.arange(n), np.arange(n))),
                        shape=A.shape)
    acc = sp.csr_matrix(acc + coeffs[0] * eye)
    acc.sort_indices()
    return acc


def _newton_fixed_sparsity_host(A: sp.csr_matrix, wr, wi, sparsity_order,
                                poly_order, tol_zero) -> sp.csr_matrix:
    """Assembled Newton-basis inverse with fixed sparsity: one native
    sweep, or the scipy fallback accumulating M = sum_i T_i / theta_i with
    T_i the running product of (I - A/theta_j) factors restricted onto S
    (complex-conjugate pairs combined in real arithmetic, Loe 2021
    Alg. 3)."""
    from ..native import newton_on_sparsity_native

    s_indptr, s_indices = _poly_sparsity(A, sparsity_order, poly_order)
    data = newton_on_sparsity_native(A, s_indptr, s_indices, wr, wi,
                                     tol_zero)
    if data is not None:
        M = sp.csr_matrix((data, s_indices.copy(), s_indptr.copy()),
                          shape=A.shape)
        M.has_sorted_indices = True
        return M
    n = A.shape[0]
    S_mask = sp.csr_matrix((np.ones(len(s_indices)), s_indices, s_indptr),
                           shape=A.shape)

    def restrict(X):
        return sp.csr_matrix(X.multiply(S_mask))

    eye = sp.csr_matrix((np.ones(n), (np.arange(n), np.arange(n))),
                        shape=A.shape)
    T = eye.copy()
    M = sp.csr_matrix(A.shape)
    k = len(wr)
    i = 0
    while i <= k - 2:
        if wi[i] == 0.0:
            if abs(wr[i]) < tol_zero:
                i += 1
                continue
            M = M + T / wr[i]
            T = restrict(T - restrict(T @ A) / wr[i])
            i += 1
        else:
            s = wr[i] ** 2 + wi[i] ** 2
            if s < tol_zero:
                i += 2
                continue
            TA = restrict(T @ A)
            T2 = 2.0 * wr[i] * T - TA
            M = M + T2 / s
            if i <= k - 3:
                T = restrict(T - restrict(T2 @ A) / s)
            i += 2
    if k >= 1 and wi[k - 1] == 0.0 and abs(wr[k - 1]) > tol_zero:
        M = M + T / wr[k - 1]
    M = sp.csr_matrix(M)
    M.sort_indices()
    return M
