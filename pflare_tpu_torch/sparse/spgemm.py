"""Fixed-sparsity sparse products: host plans.

A plan is built once from static patterns (the symbolic half of PETSc's
MatMatMult, reference: src/AIR_Operators_Setup.F90:960-1033,
src/Gmres_Poly.F90:777); its numeric execution is a gather, multiply and
segment sum over the product triples.  Ported from
``pflare_tpu.sparse.spgemm`` for the host setup and its same-pattern
re-setup (``execute_host``); the device execution of a plan waits for the
device re-setup.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .pattern import SparsityPattern


def _csr64(A):
    A = sp.csr_matrix(A)
    A.sort_indices()
    return A


class SpGEMMPlan:
    """Plan for C = (A @ B) restricted to a fixed output pattern:
    ``a_pos``/``b_pos`` index the CSR value arrays of A and B, ``out_pos``
    is the CSR entry of C each product term lands in."""

    def __init__(self, pat_A: SparsityPattern, pat_B: SparsityPattern,
                 pat_C: SparsityPattern, a_pos, b_pos, out_pos):
        self.pat_A = pat_A
        self.pat_B = pat_B
        self.pat_C = pat_C
        self.a_pos = np.asarray(a_pos)
        self.b_pos = np.asarray(b_pos)
        self.out_pos = np.asarray(out_pos)

    def execute_host(self, a_data: np.ndarray, b_data: np.ndarray
                     ) -> np.ndarray:
        """CSR value arrays in, CSR-ordered C values out (float64); each
        output sums its terms in triple order (the reference's
        accumulation order): one native pass, or a numpy bincount."""
        from ..native import plan_execute_native

        out = plan_execute_native(a_data, b_data, self.a_pos, self.b_pos,
                                  self.out_pos, self.pat_C.nnz)
        if out is not None:
            return out
        prod = a_data[self.a_pos] * b_data[self.b_pos]
        return np.bincount(self.out_pos, weights=prod,
                           minlength=self.pat_C.nnz)


def build_spgemm_plan(pat_A: SparsityPattern, pat_B: SparsityPattern,
                      pat_C: SparsityPattern) -> SpGEMMPlan:
    """Enumerate the product triples (i,k)(k,j) that land in pattern C,
    row by row, A's entries in order and B's in order within each: one
    native pass, or numpy."""
    from ..native import plan_triples_native

    nat = plan_triples_native(pat_A.indptr, pat_A.indices, pat_B.indptr,
                              pat_B.indices, pat_C.indptr, pat_C.indices,
                              pat_B.shape[1])
    if nat is not None:
        return SpGEMMPlan(pat_A, pat_B, pat_C, *nat)
    a_cols = pat_A.indices
    b_indptr = pat_B.indptr
    # per A entry: the number of B entries in row a_cols[t]
    rep = np.diff(b_indptr)[a_cols]
    total = int(rep.sum())
    a_idx = np.repeat(np.arange(pat_A.nnz, dtype=np.int64), rep)
    grp_start = np.cumsum(rep) - rep
    off = np.arange(total, dtype=np.int64) - np.repeat(grp_start, rep)
    b_idx = np.repeat(b_indptr[a_cols], rep) + off
    out_pos = pat_C.find(pat_A.row_of_pos()[a_idx], pat_B.indices[b_idx])
    keep = out_pos >= 0
    return SpGEMMPlan(pat_A, pat_B, pat_C, a_idx[keep], b_idx[keep],
                      out_pos[keep])


class FixedSparsityPolyPlan:
    """Assembled fixed-sparsity matrix polynomial plan.

    p(A) = c0 I + c1 A + c2 (A A)|_S + c3 ((A A)|_S A)|_S + ..., with S the
    union of the diagonal and the powers of A up to ``sparsity_order`` --
    the reference's ``mat_mult_powers_share_sparsity``
    (src/Gmres_Poly.F90:777-920): every power is restricted onto S, so the
    inverse stays as sparse as A^sparsity_order.
    """

    def __init__(self, pat_A: SparsityPattern, order: int,
                 sparsity_order: int):
        self.order = order
        self.sparsity_order = max(1, min(sparsity_order, order))
        A = pat_A.csr_bool().astype(np.float64)
        # the union is needed when A has no structural diagonal (the
        # Neumann N = I - D^-1 A): pattern(A^2) then misses pattern(A)
        S = A.copy()
        power = A
        for _ in range(self.sparsity_order - 1):
            power = _csr64(power @ A)
            S = _csr64(S + power)
        n = min(pat_A.shape)
        S = _csr64(S + sp.csr_matrix(
            (np.ones(n), (np.arange(n), np.arange(n))), shape=S.shape))
        self.pat_S = SparsityPattern(S.indptr, S.indices, S.shape)
        self.pat_A = pat_A
        # (X @ A)|_S with X on S: the running power stays the first operand
        self.step_plan = build_spgemm_plan(self.pat_S, pat_A, self.pat_S)
        self.inject_pos = self.pat_S.find(pat_A.row_of_pos(), pat_A.indices)
        self.diag_pos = self.pat_S.diag_positions()

    def execute_host(self, A_csr, coefficients) -> sp.csr_matrix:
        """The polynomial's values on S from A's CSR values, summed as the
        reference's host path sums them."""
        coefficients = np.asarray(coefficients, dtype=np.float64)
        patS = self.pat_S
        # inject_pos is injective: a placement of A's values onto S
        a_on_s = np.bincount(self.inject_pos, weights=A_csr.data,
                             minlength=patS.nnz)
        acc = coefficients[1] * a_on_s
        power = a_on_s
        for k in range(2, self.order + 1):
            power = self.step_plan.execute_host(power, A_csr.data)
            acc = acc + coefficients[k] * power
        dmask = self.diag_pos >= 0
        acc[self.diag_pos[dmask]] += coefficients[0]
        out = sp.csr_matrix((acc, patS.indices, patS.indptr),
                            shape=patS.shape)
        out.sort_indices()
        return out
