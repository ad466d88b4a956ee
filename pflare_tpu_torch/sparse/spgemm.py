"""Fixed-sparsity sparse products: host plans and their device execution.

A plan is built once from static patterns (the symbolic half of PETSc's
MatMatMult, reference: src/AIR_Operators_Setup.F90:960-1033,
src/Gmres_Poly.F90:777); its numeric execution is a gather, multiply and
segment sum over the product triples.  Ported from
``pflare_tpu.sparse.spgemm``: ``execute_host`` serves the host setup and
its same-pattern re-setup, ``device_tables`` with ``plan_execute`` and
``poly_execute`` the device re-setup (``air/device_resetup.py``).  The
device half works on CSR value vectors, the space the plans index, not
on ELL slots as the reference's ``execute`` does, and its segment sums
add each output's terms in the host's order on any device.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from .pattern import SparsityPattern


def index_tensor(a, device):
    """A host index array as an int32 tensor on ``device`` (int64 where
    its values need it): the device re-setup's tables are index arrays
    the size of its product triples, so this halves their memory."""
    a = np.ascontiguousarray(a)
    wide = a.size and (a.max() >= 2**31 or a.min() < -2**31)
    return torch.as_tensor(a, dtype=torch.int64 if wide else torch.int32,
                           device=device)


def take(values, index1):
    """``values[index1 - 1]``, 0 where ``index1`` is 0: the gather form of
    every static placement of the device re-setup (an index tensor of any
    shape, 1-based, with 0 for an empty slot)."""
    return F.pad(values, (1, 0))[index1]


def segment_sum(values, lengths):
    """Sums of consecutive runs of ``values``: run i is the next
    ``lengths[i]`` terms (an int64 tensor), added one after the other in
    index order from 0, as a CPU ``index_add_`` into zeros adds a sorted
    index.  ``torch.segment_reduce`` on 2-D data runs one sequential loop
    per segment on the CPU and on a CUDA device alike, so a card's sums
    equal the CPU's bit for bit and do not change from run to run (an
    ``index_add_`` on a card adds atomically, in no fixed order)."""
    return torch.segment_reduce(values[:, None], "sum", lengths=lengths,
                                axis=0, unsafe=True, initial=0.0)[:, 0]


def ordered_dot(a, b):
    """sum(a * b) over a fixed pairwise tree of elementwise adds, each
    product and each sum rounded on its own: the same bits on a card as on
    the CPU (a library dot's reduction order differs between devices)."""
    t = a * b
    if t.shape[0] == 0:
        return t.new_zeros(())
    while t.shape[0] > 1:
        h = t.shape[0] // 2
        t = torch.cat([t[:h] + t[h:2 * h], t[2 * h:]])
    return t[0]


def ordered_sum(terms):
    """terms[0] + terms[1] + ... in index order (separate roundings)."""
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def run_lengths(out, n_out: int, device):
    """The run lengths of a nondecreasing host index array ``out`` over
    ``n_out`` slots, as the int64 tensor ``segment_sum`` takes."""
    return torch.as_tensor(np.bincount(np.asarray(out, dtype=np.int64),
                                       minlength=n_out), device=device)


def plan_execute(tables: dict, a_flat, b_flat):
    """C values in CSR order from A's and B's CSR values (device tensors)
    by the tables of ``SpGEMMPlan.device_tables``: gather, multiply,
    segment sum."""
    return segment_sum(a_flat[tables["a_pos"]] * b_flat[tables["b_pos"]],
                       tables["lengths"])


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
        # int32 where every position fits (the triples are most of a
        # reuse-enabled hierarchy's memory), one dtype for the three
        pos = [np.asarray(a) for a in (a_pos, b_pos, out_pos)]
        wide = any(a.size and a.max() >= 2**31 for a in pos)
        self.a_pos, self.b_pos, self.out_pos = (
            a.astype(np.int64 if wide else np.int32, copy=False) for a in pos)

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

    def device_tables(self, device) -> dict:
        """The triples as index tensors on ``device``, sorted by output
        entry with a stable sort on the device (they come grouped by
        output row, and a stable sort keeps each entry's terms in triple
        order, the order the host sums them in), and the run length of
        each output entry."""
        out = index_tensor(self.out_pos, device)
        order = torch.sort(out, stable=True).indices
        lengths = torch.bincount(out, minlength=self.pat_C.nnz)
        del out
        return {"a_pos": index_tensor(self.a_pos, device)[order],
                "b_pos": index_tensor(self.b_pos, device)[order],
                "lengths": lengths}

    def execute(self, a_flat, b_flat, tables=None):
        """C values in CSR order on the device of ``a_flat``."""
        if tables is None:
            tables = self.device_tables(a_flat.device)
        return plan_execute(tables, a_flat, b_flat)


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

    def device_tables(self, device) -> dict:
        """The plan on ``device``: ``inject`` places A's values on S (the
        injection is injective, so a gather), ``diag`` marks S's diagonal
        (where the c0 I term lands) and ``step`` is the (X @ A)|_S product
        plan."""
        inject = np.zeros(self.pat_S.nnz, dtype=np.int64)
        inject[self.inject_pos] = np.arange(1, self.pat_A.nnz + 1)
        diag = np.zeros(self.pat_S.nnz, dtype=bool)
        diag[self.diag_pos[self.diag_pos >= 0]] = True
        return {"inject": index_tensor(inject, device),
                "diag": torch.as_tensor(diag, device=device),
                "step": self.step_plan.device_tables(device),
                "order": self.order}

    def execute(self, a_flat, coefficients, tables=None):
        """p(A) values on S in CSR order, on the device of ``a_flat``."""
        if tables is None:
            tables = self.device_tables(a_flat.device)
        return poly_execute(tables, a_flat, coefficients)


def poly_execute(tables: dict, a_flat, coefficients):
    """p(A) on the plan's S pattern, CSR order, from A's CSR values:
    ``coefficients`` c0..c_order (a tensor, or floats) by the tables of
    ``FixedSparsityPolyPlan.device_tables``; every power is restricted
    onto S, as ``execute_host`` computes it."""
    a_on_s = take(a_flat, tables["inject"])
    acc = coefficients[1] * a_on_s
    power = a_on_s
    for k in range(2, tables["order"] + 1):
        power = plan_execute(tables["step"], power, a_flat)
        acc = acc + coefficients[k] * power
    return torch.where(tables["diag"], acc + coefficients[0], acc)


def scipy_matmat(A, B) -> sp.csr_matrix:
    """The plain host numeric SpGEMM, rows sorted (the first-time setup
    path)."""
    return _csr64(_csr64(A) @ _csr64(B))
