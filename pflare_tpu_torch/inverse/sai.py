"""SAI / ISAI approximate inverses and the SAI Z build, on the host.

Reference: src/SAI_Z.F90, ported from ``pflare_tpu.inverse.sai``.  For
every target row j with allowed sparsity J (a row of the sparsity
matrix), solve the local dense system

    Z(j, J) . A_ff(J, I) = -A_cf(j, I)

ISAI ("incomplete", one-level restricted additive Schwarz, Antz 2018):
I = J, a square solve.  SAI: I = shadow(J), the columns reachable from
the rows J, a least-squares solve.  A square approximate inverse
(reference: src/SAI_Z.F90:781) is the same with A_cf = -I.

Rows are grouped by their unknown count and solved one chunk at a time,
ISAI as a batched LU solve and SAI as a batched dense QR with the shadow
padded by zero rows to its chunk's largest height: no unknown is padded,
so the dense work is each row's own (lAIR's coarse levels mix rows of 1
to ~200 unknowns).  Singular and rank-deficient blocks are redone one row
at a time by ``_sai_z_loop``, the oracle.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


# f64 scalars of the blocks of one chunk: bounds the peak memory
_CHUNK_SCALARS = 1 << 22


def _rows_of(A):
    return np.repeat(np.arange(A.shape[0], dtype=np.int64), np.diff(A.indptr))


def _pad_indices(M: sp.csr_matrix):
    """Row-padded index table of a CSR pattern: (idx [n, kmax], mask
    [n, kmax], counts [n]); padded slots hold 0 and mask False."""
    counts = np.diff(M.indptr)
    n = M.shape[0]
    kmax = int(counts.max()) if n and M.nnz else 0
    idx = np.zeros((n, kmax), dtype=np.int64)
    mask = np.zeros((n, kmax), dtype=bool)
    if kmax:
        slot = (np.arange(M.nnz, dtype=np.int64)
                - np.repeat(M.indptr[:-1], counts))
        rr = _rows_of(M)
        idx[rr, slot] = M.indices
        mask[rr, slot] = True
    return idx, mask, counts


def sai_z(A_ff, A_cf, sparsity_cf, incomplete: bool,
          batched: bool = True) -> sp.csr_matrix:
    """Z ~= -A_cf @ inv(A_ff) on the sparsity of ``sparsity_cf``, on the
    host: the batched QR, or the per-row loop with ``batched=False``."""
    A_ff = sp.csr_matrix(A_ff)
    A_ff.sort_indices()
    A_cf = sp.csr_matrix(A_cf)
    A_cf.sort_indices()
    S = sp.csr_matrix(sparsity_cf)
    S.sort_indices()
    if batched and S.nnz:
        return _sai_z_batched(A_ff, A_cf, S, incomplete)
    return _sai_z_loop(A_ff, A_cf, S, incomplete)


def _shadow(S, A_ff):
    """The pattern of S @ A_ff: row j holds the columns the rows J of
    A_ff reach."""
    Sh = sp.csr_matrix(
        (np.ones(S.nnz), S.indices, S.indptr), shape=S.shape
    ) @ sp.csr_matrix(
        (np.ones(A_ff.nnz), A_ff.indices, A_ff.indptr), shape=A_ff.shape)
    Sh.sort_indices()
    return Sh


def _sai_z_batched(A_ff, A_cf, S, incomplete: bool) -> sp.csr_matrix:
    n_rows = S.shape[0]
    J_idx, J_mask, kJ = _pad_indices(S)
    kmax = J_idx.shape[1]
    if incomplete:
        I_idx, I_mask, kI = J_idx, J_mask, kJ
    else:
        I_idx, I_mask, kI = _pad_indices(_shadow(S, A_ff))

    out_data = np.zeros((n_rows, kmax))
    bad_rows: list[int] = []
    # rows grouped by their exact unknown count kJ, each group by
    # descending block height: no chunk pads its unknowns, and the SAI
    # shadow's heights pad only to their chunk's own
    order = np.lexsort((-kI, -kJ))
    order = order[kJ[order] > 0]
    groups = np.split(order, np.flatnonzero(np.diff(kJ[order])) + 1)
    for group in groups:
        if len(group) == 0:
            continue
        kc = int(kJ[group[0]])
        step = max(1, _CHUNK_SCALARS // (kc * (int(kI[group[0]]) + kc)))
        for lo in range(0, len(group), step):
            sel = group[lo: lo + step]
            z, good = _solve_chunk(A_ff, A_cf, sel, J_idx[sel][:, :kc],
                                   I_idx[sel], I_mask[sel],
                                   int(kI[sel].max()), incomplete)
            out_data[sel, :kc] = z
            bad_rows.extend(int(r) for r in sel[~good])

    if bad_rows:
        # rank-deficient local blocks: the per-row min-norm solve
        bad = np.asarray(bad_rows)
        Zf = _sai_z_loop(A_ff, sp.csr_matrix(A_cf[bad]), S[bad], incomplete)
        Zf.sort_indices()
        for k, j in enumerate(bad):
            vals = Zf.data[Zf.indptr[k]:Zf.indptr[k + 1]]
            out_data[j, : len(vals)] = vals

    rows_coo = np.repeat(np.arange(n_rows), kJ)
    slot = np.arange(S.nnz, dtype=np.int64) - np.repeat(S.indptr[:-1], kJ)
    Z = sp.csr_matrix(
        (out_data[rows_coo, slot], S.indices.copy(), S.indptr.copy()),
        shape=S.shape)
    Z.sort_indices()
    return Z


def _block_values(A, row_of, Ic, Im):
    """Dense local blocks out of the csr ``A``, without a lookup per slot:
    out[r, a, c] = A[row_of[r, c], Ic[r, a]] for the valid slots (Im) of
    the sorted rows of Ic, 0 elsewhere.  Each entry of the rows
    ``row_of`` is matched to its slot a by one search in the chunk's own
    (row, column) keys.  ``row_of`` is [b, kc]; the result [b, ic, kc]."""
    b, kc = row_of.shape
    ic = Ic.shape[1]
    n_cols = np.int64(A.shape[1])
    # the chunk's valid (r, I) keys, sorted (Ic is sorted within a row)
    r_of_slot, a_of_slot = np.nonzero(Im)
    keys = r_of_slot * n_cols + Ic[r_of_slot, a_of_slot]
    starts = A.indptr[row_of].ravel()
    lens = (A.indptr[row_of + 1] - A.indptr[row_of]).ravel()
    owner = np.repeat(np.arange(b * kc), lens)        # flat (r, c) slot
    ent = (np.arange(int(lens.sum()), dtype=np.int64)
           - np.repeat(np.cumsum(lens) - lens, lens) + np.repeat(starts, lens))
    r = owner // kc
    q = r * n_cols + A.indices[ent]
    pos = np.minimum(np.searchsorted(keys, q), max(len(keys) - 1, 0))
    hit = (len(keys) > 0) & (keys[pos] == q)
    out = np.zeros((b, ic, kc))
    out[r[hit], a_of_slot[pos[hit]], (owner % kc)[hit]] = A.data[ent[hit]]
    return out


def _solve_chunk(A_ff, A_cf, sel, Jc, I_idx, I_mask, ic, incomplete):
    """Local solves of the rows ``sel``, which share their unknown count
    kc = Jc.shape[1], on the transposed blocks M[r, a, c] = A_ff[J_c, I_a]
    ([b, ic, kc], rows of the padded I slots zero).  Returns (z [b, kc],
    good [b]); z is 0 where a row is not good, and ``_sai_z_loop`` redoes
    it.  ISAI (square, I = J): one batched LU solve, which is what the
    loop computes for every nonsingular block; a singular block makes the
    whole chunk not good.  SAI: a batched reduced QR, and a row is not
    good when its block is rank-deficient (|R_ii| below 1e-12 of the
    largest) or its solution is not finite."""
    kc = Jc.shape[1]
    Ic, Im = I_idx[:, :ic], I_mask[:, :ic]
    M = _block_values(A_ff, Jc, Ic, Im)                      # [b, ic, kc]
    rhs = -_block_values(A_cf, sel[:, None], Ic, Im)[:, :, 0]
    if incomplete:
        try:
            z = np.linalg.solve(M, rhs[..., None])[..., 0]
        except np.linalg.LinAlgError:
            return np.zeros((len(sel), kc)), np.zeros(len(sel), dtype=bool)
        good = np.isfinite(z).all(axis=1)
        return np.where(good[:, None], z, 0.0), good
    if ic < kc:
        # fewer equations than unknowns: zero rows keep R square, and the
        # rank test sends the row to the per-row min-norm solve
        M = np.concatenate([M, np.zeros((len(sel), kc - ic, kc))], axis=1)
        rhs = np.concatenate([rhs, np.zeros((len(sel), kc - ic))], axis=1)
    Q, R = np.linalg.qr(M)                      # batched reduced QR
    qtb = np.einsum("bij,bi->bj", Q, rhs)
    rdiag = np.abs(np.diagonal(R, axis1=1, axis2=2))
    good = rdiag.min(axis=1) > 1e-12 * np.maximum(rdiag.max(axis=1), 1e-300)
    with np.errstate(all="ignore"):
        z = np.linalg.solve(R + 1e-300 * np.eye(kc), qtb[..., None])[..., 0]
    good &= np.isfinite(z).all(axis=1)
    return np.where(good[:, None], z, 0.0), good


def _sai_z_loop(A_ff, A_cf, S, incomplete: bool) -> sp.csr_matrix:
    """Per-row solve: the rank-deficient fallback and the oracle of the
    batched path."""
    n_rows = S.shape[0]
    out_rows, out_cols, out_vals = [], [], []
    for j in range(n_rows):
        J = S.indices[S.indptr[j]: S.indptr[j + 1]]
        if len(J) == 0:
            continue
        if incomplete:
            I = J
        else:
            # shadow: the union of the column indices of A_ff's rows J
            start = A_ff.indptr[J]
            end = A_ff.indptr[J + 1]
            I = np.unique(np.concatenate(
                [A_ff.indices[s:e] for s, e in zip(start, end)]))
        block = np.asarray(A_ff[J][:, I].todense())
        acf_row = np.zeros(len(I))
        lo, hi = A_cf.indptr[j], A_cf.indptr[j + 1]
        cols_j = A_cf.indices[lo:hi]
        vals_j = A_cf.data[lo:hi]
        pos = np.searchsorted(I, cols_j)
        pos_c = np.minimum(pos, len(I) - 1)
        ok = I[pos_c] == cols_j
        acf_row[pos_c[ok]] = vals_j[ok]
        rhs = -acf_row
        if incomplete:
            try:
                z_row = np.linalg.solve(block.T, rhs)
            except np.linalg.LinAlgError:
                z_row, *_ = np.linalg.lstsq(block.T, rhs, rcond=None)
        else:
            z_row, *_ = np.linalg.lstsq(block.T, rhs, rcond=None)
        out_rows.extend([j] * len(J))
        out_cols.extend(J.tolist())
        out_vals.extend(z_row.tolist())

    Z = sp.csr_matrix((out_vals, (out_rows, out_cols)), shape=S.shape)
    Z.sort_indices()
    return Z


def sai_inverse(A, incomplete: bool, sparsity=None) -> sp.csr_matrix:
    """Square SAI/ISAI inverse M ~= inv(A) (reference: src/SAI_Z.F90:781):
    A_cf = -I, so M(j, J) A(J, I) = e_j(I)."""
    A = sp.csr_matrix(A)
    n = A.shape[0]
    negI = sp.csr_matrix(
        (np.full(n, -1.0), (np.arange(n), np.arange(n))), shape=(n, n))
    S = sp.csr_matrix(sparsity) if sparsity is not None else A.copy()
    return sai_z(A, negI, S, incomplete)
