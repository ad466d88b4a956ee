"""SAI / ISAI approximate inverses and the SAI Z build, on the host.

Reference: src/SAI_Z.F90, ported from ``pflare_tpu.inverse.sai``.  For
every target row j with allowed sparsity J (a row of the sparsity
matrix), solve the local dense system

    Z(j, J) . A_ff(J, I) = -A_cf(j, I)

ISAI ("incomplete", one-level restricted additive Schwarz, Antz 2018):
I = J, a square solve.  SAI: I = shadow(J), the columns reachable from
the rows J, a least-squares solve.  A square approximate inverse
(reference: src/SAI_Z.F90:781) is the same with A_cf = -I.

All rows are padded to a common block size per chunk and solved as one
batched dense QR; padded columns get disjoint unit rows in an
augmentation block, so the normal equations decouple exactly and padded
unknowns come out 0.  Rank-deficient blocks are redone one row at a time
by ``_sai_z_loop``, the oracle.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..params import tolerances

# f64 scalars gathered per chunk (blocks + rhs): bounds the peak memory
_CHUNK_SCALARS = 1 << 24


def _rows_of(A):
    return np.repeat(np.arange(A.shape[0], dtype=np.int64), np.diff(A.indptr))


def _sv_cutoff(dtype) -> float:
    """dtype-matched relative singular-value cutoff (sigma_drop: 1e-13 in
    f64, 1e-6 in f32)."""
    return float(tolerances(np.dtype(dtype).type).sigma_drop)


def _lookup_pos(A, rows, cols):
    """Position of each (row, col) in A's sorted entry list; -1 when
    absent.  Safe on an empty A."""
    keys = _rows_of(A) * np.int64(A.shape[1]) + A.indices
    q = (rows.astype(np.int64) * np.int64(A.shape[1])
         + cols.astype(np.int64))
    if len(keys) == 0:
        return np.full(q.shape, -1, dtype=np.int64)
    pos = np.searchsorted(keys, q.ravel())
    pos_c = np.minimum(pos, len(keys) - 1)
    ok = keys[pos_c] == q.ravel()
    return np.where(ok, pos_c, -1).reshape(q.shape)


def _csr_lookup(A, rows, cols):
    """A[rows, cols] (any equal shapes), 0 outside the pattern; A must
    have sorted indices."""
    pos = _lookup_pos(A, np.asarray(rows), np.asarray(cols))
    return np.where(pos >= 0, A.data[np.maximum(pos, 0)], 0.0)


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
    imax = I_idx.shape[1]

    out_data = np.zeros((n_rows, kmax))
    rows_per_chunk = max(1, _CHUNK_SCALARS // max(1, kmax * (imax + kmax)))
    bad_rows: list[int] = []
    # rows by descending block height, so each chunk pads only to its own
    # sizes (the SAI shadow's heights vary a lot)
    order = np.argsort(-kI, kind="stable")
    order = order[kJ[order] > 0]
    for lo in range(0, len(order), rows_per_chunk):
        sel = order[lo: lo + rows_per_chunk]
        kc = int(kJ[sel].max())
        ic = int(kI[sel].max())
        pad_eye = np.eye(kc)
        Jc, Jm = J_idx[sel][:, :kc], J_mask[sel][:, :kc]   # [b, kc]
        Ic, Im = I_idx[sel][:, :ic], I_mask[sel][:, :ic]   # [b, ic]
        b = len(sel)
        # M[r, a, c] = A_ff[J_c, I_a] (the transposed local block), plus a
        # unit row per padded column so that z_pad == 0
        M = _csr_lookup(A_ff, Jc[:, None, :], Ic[:, :, None])  # [b, ic, kc]
        M *= (Im[:, :, None] & Jm[:, None, :])
        aug = np.broadcast_to(pad_eye, (b, kc, kc)) * ~Jm[:, None, :]
        M_ext = np.concatenate([M, aug], axis=1)    # [b, ic+kc, kc]
        rhs = -_csr_lookup(A_cf, np.broadcast_to(sel[:, None], Ic.shape), Ic)
        rhs *= Im
        rhs_ext = np.concatenate([rhs, np.zeros((b, kc))], axis=1)

        Q, R = np.linalg.qr(M_ext)                  # batched reduced QR
        qtb = np.einsum("bij,bi->bj", Q, rhs_ext)
        rdiag = np.abs(np.diagonal(R, axis1=1, axis2=2))
        good = rdiag.min(axis=1) > 1e-12 * np.maximum(rdiag.max(axis=1),
                                                      1e-300)
        with np.errstate(all="ignore"):
            z = np.linalg.solve(
                R + 1e-300 * np.broadcast_to(pad_eye, R.shape),
                qtb[..., None])[..., 0]
        good &= np.isfinite(z).all(axis=1)
        out_data[sel, :kc] = np.where(good[:, None], z, 0.0)
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
