"""Host-side sparse utility layer (setup phase).

Vectorised numpy/scipy re-implementations of the reference's sparse helper
semantics (reference: src/PETSc_Helper.F90).  These run in the host
half of setup; the resulting matrices become the device operators of the
solve.

All functions take and return ``scipy.sparse.csr_matrix``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _canon(A: sp.csr_matrix) -> sp.csr_matrix:
    A = sp.csr_matrix(A)
    A.sort_indices()
    return A


def row_of_entries(A: sp.csr_matrix) -> np.ndarray:
    return np.repeat(np.arange(A.shape[0], dtype=np.int64), np.diff(A.indptr))


def remove_small_from_sparse(
    A,
    tol: float,
    relative_max_row_tol: int = 0,
    lump: bool = False,
    drop_diagonal: int = 0,
    diag_strength: bool = False,
) -> sp.csr_matrix:
    """Drop small entries (reference: src/PETSc_Helper.F90:207-412).

    relative_max_row_tol: 1 = tol is relative to the max abs row entry
    (including diagonal); -1 = relative excluding the diagonal; 0 = absolute.
    drop_diagonal: 0 = never drop the diagonal, 1 = allow, -1 = always drop.
    lump: dropped entries are added onto the diagonal.
    diag_strength: threshold is measured against |a_ii| instead of row max.
    Exact zeros in the input are always dropped (MAT_IGNORE_ZERO_ENTRIES).
    """
    A = _canon(A)
    if lump and drop_diagonal == 1:
        raise ValueError("cannot lump and drop the diagonal")
    from ..native import drop_small_native

    nat = drop_small_native(
        A, tol, relative_max_row_tol, diag_strength, drop_diagonal, lump
    )
    if nat is not None:
        return nat
    n_rows, n_cols = A.shape
    data = A.data
    rows = row_of_entries(A)
    cols = A.indices
    absval = np.abs(data)
    is_diag = cols == rows

    # Per-row threshold
    if relative_max_row_tol != 0:
        if diag_strength:
            diagv = np.zeros(n_rows)
            diagv[rows[is_diag]] = absval[is_diag]
            row_tol = tol * diagv
        elif relative_max_row_tol == 1:
            row_max = np.zeros(n_rows)
            np.maximum.at(row_max, rows, absval)
            row_tol = tol * row_max
        else:  # -1: exclude diagonal from the max
            row_max = np.full(n_rows, -np.inf)
            off = ~is_diag
            np.maximum.at(row_max, rows[off], absval[off])
            row_max[~np.isfinite(row_max)] = 0.0
            row_tol = tol * row_max
        thresh = row_tol[rows]
    else:
        thresh = np.full(data.shape, tol)

    keep = absval >= thresh
    if drop_diagonal == -1:
        keep = keep & ~is_diag
    elif drop_diagonal == 0:
        keep = keep | is_diag

    # Drop exact zeros regardless
    keep = keep & (data != 0)

    if not lump:
        # CSR-structure-preserving compression: no COO round trip.
        # Per-row kept counts via a prefix sum over the keep mask.
        csum = np.concatenate([[0], np.cumsum(keep, dtype=np.int64)])
        counts = csum[A.indptr[1:]] - csum[A.indptr[:-1]]
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(A.indptr.dtype)
        out = sp.csr_matrix(
            (data[keep], cols[keep], indptr), shape=(n_rows, n_cols)
        )
        out.has_sorted_indices = True
        return out

    out_rows = rows[keep]
    out_cols = cols[keep]
    out_vals = data[keep]
    dropped = ~keep & (data != 0)
    if np.any(dropped):
        lump_rows = rows[dropped]
        lump_vals = data[dropped]
        out_rows = np.concatenate([out_rows, lump_rows])
        out_cols = np.concatenate([out_cols, lump_rows])
        out_vals = np.concatenate([out_vals, lump_vals])

    out = sp.csr_matrix(
        (out_vals, (out_rows, out_cols)), shape=(n_rows, n_cols)
    )
    out.sum_duplicates()
    out.sort_indices()
    return out


def remove_from_sparse_match(A, pattern_mat, lump: bool = False,
                             alpha: float | None = None) -> sp.csr_matrix:
    """Restrict the values of A onto the sparsity of ``pattern_mat``
    (reference: src/PETSc_Helper.F90:490).  With ``lump`` the entries of A
    outside the pattern are added to the output diagonal.  With ``alpha``
    the result is ``pattern_mat + alpha * A|pattern``; otherwise values are
    replaced (pattern entries absent from A become 0)."""
    A = _canon(A)
    P = _canon(pattern_mat)
    n_rows, n_cols = P.shape

    a_rows = row_of_entries(A)
    keysP = row_of_entries(P) * np.int64(n_cols) + P.indices
    keysA = a_rows * np.int64(n_cols) + A.indices
    pos = np.searchsorted(keysP, keysA)
    pos_c = np.minimum(pos, max(len(keysP) - 1, 0))
    inside = (len(keysP) > 0) & (keysP[pos_c] == keysA)

    new_data = np.zeros(P.nnz, dtype=A.data.dtype)
    # canonical CSR keys are unique, so plain fancy assignment is exact
    new_data[pos_c[inside]] = A.data[inside]
    if alpha is not None:
        new_data = P.data + alpha * new_data

    out = sp.csr_matrix((new_data, P.indices.copy(), P.indptr.copy()),
                        shape=P.shape)
    if lump:
        outside = ~inside
        if np.any(outside):
            lump_vec = np.bincount(a_rows[outside], weights=A.data[outside],
                                   minlength=n_rows)
            dpos = _diag_positions(P)
            has_diag = dpos >= 0
            out.data[dpos[has_diag]] += lump_vec[has_diag]
    return out


def _diag_positions(P: sp.csr_matrix) -> np.ndarray:
    """Entry position of each row's diagonal in a canonical csr, -1 where
    the row holds none."""
    n_rows, n_cols = P.shape
    n = min(n_rows, n_cols)
    keys = row_of_entries(P) * np.int64(n_cols) + P.indices
    q = (np.arange(n, dtype=np.int64) * np.int64(n_cols)
         + np.arange(n, dtype=np.int64))
    pos = np.searchsorted(keys, q)
    pos_c = np.minimum(pos, max(len(keys) - 1, 0))
    ok = (len(keys) > 0) & (keys[pos_c] == q)
    out = np.full(n_rows, -1, dtype=np.int64)
    out[:n] = np.where(ok, pos_c, -1)
    return out


def duplicate_plus_diag(A) -> sp.csr_matrix:
    """A copy of A that holds every diagonal entry, zero where A had none
    (reference: src/PETSc_Helper.F90:834)."""
    A = _canon(A)
    n = min(A.shape)
    d = sp.csr_matrix(
        (np.zeros(n, dtype=A.data.dtype), (np.arange(n), np.arange(n))),
        shape=A.shape)
    return _canon(A + d)


def identity_csr(n: int, value: float = 1.0) -> sp.csr_matrix:
    return sp.csr_matrix(
        (np.full(n, value), (np.arange(n), np.arange(n))), shape=(n, n))


def symbolic_matmat(A, B) -> sp.csr_matrix:
    """Symbolic SpGEMM: the pattern of A @ B with unit values (reference:
    src/PETSc_Helper.F90:1639)."""
    Ab = sp.csr_matrix(
        (np.ones(A.nnz, dtype=np.float64), A.indices, A.indptr), shape=A.shape)
    Bb = sp.csr_matrix(
        (np.ones(B.nnz, dtype=np.float64), B.indices, B.indptr), shape=B.shape)
    C = _canon(Ab @ Bb)
    C.data[:] = 1.0
    return C


def one_point_strongest(A_fc) -> sp.csr_matrix:
    """One-point classical prolongator W: strongest |entry| per row -> 1.0
    (reference: src/Grid_Transfer.F90:26).  Rows with no entries stay empty."""
    A = _canon(A_fc)
    n_rows, n_cols = A.shape
    if A.nnz == 0:
        return sp.csr_matrix(A.shape)
    from ..native import one_point_strongest_native

    nat = one_point_strongest_native(A)
    if nat is not None:
        return nat
    rows = row_of_entries(A)
    absval = np.abs(A.data)
    row_max = np.full(n_rows, -1.0)
    np.maximum.at(row_max, rows, absval)
    # First position achieving the row max (deterministic tie-break: the
    # lowest column index, since CSR entries are column-sorted)
    is_max = absval == row_max[rows]
    order = np.arange(A.nnz)
    cand = order[is_max]
    cand_rows = rows[is_max]
    _, first_idx = np.unique(cand_rows, return_index=True)
    sel = cand[first_idx]
    out_rows = rows[sel]
    out_cols = A.indices[sel]
    out = sp.csr_matrix(
        (np.ones(len(sel), dtype=A.data.dtype), (out_rows, out_cols)),
        shape=A.shape
    )
    out.sort_indices()
    return out


def diag_dominance_ratio(A, f_mask: np.ndarray) -> np.ndarray:
    """Row ratio sum_{j in F, j!=i} |a_ij| / |a_ii| over F rows of A
    (reference: src/MatDiagDom.F90:98).  Returns an array over F rows in
    order of their appearance.  Rows with a single diagonal entry give 0."""
    A = _canon(A)
    from ..native import dd_ratio_native

    nat = dd_ratio_native(A.indptr, A.indices, A.data, f_mask)
    if nat is not None:
        return nat[np.asarray(f_mask, dtype=bool)]
    rows = row_of_entries(A)
    cols = A.indices
    absval = np.abs(A.data)
    is_diag = cols == rows
    fr = f_mask[rows] & f_mask[cols] & ~is_diag
    offsum = np.zeros(A.shape[0])
    np.add.at(offsum, rows[fr], absval[fr])
    diagv = np.zeros(A.shape[0])
    dd = is_diag & f_mask[rows]
    diagv[rows[dd]] = absval[dd]
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(diagv > 0, offsum / diagv, np.where(offsum > 0, np.inf, 0.0))
    return ratio[f_mask]
