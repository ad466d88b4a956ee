"""Near-nullspace constraints on Z and W, on the host.

Reference: src/Constrain_Z_or_W.F90, ported from
``pflare_tpu.air.constrain``.  ``smooth_near_nullspace`` refines the
candidate vectors with 15 self-scaled Jacobi-Richardson sweeps on Ax = 0
(transpose solves for the left vectors); ``constrain_grid_transfer``
applies the one-step orthogonal-projector correction (Olson 2011 eq. 3.2)
so that W interpolates the right vectors (W B_c = B_f) and Z^T restricts
the left ones.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..params import tolerances

SMOOTH_ITS = 15


def _pinv_abs_batched(G: np.ndarray, tol: float) -> np.ndarray:
    """Batched pseudo-inverse with the reference's ABSOLUTE singular-value
    cutoff (src/PETSc_Helper.F90:1583 pseudo_inv, PFLARE_TOL_SIGMA_DROP):
    sigma <= tol contributes nothing.  numpy's relative rcond would invert
    uniformly tiny Gram matrices and blow the correction up on decayed
    candidates."""
    U, S, Vt = np.linalg.svd(G)
    with np.errstate(over="ignore", divide="ignore"):
        Sinv = np.where(np.abs(S) > tol, 1.0 / np.where(S != 0, S, 1.0), 0.0)
    return np.einsum("rij,rj,rkj->rik", Vt.transpose(0, 2, 1), Sinv, U)


def _richardson_smooth(A: sp.csr_matrix, v: np.ndarray,
                       transpose: bool) -> np.ndarray:
    """Self-scaled Richardson with Jacobi on Ax = 0 from the guess v
    (reference: src/Constrain_Z_or_W.F90:118-218)."""
    M = A.T.tocsr() if transpose else A
    d = M.diagonal()
    dinv = np.where(d != 0, 1.0 / d, 0.0)
    x = v.copy()
    for _ in range(SMOOTH_ITS):
        r = -(M @ x)
        z = dinv * r
        Az = M @ z
        denom = float(Az @ Az)
        if denom == 0.0:
            break
        x = x + float(Az @ r) / denom * z
    return x


def smooth_near_nullspace(A, left_nulls, right_nulls):
    """Smooth the candidate near-nullspace vectors, in place."""
    A = sp.csr_matrix(A)
    if left_nulls is not None:
        for i, v in enumerate(left_nulls):
            left_nulls[i] = _richardson_smooth(A, v, transpose=True)
    if right_nulls is not None:
        for i, v in enumerate(right_nulls):
            right_nulls[i] = _richardson_smooth(A, v, transpose=False)


def constrain_grid_transfer(z_or_w: sp.csr_matrix, nulls_row, nulls_col,
                            is_z: bool) -> sp.csr_matrix:
    """Row-wise least-squares correction on the fixed sparsity,
      M_i <- M_i - (M_i B_J - b_i) pinv(B_J^T B_J) B_J^T
    over each row's support J; Z is corrected by columns, through its
    transpose (reference: src/Constrain_Z_or_W.F90:223-330).  ``nulls_row``
    holds the targets on the row space (B_f), ``nulls_col`` the values on
    the column space (B_c)."""
    M = sp.csr_matrix(z_or_w)
    if is_z:
        M = sp.csr_matrix(M.T)
    M.sort_indices()
    B_col = np.stack(nulls_col, axis=1)     # [n_cols, k]
    B_row = np.stack(nulls_row, axis=1)     # [n_rows, k]

    indptr, indices, data = M.indptr, M.indices, M.data.copy()
    # rows of equal support size share one batched pseudo-inverse
    row_len = np.diff(indptr)
    for m in np.unique(row_len):
        if m == 0:
            continue
        rows = np.nonzero(row_len == m)[0]
        idx = indptr[rows][:, None] + np.arange(m)[None, :]
        Bj = B_col[indices[idx]]                # [R, m, k]
        G = np.einsum("rmk,rml->rkl", Bj, Bj)   # [R, k, k]
        vals = data[idx]                        # [R, m]
        diff = np.einsum("rm,rmk->rk", vals, Bj) - B_row[rows]
        piv = _pinv_abs_batched(G, tolerances(data.dtype).sigma_drop)
        corr = np.einsum("rkl,rl->rk", piv, diff)
        data[idx] = vals - np.einsum("rmk,rk->rm", Bj, corr)
    out = sp.csr_matrix((data, indices.copy(), indptr.copy()), shape=M.shape)
    if is_z:
        out = sp.csr_matrix(out.T)
    out.sort_indices()
    return out
