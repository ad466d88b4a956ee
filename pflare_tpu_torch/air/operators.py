"""AIR operator construction: W, Z, P, R, RAP.

Host setup phase (reference: src/AIR_Operators_Setup.F90,
src/Grid_Transfer.F90, src/Grid_Transfer_Improve.F90), ported from
``pflare_tpu.air.operators``: scipy products and the port's native host
kernels, in the precision of the input matrix, and with a row mesh the
products as row-sharded device products (``mesh_matmat_drop``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..inverse.sai import sai_z
from ..sparse.ops import (remove_from_sparse_match, remove_small_from_sparse,
                          symbolic_matmat)


def _matmat(A, B) -> sp.csr_matrix:
    """Host SpGEMM (scipy's csr_matmat)."""
    C = sp.csr_matrix(A @ B)
    C.sort_indices()
    return C


def ap_product(A: sp.csr_matrix, P: sp.csr_matrix) -> sp.csr_matrix:
    """AP = A @ P; when every row of P holds at most one entry (the
    one-point prolongator) one native relabel-and-merge sweep replaces the
    general SpGEMM (reference: src/AIR_Operators_Setup.F90:1006-1033)."""
    if np.diff(P.indptr).max(initial=0) <= 1:
        from ..native import ap_onepoint_native

        AP = ap_onepoint_native(A, P)
        if AP is not None:
            return AP
    return _matmat(A, P)


# when set to a list, mesh_matmat_drop appends (name, both operands
# row-sharded) per product, so a caller can see that a distributed setup
# multiplies only sharded operators
MESH_PRODUCT_LOG: list | None = None


def mesh_matmat_drop(Amat, Bmat, tol: float, lump: bool, mesh,
                     name: str = "") -> sp.csr_matrix:
    """C = drop(A @ B) as a row-sharded device product over the mesh, the
    analogue of the reference's MPI MatMatMult/MatPtAP with communicated
    halo rows (src/AIR_Operators_Setup.F90:993-1033): both operands upload
    to the mesh's device in their precision, rows padded to equal blocks,
    the neighbour-only halo product runs shard by shard
    (parallel/halo_spgemm.py) and the compacted result comes back.  Equal
    to the host product + relative drop, except that tol 0 drops the exact
    zeros scipy's product keeps in its pattern.  ``name`` labels the
    product in the mesh's log."""
    import torch.nn.functional as F

    from ..parallel.mesh import padded_rows
    from ..sparse.dell import DELL, PADCOL, ShardedDELL, spgemm_drop_dell
    from ..sparse.dtypes import torch_dtype

    np_dtype = np.result_type(Amat.dtype, Bmat.dtype)
    dtype = torch_dtype(np_dtype)

    def _up(M):
        d = DELL.from_scipy(M, dtype=dtype, device=mesh.device)
        p = padded_rows(d.data.shape[0], mesh) - d.data.shape[0]
        data = F.pad(d.data, (0, 0, 0, p))
        cols = F.pad(d.cols, (0, 0, 0, p), value=PADCOL)
        return ShardedDELL(data, cols, d.n_cols, mesh, name)

    Ad, Bd = _up(Amat), _up(Bmat)
    if MESH_PRODUCT_LOG is not None:
        MESH_PRODUCT_LOG.append(
            (name, isinstance(Ad, ShardedDELL) and isinstance(Bd,
                                                              ShardedDELL)))
    C = spgemm_drop_dell(Ad, Bd, float(tol), relative=True, lump=lump)
    out = sp.csr_matrix(C.to_scipy()[: Amat.shape[0]])
    out.sort_indices()
    return out.astype(np_dtype, copy=False)


def extract_submatrices(A: sp.csr_matrix, fine, coarse, need_acc=False):
    """A_ff, A_fc, A_cf and, with ``need_acc``, A_cc by CF masks
    (reference: src/AIR_Operators_Setup.F90:196-227): one streaming native
    pass, or scipy double slicing.  A_cc is None without ``need_acc``."""
    from ..native import split_cf_native

    out = split_cf_native(A, fine, coarse, need_acc)
    if out is not None:
        return out
    Af = A[fine]
    Ac = A[coarse]
    A_ff = sp.csr_matrix(Af[:, fine])
    A_fc = sp.csr_matrix(Af[:, coarse])
    A_cf = sp.csr_matrix(Ac[:, fine])
    A_cc = sp.csr_matrix(Ac[:, coarse]) if need_acc else None
    for M in (A_ff, A_fc, A_cf) + ((A_cc,) if need_acc else ()):
        M.sort_indices()
    return A_ff, A_fc, A_cf, A_cc


def strong_r_drop(A: sp.csr_matrix, fine, coarse, strong_r_threshold: float,
                  need_afc: bool):
    """Strong-R dropping of A, then the dropped submatrices (reference:
    src/AIR_Operators_Setup.F90:56-287).  Returns (A_ff_drop, A_cf_drop,
    A_fc_drop), all None at threshold 0; A_fc_drop is None without
    ``need_afc``."""
    if strong_r_threshold == 0.0:
        return None, None, None
    A_drop = remove_small_from_sparse(A, strong_r_threshold,
                                      relative_max_row_tol=1,
                                      drop_diagonal=0)
    A_ff_drop, A_fc_drop, A_cf_drop, _ = extract_submatrices(A_drop, fine,
                                                             coarse)
    return A_ff_drop, A_cf_drop, (A_fc_drop if need_afc else None)


def compute_z_airg(A_cf: sp.csr_matrix, inv_Aff: sp.csr_matrix,
                   r_drop: float | None = None):
    """AIRG restrictor block Z = -A_cf @ inv(A_ff) (reference:
    src/AIR_Operators_Setup.F90:784-795).  With ``r_drop`` the product and
    the relative row drop are fused in one native sweep when it can, else
    product then drop."""
    if r_drop is not None:
        from ..native import spgemm_drop_native

        Z = spgemm_drop_native(A_cf, inv_Aff, r_drop, relative=1, lump=0)
        if Z is not None:
            Z.data *= -1.0
            return Z
    Z = _matmat(A_cf, inv_Aff)
    Z.data *= -1.0
    if r_drop is None:
        return Z
    return remove_small_from_sparse(Z, r_drop, relative_max_row_tol=1)


def lair_sparsity(A_ff_drop, A_cf_drop, distance: int) -> sp.csr_matrix:
    """Distance-d lAIR sparsity A_cf_drop @ A_ff_drop^(d-1), symbolic
    (reference: src/AIR_Operators_Setup.F90:700-782)."""
    if distance == 1:
        return A_cf_drop
    P = A_ff_drop
    for _ in range(3, distance + 1):
        P = symbolic_matmat(A_ff_drop, P)
    return symbolic_matmat(A_cf_drop, P)


def compute_z_lair(A_ff, A_cf, A_ff_drop, A_cf_drop, distance: int,
                   incomplete: bool, sparsity=None):
    """lAIR (``incomplete``) or SAI-lAIR: per-row dense solves against the
    un-dropped blocks on the distance-d sparsity of the dropped ones
    (reference: src/AIR_Operators_Setup.F90:700-782).  A re-setup passes
    the stored ``sparsity`` and skips the symbolic products."""
    if sparsity is None:
        sparsity = lair_sparsity(A_ff_drop, A_cf_drop, distance)
    return sai_z(A_ff, A_cf, sparsity, incomplete=incomplete)


def compute_w_ideal(inv_Aff: sp.csr_matrix, A_fc_drop: sp.csr_matrix):
    """Ideal prolongator W = -inv(A_ff) @ A_fc (reference:
    src/AIR_Operators_Setup.F90:544-555)."""
    W = sp.csr_matrix(inv_Aff @ A_fc_drop)
    W.data *= -1.0
    W.sort_indices()
    return W


def improve_transfer(M: sp.csr_matrix, A_ff: sp.csr_matrix,
                     A_other: sp.csr_matrix, inv_diag: np.ndarray,
                     its: int, is_z: bool) -> sp.csr_matrix:
    """Fixed-sparsity Richardson improvement of W or Z (reference:
    src/Grid_Transfer_Improve.F90:25-376):
      W <- W - D (A_ff W + A_fc) |_S(W)
      Z <- Z - (Z A_ff + A_cf) D |_S(Z)
    with D the diagonal of the approximate inverse of A_ff (the reference
    always takes diag(A_ff_inv), :60-66)."""
    D = sp.diags(np.asarray(inv_diag).astype(M.data.dtype, copy=False))
    for _ in range(its):
        if is_z:
            resid = (M @ A_ff + A_other) @ D
        else:
            resid = D @ (A_ff @ M + A_other)
        M = remove_from_sparse_match(sp.csr_matrix(M - resid), M)
    return M


def assemble_p(W: sp.csr_matrix, fine, coarse, n: int) -> sp.csr_matrix:
    """P = [W; I] scattered to the full ordering: P[fine, :] = W,
    P[coarse, j] = 1 (reference: src/Grid_Transfer.F90:224)."""
    n_c = len(coarse)
    rows = np.concatenate([fine[_rows_of(W)], coarse])
    cols = np.concatenate([W.indices, np.arange(n_c)])
    vals = np.concatenate([W.data, np.ones(n_c, dtype=W.data.dtype)])
    P = sp.csr_matrix((vals, (rows, cols)), shape=(n, n_c))
    P.sort_indices()
    return P


def assemble_r(Z: sp.csr_matrix, fine, coarse, n: int) -> sp.csr_matrix:
    """R = [Z I] in the full column ordering: R[:, fine] = Z,
    R[i, coarse[i]] = 1 (reference: src/Grid_Transfer.F90:465)."""
    n_c = len(coarse)
    rows = np.concatenate([_rows_of(Z), np.arange(n_c)])
    cols = np.concatenate([fine[Z.indices], coarse])
    vals = np.concatenate([Z.data, np.ones(n_c, dtype=Z.data.dtype)])
    R = sp.csr_matrix((vals, (rows, cols)), shape=(n_c, n))
    R.sort_indices()
    return R


def compute_coarse_matrix(A, R, P, a_drop: float, a_lump: bool,
                          symmetric: bool = False, need_rap: bool = True):
    """drop(R @ (A @ P)) with a relative row tolerance and optional
    lumping (reference: src/AIR_Operators_Setup.F90:960-1082).  Symmetric
    PtAP is P^T (A P) with P = R^T: the same two products.  Otherwise,
    when the caller needs no undropped RAP, the second product and the
    drop fuse in one native sweep when it can (RAP is then None); tol 0
    still drops explicit zeros.  Returns (coarse, RAP, AP)."""
    AP = ap_product(A, P)
    if symmetric:
        RAP = _matmat(sp.csr_matrix(P.T).tocsr(), AP)
    else:
        if not need_rap:
            from ..native import spgemm_drop_native

            fused = spgemm_drop_native(R, AP, a_drop, relative=1,
                                       lump=a_lump)
            if fused is not None:
                return fused, None, AP
        RAP = _matmat(R, AP)
    coarse = remove_small_from_sparse(RAP, a_drop, relative_max_row_tol=1,
                                      lump=a_lump)
    return coarse, RAP, AP


def _rows_of(M: sp.csr_matrix):
    return np.repeat(np.arange(M.shape[0], dtype=np.int64), np.diff(M.indptr))
