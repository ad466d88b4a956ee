"""Strength-of-connection matrix (SAbs).

Reference: src/SAbs.F90:16-144.  |a_ij| >= theta * max_{j!=i}|a_ij| keeps an
edge; diagonal dropped; optional symmetrize (S + S^T) and square
(S S + S, or S^T S + S without symmetrizing) for distance-2 coarsening; all
kept values are 1.
"""

from __future__ import annotations

import scipy.sparse as sp

from ..sparse.ops import remove_small_from_sparse


def strength_matrix(A, theta: float, symmetrize: bool = True,
                    square: bool = False,
                    diag_strength: bool = False) -> sp.csr_matrix:
    S = remove_small_from_sparse(
        A, theta, relative_max_row_tol=-1, lump=False, drop_diagonal=-1,
        diag_strength=diag_strength)
    if symmetrize:
        from ..native import symmetrize_pattern_native

        # values are overwritten with 1.0, so only the union PATTERN
        # matters: one native transpose+merge pass when available
        Su = symmetrize_pattern_native(S)
        S = Su if Su is not None else sp.csr_matrix(S + S.T)
        # unit values BEFORE squaring: the scipy fallback's S + S.T keeps
        # signed sums whose cancellation zeros eliminate_zeros() would
        # prune, and the distance-2 pattern would leave the native one's
        S.data[:] = 1.0
    if square:
        S2 = sp.csr_matrix(S @ S) if symmetrize else sp.csr_matrix(S.T @ S)
        S = sp.csr_matrix(S2 + S)
        S.setdiag(0.0)
        S.eliminate_zeros()
    if symmetrize or square:
        S.data[:] = 1.0
    S.sort_indices()
    return S
