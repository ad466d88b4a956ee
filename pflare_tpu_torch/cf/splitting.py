"""CF splitting entry point and the diagonally dominant submatrix.

Reference: src/CF_Splitting.F90:88-460 and src/MatDiagDomSubmatrix.F90,
ported from ``pflare_tpu.cf.splitting`` for one shard: every splitting
type (PMISR-DDC, DIAG_DOM, PMIS, PMIS_DIST2, AGG, PMIS_AGG, CR).  It is
the parity oracle of the port, so it reproduces the reference's markers
exactly.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..params import CFSplittingType, F_POINT, InverseType
from .aggregation import serial_aggregation
from .cr import CR_MAX_ITS, CR_POLY_ORDER, cr_pass
from .ddc import ddc
from .pmisr import pmisr
from .strength import strength_matrix


def first_pass_splitting(A, symmetric: bool, strong_threshold: float,
                         max_luby_steps: int, cf_splitting_type,
                         seed: int = 5) -> np.ndarray:
    """Strength matrix and first-pass splitting (reference:
    src/CF_Splitting.F90:88-230)."""
    t = CFSplittingType(cf_splitting_type)
    if t == CFSplittingType.PMIS_DIST2:
        S = strength_matrix(A, strong_threshold, symmetrize=True, square=True)
    elif t == CFSplittingType.PMIS:
        S = strength_matrix(A, strong_threshold, symmetrize=True)
    else:
        # for symmetric A the reference skips the symmetrization
        # (".NOT. symmetric", src/CF_Splitting.F90:142-154)
        S = strength_matrix(A, strong_threshold, symmetrize=not symmetric)
    if t in (CFSplittingType.PMISR_DDC, CFSplittingType.DIAG_DOM):
        return pmisr(S, max_luby_steps, pmis=False, seed=seed,
                     assume_symmetric=True)
    if t in (CFSplittingType.PMIS, CFSplittingType.PMIS_DIST2):
        return pmisr(S, max_luby_steps, pmis=True, seed=seed,
                     assume_symmetric=True)
    if t in (CFSplittingType.AGG, CFSplittingType.PMIS_AGG):
        # on one shard PMIS_AGG's boundary PMIS pass is empty: pure
        # aggregation (reference: src/CF_Splitting.F90:178-206)
        cf, _ = serial_aggregation(S)
        return cf
    raise ValueError(f"unknown CF splitting {t}")


def compute_cf_splitting(A, symmetric: bool = False,
                         strong_threshold: float = 0.5,
                         max_luby_steps: int = -1,
                         cf_splitting_type=CFSplittingType.PMISR_DDC,
                         ddc_its: int = 1, fraction_swap: float = 0.1,
                         seed: int = 5,
                         cr_inverse_type=InverseType.ARNOLDI,
                         cr_poly_order: int = CR_POLY_ORDER,
                         cr_sparsity_order: int = 1,
                         cr_diag_scale: bool = False):
    """Compute the CF splitting; returns (is_fine, is_coarse) index arrays
    (reference: src/CF_Splitting.F90:235-460)."""
    A = sp.csr_matrix(A)
    t = CFSplittingType(cf_splitting_type)

    if t == CFSplittingType.CR:
        # CR builds its splitting from scratch; strong_threshold carries the
        # target CR rate (reference: src/CF_Splitting.F90:303-346)
        cf = np.full(A.shape[0], F_POINT, dtype=np.int64)
        for _ in range(CR_MAX_ITS):
            cf, rate, n_swapped = cr_pass(
                A, cf, strong_threshold, cr_inverse_type, cr_poly_order,
                cr_sparsity_order, cr_diag_scale, seed=seed)
            if rate <= strong_threshold or n_swapped == 0:
                break
    else:
        cf = first_pass_splitting(A, symmetric, strong_threshold,
                                  max_luby_steps, t, seed=seed)

    if strong_threshold != 0.0 and t in (CFSplittingType.PMISR_DDC,
                                         CFSplittingType.DIAG_DOM):
        if t == CFSplittingType.DIAG_DOM:
            # iterate until the requested max ratio is reached
            while True:
                cf, max_achieved = ddc(A, cf, fraction_swap,
                                       max_dd_ratio=strong_threshold,
                                       seed=seed)
                if max_achieved < strong_threshold:
                    break
        else:
            for _ in range(ddc_its):
                cf, _ = ddc(A, cf, fraction_swap, seed=seed)

    return cf_to_is(cf)


def cf_to_is(cf_markers: np.ndarray):
    """(is_fine, is_coarse) index arrays from CF markers (reference:
    src/CF_Splitting.F90:31-84; non-F markers count as coarse)."""
    cf = np.asarray(cf_markers)
    fine = np.nonzero(cf == F_POINT)[0]
    coarse = np.nonzero(cf != F_POINT)[0]
    return fine, coarse


def compute_diag_dom_submatrix(A, max_dd_ratio: float,
                               fraction_swap: float = 0.1, seed: int = 5):
    """The largest submatrix whose diagonal-dominance ratios all lie below
    ``max_dd_ratio`` (reference: src/MatDiagDomSubmatrix.F90:17).
    Returns (submatrix, indices)."""
    A = sp.csr_matrix(A)
    fine, _ = compute_cf_splitting(
        A, symmetric=False, strong_threshold=max_dd_ratio,
        cf_splitting_type=CFSplittingType.DIAG_DOM,
        fraction_swap=fraction_swap, seed=seed)
    return sp.csr_matrix(A[fine][:, fine]), fine
