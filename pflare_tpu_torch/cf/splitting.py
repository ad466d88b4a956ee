"""CF splitting entry point and the diagonally dominant submatrix.

Reference: src/CF_Splitting.F90:88-460 and src/MatDiagDomSubmatrix.F90,
ported from ``pflare_tpu.cf.splitting``: every splitting type
(PMISR-DDC, DIAG_DOM, PMIS, PMIS_DIST2, AGG, PMIS_AGG, CR).  It is the
parity oracle of the port, so it reproduces the reference's markers
exactly.  With a row mesh (parallel/mesh.py) the Luby rounds run sharded
on the mesh's device and the aggregations shard-locally, as the
reference's distributed splittings do.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..params import CFSplittingType, F_POINT, InverseType
from ..sparse.dell import PADCOL
from .aggregation import serial_aggregation
from .cr import CR_MAX_ITS, CR_POLY_ORDER, cr_pass
from .ddc import ddc
from .pmisr import pmisr
from .strength import strength_matrix


def first_pass_splitting(A, symmetric: bool, strong_threshold: float,
                         max_luby_steps: int, cf_splitting_type,
                         seed: int = 5, mesh=None) -> np.ndarray:
    """Strength matrix and first-pass splitting (reference:
    src/CF_Splitting.F90:88-230).  ``mesh``: the distributed splitting
    (``_pmisr_sharded``, ``_agg_sharded``)."""
    t = CFSplittingType(cf_splitting_type)
    if t == CFSplittingType.PMIS_DIST2:
        S = strength_matrix(A, strong_threshold, symmetrize=True, square=True)
    elif t == CFSplittingType.PMIS:
        S = strength_matrix(A, strong_threshold, symmetrize=True)
    else:
        # for symmetric A the reference skips the symmetrization
        # (".NOT. symmetric", src/CF_Splitting.F90:142-154)
        S = strength_matrix(A, strong_threshold, symmetrize=not symmetric)
    if t in (CFSplittingType.PMISR_DDC, CFSplittingType.DIAG_DOM,
             CFSplittingType.PMIS, CFSplittingType.PMIS_DIST2):
        pmis = t in (CFSplittingType.PMIS, CFSplittingType.PMIS_DIST2)
        if mesh is not None:
            return _pmisr_sharded(S, max_luby_steps, pmis, seed, mesh)
        return pmisr(S, max_luby_steps, pmis=pmis, seed=seed,
                     assume_symmetric=True)
    if t in (CFSplittingType.AGG, CFSplittingType.PMIS_AGG):
        if mesh is not None:
            return _agg_sharded(S, mesh, t == CFSplittingType.PMIS_AGG,
                                max_luby_steps, seed)
        # on one shard PMIS_AGG's boundary PMIS pass is empty: pure
        # aggregation (reference: src/CF_Splitting.F90:178-206)
        cf, _ = serial_aggregation(S)
        return cf
    raise ValueError(f"unknown CF splitting {t}")


def _agg_sharded(S, mesh, boundary_pmis: bool, max_luby_steps: int,
                 seed: int) -> np.ndarray:
    """Distributed aggregation over the mesh's row blocks (reference:
    src/CF_Splitting.F90:162-225): PMIS_AGG first runs PMIS over the
    shard-boundary nodes (those with a strong connection across a block
    edge, the processor-boundary set the reference marks through its
    halo exchange), then each shard aggregates its diagonal block with
    those markers pinned; plain AGG aggregates rank-locally alone."""
    S = sp.csr_matrix(S)
    n = S.shape[0]
    bounds = np.linspace(0, n, mesh.size + 1).astype(np.int64)
    shard_of = np.searchsorted(bounds, np.arange(n), side="right") - 1
    rows = np.repeat(np.arange(n), np.diff(S.indptr))
    cross = shard_of[rows] != shard_of[S.indices]
    cf = np.zeros(n, dtype=np.int64)
    if boundary_pmis and cross.any():
        boundary = np.zeros(n, dtype=bool)
        boundary[rows[cross]] = True
        boundary[S.indices[cross]] = True
        bidx = np.nonzero(boundary)[0]
        cf[bidx] = pmisr(sp.csr_matrix(S[bidx][:, bidx]), max_luby_steps,
                         pmis=True, seed=seed, assume_symmetric=True)
    for s in range(mesh.size):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        if hi > lo:
            cf[lo:hi] = serial_aggregation(sp.csr_matrix(S[lo:hi, lo:hi]),
                                           cf_markers=cf[lo:hi])[0]
    return cf


def _pmisr_sharded(S, max_luby_steps: int, pmis: bool, seed: int,
                   mesh) -> np.ndarray:
    """PMISR (or PMIS) Luby rounds sharded over the mesh on its device
    (cf/device.py::luby_rounds), with the host path's measure:
    the markers equal the host's in f64 (reference:
    pflare_tpu/cf/splitting.py:114-152, which runs 25 rounds when the
    host would run to the end)."""
    import torch

    from .device import graph_to_device, luby_rounds

    S = sp.csr_matrix(S)
    n = S.shape[0]
    cols, mask = graph_to_device(S, mesh.device)
    measure = np.random.default_rng(seed).random(n) + np.diff(S.indptr)
    if pmis:
        measure = -measure
    cf = luby_rounds(
        torch.where(mask, cols, PADCOL),
        torch.as_tensor(measure, dtype=torch.float64, device=mesh.device),
        torch.zeros(n, dtype=torch.int32, device=mesh.device),
        max_luby_steps if max_luby_steps > 0 else 25, pmis=pmis, mesh=mesh)
    cf = cf.cpu().numpy().astype(np.int64)
    return -cf if pmis else cf


def compute_cf_splitting(A, symmetric: bool = False,
                         strong_threshold: float = 0.5,
                         max_luby_steps: int = -1,
                         cf_splitting_type=CFSplittingType.PMISR_DDC,
                         ddc_its: int = 1, fraction_swap: float = 0.1,
                         seed: int = 5,
                         cr_inverse_type=InverseType.ARNOLDI,
                         cr_poly_order: int = CR_POLY_ORDER,
                         cr_sparsity_order: int = 1,
                         cr_diag_scale: bool = False, mesh=None):
    """Compute the CF splitting; returns (is_fine, is_coarse) index arrays
    (reference: src/CF_Splitting.F90:235-460).  ``mesh``: a row mesh for
    the distributed splitting (the first pass only; CR and the DDC
    swaps stay on the host)."""
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
                                  max_luby_steps, t, seed=seed, mesh=mesh)

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
