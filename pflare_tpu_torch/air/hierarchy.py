"""AIR hierarchy setup: the level loop, on the host.

Reference: src/AIR_MG_Setup.F90:44-1231 (setup_air_pcmg), ported from
``pflare_tpu.air.hierarchy`` for the options of this slice: PMISR-DDC
splitting, one-point W, AIRG Z = -A_cf inv(A_ff), RAP with drop and lump,
F-point smoothing.  The host setup runs in the precision of the input
matrix; ``Hierarchy.to`` builds the device form of the solve.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from ..cf.splitting import SUPPORTED as CF_SUPPORTED, compute_cf_splitting
from ..inverse.build import Inverse, build_inverse
from ..options import AIROptions
from ..params import ZType
from ..sparse.ops import one_point_strongest
from ..utils.timers import timer
from .fullspace import build_fullspace_level, make_op
from .operators import (
    assemble_p,
    assemble_r,
    compute_coarse_matrix,
    compute_z_airg,
    extract_submatrices,
)


def check_options(opts: AIROptions):
    """Refuse options outside the ported slice (they wait for later
    slices), so no run silently computes something else."""
    unported = {
        "reorder": opts.reorder != "none",
        "coarse_repartition": bool(opts.coarse_repartition),
        "auto_truncate_start_level": opts.auto_truncate_start_level > 0,
        "cf_splitting_type": opts.cf_splitting_type not in CF_SUPPORTED,
        "smooth_order (C points)": opts.any_c_smooths,
        "full_smoothing_up_and_down": opts.full_smoothing_up_and_down,
        "symmetric": opts.symmetric,
        "one_point_classical_prolong": not opts.one_point_classical_prolong,
        "constrain_w/constrain_z": opts.constrain_w or opts.constrain_z,
        "improve_w_its/improve_z_its": (opts.improve_w_its > 0
                                        or opts.improve_z_its > 0),
        "strong_r_threshold": opts.strong_r_threshold != 0.0,
        "z_type": opts.z_type != ZType.PRODUCT,
        "reuse_sparsity": opts.reuse_sparsity,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            "options outside the ported slice: " + ", ".join(bad))


@dataclass
class LevelData:
    """Host record of one level: its operator and the compressed-space
    blocks, transfers and F-point inverse."""

    n: int
    fine: np.ndarray
    coarse: np.ndarray
    A: sp.csr_matrix
    A_ff: sp.csr_matrix
    A_fc: sp.csr_matrix
    A_cf: sp.csr_matrix
    R: sp.csr_matrix
    P: sp.csr_matrix
    inv_Aff: Inverse


@dataclass
class DeviceHierarchy:
    """What the solve runs: full-space level dicts, the coarse inverse and
    the finest operator (None when built without one)."""

    levels: list
    coarse_inv: Inverse
    top: object = None


@dataclass
class Hierarchy:
    levels: list            # list[LevelData]
    coarse_matrix: sp.csr_matrix
    coarse_inv: Inverse
    options: AIROptions

    @property
    def n_levels(self):
        return len(self.levels) + 1

    def to(self, device, dtype) -> DeviceHierarchy:
        """Upload: full-space level operators, the coarse inverse and the
        finest-level operator (built with ``make_op``, so a DIA top level
        runs its matvecs through the DIA kernel), as ``dtype`` on
        ``device``."""
        top = self.levels[0].A if self.levels else self.coarse_matrix
        return DeviceHierarchy(
            [build_fullspace_level(lvl, dtype, device) for lvl in self.levels],
            self.coarse_inv.to(device, dtype),
            make_op(top, dtype).to(device))


def _is_diagonal_only(A: sp.csr_matrix) -> bool:
    """MATDIAGONAL fast path detection (reference:
    src/C_PETSc_Routines.c:324, src/AIR_MG_Setup.F90:405-522)."""
    # a canonical CSR with more entries than rows holds an off-diagonal
    if A.nnz > A.shape[0]:
        return False
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    return bool(np.all(rows == A.indices))


def _diag_inverse(A: sp.csr_matrix) -> Inverse:
    d = np.where(A.diagonal() != 0, 1.0 / A.diagonal(), 0.0)
    return Inverse("diagonal", diag=d)


def _build_aff_inverse(A_ff, opts: AIROptions, matrix_free: bool):
    if _is_diagonal_only(A_ff):
        return _diag_inverse(A_ff)
    return build_inverse(
        A_ff, opts.inverse_type, poly_order=opts.poly_order,
        sparsity_order=opts.inverse_sparsity_order, matrix_free=matrix_free,
        diag_scale=opts.diag_scale_polys, seed=opts.seed)


def _assembled_host(inv: Inverse) -> sp.csr_matrix:
    if inv.kind == "diagonal":
        return sp.diags(inv.diag).tocsr()
    return inv.host_csr


def setup_hierarchy(A: sp.csr_matrix, opts: AIROptions) -> Hierarchy:
    """Build the full AIR hierarchy of ``A`` on the host."""
    check_options(opts)
    A = sp.csr_matrix(A)
    A.sort_indices()
    levels: list[LevelData] = []
    while len(levels) < opts.max_levels - 1:
        with timer("air_coarsen"):
            fine, coarse = compute_cf_splitting(
                A, opts.symmetric, opts.strong_threshold,
                opts.max_luby_steps, opts.cf_splitting_type,
                opts.ddc_its, opts.ddc_fraction, seed=opts.seed)
        # coarsen-or-stop (reference: src/AIR_MG_Setup.F90:316-363)
        if len(coarse) <= opts.coarse_eq_limit or len(fine) == 0:
            break
        lvl, A = _build_level(A, fine, coarse, opts)
        levels.append(lvl)

    with timer("air_inverse"):
        if _is_diagonal_only(A):
            coarse_inv = _diag_inverse(A)
        else:
            coarse_inv = build_inverse(
                A, opts.coarsest_inverse_type,
                poly_order=opts.coarsest_poly_order,
                sparsity_order=opts.coarsest_inverse_sparsity_order,
                matrix_free=opts.coarsest_matrix_free_polys,
                diag_scale=opts.coarsest_diag_scale_polys, seed=opts.seed)
    return Hierarchy(levels, A, coarse_inv, opts)


def _build_level(A, fine, coarse, opts: AIROptions):
    """One level's operators (reference: src/AIR_Operators_Setup.F90:
    36-1082); returns (LevelData, coarse matrix)."""
    n = A.shape[0]
    with timer("air_extract"):
        A_ff, A_fc, A_cf = extract_submatrices(A, fine, coarse)

    with timer("air_inverse"):
        inv_Aff = _build_aff_inverse(A_ff, opts, opts.matrix_free_polys)
        # AIRG needs an ASSEMBLED inverse of A_ff for Z (reference:
        # src/AIR_Operators_Setup.F90:406-475): a matrix-free smoother's
        # inverse is rebuilt assembled for it (LU's dense inverse carries
        # its host_csr)
        if inv_Aff.kind in ("assembled", "diagonal", "dense"):
            inv_dropped = inv_Aff
        else:
            inv_dropped = _build_aff_inverse(A_ff, opts, matrix_free=False)
        inv_Aff_host = _assembled_host(inv_dropped)

    with timer("air_prolong"):
        W = one_point_strongest(A_fc)
    with timer("air_restrict"):
        Z = compute_z_airg(A_cf, inv_Aff_host, opts.r_drop)
        R = assemble_r(Z, fine, coarse, n)
    with timer("air_prolong"):
        P = assemble_p(W, fine, coarse, n)
    with timer("air_rap"):
        coarse_A = compute_coarse_matrix(A, R, P, opts.a_drop, opts.a_lump)
    lvl = LevelData(n=n, fine=fine, coarse=coarse, A=A, A_ff=A_ff, A_fc=A_fc,
                    A_cf=A_cf, R=R, P=P, inv_Aff=inv_Aff)
    return lvl, coarse_A
