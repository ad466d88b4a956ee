"""AIR hierarchy setup: the level loop, on the host.

Reference: src/AIR_MG_Setup.F90:44-1231 (setup_air_pcmg), ported from
``pflare_tpu.air.hierarchy`` for one device and without sparsity reuse:
every CF splitting, AIRG / lAIR / SAI-lAIR restriction with strong-R
dropping, one-point or ideal prolongation with improvement and
near-nullspace constraints, symmetric PtAP, C-point and full smoothing
inverses, auto-truncation and the RCM coarse repartition.  The host setup
runs in the precision of the input matrix; ``Hierarchy.to`` builds the
device form of the solve.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..cf.splitting import compute_cf_splitting
from ..inverse.build import Inverse, build_inverse
from ..options import AIROptions
from ..params import ZType
from ..sparse.ops import one_point_strongest, remove_small_from_sparse
from ..utils.timers import timer
from .constrain import constrain_grid_transfer, smooth_near_nullspace
from .fullspace import build_fullspace_level, build_full_smoothing_level, make_op
from .operators import (
    assemble_p,
    assemble_r,
    compute_coarse_matrix,
    compute_w_ideal,
    compute_z_airg,
    compute_z_lair,
    extract_submatrices,
    improve_transfer,
    strong_r_drop,
)


def check_options(opts: AIROptions):
    """Refuse the one option outside the port (sparsity reuse waits for a
    later slice), so no run silently computes something else."""
    if opts.reuse_sparsity:
        raise NotImplementedError(
            "options outside the port: reuse_sparsity")


@dataclass
class LevelData:
    """Host record of one level: its operator, the compressed-space
    blocks, transfers and inverses.  ``A_cf``, ``A_cc`` and ``inv_Acc``
    are kept only when a C-point smooth needs them; ``coarse_order`` is
    the repartitioned order the next level lives in (None: sorted)."""

    n: int
    fine: np.ndarray
    coarse: np.ndarray
    A: sp.csr_matrix
    A_ff: sp.csr_matrix
    A_fc: sp.csr_matrix
    A_cf: sp.csr_matrix | None
    A_cc: sp.csr_matrix | None
    R: sp.csr_matrix
    P: sp.csr_matrix
    inv_Aff: Inverse
    inv_Acc: Inverse | None = None
    coarse_order: np.ndarray | None = None


@dataclass
class DeviceHierarchy:
    """What the solve runs: the level dicts (full-space form, or the
    full-smoothing form), the coarse inverse and the finest operator (None
    when built without one)."""

    levels: list
    coarse_inv: Inverse
    top: object = None
    full_smoothing: bool = False


@dataclass
class Hierarchy:
    levels: list            # list[LevelData]
    coarse_matrix: sp.csr_matrix
    coarse_inv: Inverse
    options: AIROptions
    auto_truncated: bool = False

    @property
    def n_levels(self):
        return len(self.levels) + 1

    def to(self, device, dtype) -> DeviceHierarchy:
        """Upload: the level operators, the coarse inverse and the
        finest-level operator (built with ``make_op``, so a DIA top level
        runs its matvecs through the DIA kernel), as ``dtype`` on
        ``device``."""
        full = self.options.full_smoothing_up_and_down
        build = build_full_smoothing_level if full else build_fullspace_level
        top = self.levels[0].A if self.levels else self.coarse_matrix
        return DeviceHierarchy(
            [build(lvl, dtype, device) for lvl in self.levels],
            self.coarse_inv.to(device, dtype),
            make_op(top, dtype).to(device), full)


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


def _build_smoother_inverse(M, opts: AIROptions, inverse_type, poly_order,
                            sparsity_order, matrix_free):
    if _is_diagonal_only(M):
        return _diag_inverse(M)
    return build_inverse(
        M, inverse_type, poly_order=poly_order, sparsity_order=sparsity_order,
        matrix_free=matrix_free, diag_scale=opts.diag_scale_polys,
        seed=opts.seed)


def _build_coarse_inverse(A, opts: AIROptions) -> Inverse:
    return build_inverse(
        A, opts.coarsest_inverse_type, poly_order=opts.coarsest_poly_order,
        sparsity_order=opts.coarsest_inverse_sparsity_order,
        matrix_free=opts.coarsest_matrix_free_polys,
        diag_scale=opts.coarsest_diag_scale_polys, seed=opts.seed)


def _assembled_host(inv: Inverse) -> sp.csr_matrix:
    if inv.kind == "diagonal":
        return sp.diags(inv.diag).tocsr()
    return inv.host_csr


def _coarse_solver_quality(A: sp.csr_matrix, inv: Inverse, seed: int) -> float:
    """Relative residual of the coarse solver on a random RHS, applied on
    the CPU in f64 (the auto-truncation probe, reference:
    src/AIR_MG_Setup.F90:158-256)."""
    b = np.random.default_rng(seed + 101).standard_normal(A.shape[0])
    x = inv.to(torch.device("cpu"), torch.float64).apply(
        torch.from_numpy(b)).numpy()
    return float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))


def setup_hierarchy(A: sp.csr_matrix, opts: AIROptions,
                    near_nullspace=None) -> Hierarchy:
    """Build the full AIR hierarchy of ``A`` on the host.
    ``near_nullspace``: the candidate vectors of the constraints (default
    the constant vector)."""
    check_options(opts)
    A = sp.csr_matrix(A)
    A.sort_indices()
    levels: list[LevelData] = []
    auto_truncated = False
    coarse_inv = None

    # near-nullspace vectors for the constraints (reference:
    # src/Constrain_Z_or_W.F90:19-118)
    left_nulls = right_nulls = None
    if opts.constrain_z or opts.constrain_w:
        if near_nullspace is None:
            near_nullspace = [np.ones(A.shape[0])]
        if opts.constrain_z:
            left_nulls = [np.array(v, dtype=np.float64)
                          for v in near_nullspace]
        if opts.constrain_w:
            right_nulls = [np.array(v, dtype=np.float64)
                           for v in near_nullspace]

    repartition = opts.coarse_repartition
    if repartition is None:
        repartition = opts.reorder in ("auto", "rcm")

    while len(levels) < opts.max_levels - 1:
        # auto-truncation: stop where the coarse solver alone is good
        # enough (reference: src/AIR_MG_Setup.F90:158-256)
        if (opts.auto_truncate_start_level > 0
                and len(levels) + 1 >= opts.auto_truncate_start_level):
            with timer("air_inverse"):
                probe = _build_coarse_inverse(A, opts)
            if _coarse_solver_quality(A, probe, opts.seed) <= \
                    opts.auto_truncate_tol:
                auto_truncated = True
                coarse_inv = probe
                break

        with timer("air_coarsen"):
            fine, coarse = compute_cf_splitting(
                A, opts.symmetric, opts.strong_threshold,
                opts.max_luby_steps, opts.cf_splitting_type,
                opts.ddc_its, opts.ddc_fraction, seed=opts.seed,
                cr_inverse_type=opts.inverse_type,
                cr_poly_order=opts.poly_order,
                cr_sparsity_order=opts.inverse_sparsity_order,
                cr_diag_scale=opts.diag_scale_polys)
        # coarsen-or-stop (reference: src/AIR_MG_Setup.F90:316-363)
        if len(coarse) <= opts.coarse_eq_limit or len(fine) == 0:
            break
        lvl, A = _build_level(A, fine, coarse, opts, left_nulls, right_nulls)
        levels.append(lvl)

        # RCM coarse repartition (the ParMETIS stand-in, reference:
        # src/C_PETSc_Routines.c:17-175): the next level lives in the
        # permuted coarse order; the transfers' gathers carry the basis
        # change and every level-local block keeps the sorted order
        coarse_used = coarse
        if repartition and not opts.full_smoothing_up_and_down:
            from ..parallel.repartition import coarse_repartition_perm

            with timer("air_repartition"):
                perm = coarse_repartition_perm(A)
            if perm is not None:
                lvl.coarse_order = np.asarray(coarse)[perm]
                coarse_used = lvl.coarse_order
                A = sp.csr_matrix(A[perm][:, perm])
                A.sort_indices()
        if left_nulls is not None:
            left_nulls = [v[coarse_used] for v in left_nulls]
        if right_nulls is not None:
            right_nulls = [v[coarse_used] for v in right_nulls]

    if coarse_inv is None:
        with timer("air_inverse"):
            coarse_inv = (_diag_inverse(A) if _is_diagonal_only(A)
                          else _build_coarse_inverse(A, opts))
    return Hierarchy(levels, A, coarse_inv, opts,
                     auto_truncated=auto_truncated)


def _build_level(A, fine, coarse, opts: AIROptions, left_nulls=None,
                 right_nulls=None):
    """One level's operators (reference: src/AIR_Operators_Setup.F90:
    36-1082); returns (LevelData, coarse matrix)."""
    n = A.shape[0]
    if left_nulls is not None or right_nulls is not None:
        with timer("air_constrain"):
            smooth_near_nullspace(A, left_nulls, right_nulls)

    need_acc = opts.any_c_smooths and not opts.full_smoothing_up_and_down
    with timer("air_extract"):
        A_ff, A_fc, A_cf, A_cc = extract_submatrices(A, fine, coarse,
                                                     need_acc=need_acc)

    # strong-R dropped copies, used only for the grid transfers
    with timer("air_drop"):
        A_ff_drop, A_cf_drop, A_fc_drop = strong_r_drop(
            A, fine, coarse, opts.strong_r_threshold,
            need_afc=not opts.one_point_classical_prolong)
    if A_ff_drop is None:
        A_ff_drop, A_cf_drop, A_fc_drop = A_ff, A_cf, A_fc

    with timer("air_inverse"):
        # the smoother's inverse: of the whole A under full smoothing
        # (reference: src/AIR_MG_Setup.F90:1014-1048)
        smooth_mat = A if opts.full_smoothing_up_and_down else A_ff
        inv_Aff = _build_smoother_inverse(
            smooth_mat, opts, opts.inverse_type, opts.poly_order,
            opts.inverse_sparsity_order, opts.matrix_free_polys)
        # AIRG's Z and the ideal W need an ASSEMBLED inverse of the dropped
        # A_ff (reference: src/AIR_Operators_Setup.F90:406-475).  The
        # smoother's own inverse serves only when it is one: not when it
        # is matrix-free, acts on the whole A, or inverts an undropped A_ff
        inv_Aff_host = None
        if (opts.z_type == ZType.PRODUCT
                or (not opts.symmetric
                    and not opts.one_point_classical_prolong)):
            if (opts.strong_r_threshold != 0.0
                    or opts.full_smoothing_up_and_down
                    or opts.matrix_free_polys
                    or inv_Aff.kind not in ("assembled", "diagonal")):
                inv_dropped = _build_smoother_inverse(
                    A_ff_drop, opts, opts.inverse_type, opts.poly_order,
                    opts.inverse_sparsity_order, matrix_free=False)
            else:
                inv_dropped = inv_Aff
            inv_Aff_host = _assembled_host(inv_dropped)

    inv_Acc = None
    if need_acc:
        with timer("air_inverse"):
            inv_Acc = _build_smoother_inverse(
                A_cc, opts, opts.c_inverse_type_eff, opts.c_poly_order_eff,
                opts.c_inverse_sparsity_order_eff, opts.matrix_free_polys)

    inv_diag_Aff = None
    if opts.improve_w_its > 0 or opts.improve_z_its > 0:
        # the diagonal of the approximate inverse itself
        # (reference: src/Grid_Transfer_Improve.F90:60-66)
        if inv_Aff_host is not None:
            inv_diag_Aff = np.asarray(inv_Aff_host.diagonal())
        elif inv_Aff.kind in ("assembled", "diagonal"):
            inv_diag_Aff = np.asarray(_assembled_host(inv_Aff).diagonal())
            if inv_diag_Aff.shape[0] != A_ff.shape[0]:
                # a full-smoothing inverse acts on the whole A: keep its
                # diagonal at the F points
                inv_diag_Aff = inv_diag_Aff[np.asarray(fine)]
        else:
            d = A_ff.diagonal()
            inv_diag_Aff = np.where(d != 0, 1.0 / d, 0.0)

    W_drop = None
    if not opts.symmetric:
        with timer("air_prolong"):
            if opts.one_point_classical_prolong:
                W_drop = one_point_strongest(A_fc)
            else:
                W = compute_w_ideal(inv_Aff_host, A_fc_drop)
                if opts.improve_w_its > 0:
                    W = improve_transfer(W, A_ff, A_fc, inv_diag_Aff,
                                         opts.improve_w_its, is_z=False)
                W_drop = remove_small_from_sparse(W, opts.r_drop,
                                                  relative_max_row_tol=1)
            if opts.constrain_w and right_nulls is not None:
                with timer("air_constrain"):
                    W_drop = constrain_grid_transfer(
                        W_drop, [v[fine] for v in right_nulls],
                        [v[coarse] for v in right_nulls], is_z=False)

    with timer("air_restrict"):
        if opts.z_type == ZType.PRODUCT:
            # nothing needs the undropped Z without improvement: fuse the
            # product and the r_drop in one native sweep
            Z = compute_z_airg(A_cf_drop, inv_Aff_host,
                               None if opts.improve_z_its else opts.r_drop)
        else:
            Z = compute_z_lair(A_ff, A_cf, A_ff_drop, A_cf_drop,
                               opts.lair_distance,
                               incomplete=(opts.z_type == ZType.LAIR))
        if opts.improve_z_its > 0:
            Z = improve_transfer(Z, A_ff, A_cf, inv_diag_Aff,
                                 opts.improve_z_its, is_z=True)
    if opts.z_type != ZType.PRODUCT or opts.improve_z_its:
        with timer("air_drop"):
            Z = remove_small_from_sparse(Z, opts.r_drop,
                                         relative_max_row_tol=1)
    if opts.constrain_z and left_nulls is not None:
        with timer("air_constrain"):
            Z = constrain_grid_transfer(
                Z, [v[fine] for v in left_nulls],
                [v[coarse] for v in left_nulls], is_z=True)

    with timer("air_restrict"):
        R = assemble_r(Z, fine, coarse, n)
    with timer("air_prolong"):
        P = (sp.csr_matrix(R.T) if opts.symmetric
             else assemble_p(W_drop, fine, coarse, n))
    with timer("air_rap"):
        coarse_A = compute_coarse_matrix(A, R, P, opts.a_drop, opts.a_lump,
                                         opts.symmetric)
    lvl = LevelData(n=n, fine=fine, coarse=coarse, A=A, A_ff=A_ff, A_fc=A_fc,
                    A_cf=A_cf if need_acc else None, A_cc=A_cc, R=R, P=P,
                    inv_Aff=inv_Aff, inv_Acc=inv_Acc)
    return lvl, coarse_A
