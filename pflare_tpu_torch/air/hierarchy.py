"""AIR hierarchy setup: the level loop, on the host.

Reference: src/AIR_MG_Setup.F90:44-1231 (setup_air_pcmg), ported from
``pflare_tpu.air.hierarchy`` for one device: every CF splitting, AIRG /
lAIR / SAI-lAIR restriction with strong-R dropping, one-point or ideal
prolongation with improvement and near-nullspace constraints, symmetric
PtAP, C-point and full smoothing inverses, auto-truncation, the RCM coarse
repartition and sparsity reuse.  On a same-pattern re-setup
(``previous``) the stored CF splitting and, from ``reuse_amount`` 2, the
stored patterns and plans short-circuit the symbolic work (the
reference's reuse_sparsity system, docs/reuse.md).  The host setup runs
in the precision of the input matrix; ``Hierarchy.to`` builds the device
form of the solve.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
import torch

from ..cf.splitting import compute_cf_splitting
from ..inverse.build import Inverse, build_inverse
from ..options import AIROptions
from ..params import InverseType, ZType
from ..sparse.ops import (one_point_strongest, remove_from_sparse_match,
                          remove_small_from_sparse)
from ..utils.timers import timer
from .constrain import constrain_grid_transfer, smooth_near_nullspace
from .fullspace import build_fullspace_level, build_full_smoothing_level, make_op
from .operators import (
    ap_product,
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


@dataclass
class LevelData:
    """Host record of one level: its operator, the compressed-space
    blocks, transfers and inverses.  ``A_cf``, ``A_cc`` and ``inv_Acc``
    are kept only when a C-point smooth needs them; ``inv_Aff_host`` is
    the assembled inverse Z and W were built with; ``patterns`` holds what
    a same-pattern re-setup reuses (the dropped patterns, the product and
    polynomial plans, ``coarse_A``, ``coarse_perm``, ``host_fast``);
    ``coarse_order`` is the repartitioned order the next level lives in
    (None: sorted)."""

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
    inv_Aff_host: sp.csr_matrix | None = None
    patterns: dict = field(default_factory=dict)
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

    def to_scipy(self) -> dict:
        """{name: host csr} of every operator: each level's, its
        inverses' operators and diagonals, the coarse inverse and ``top``
        (to compare two device forms of one hierarchy)."""
        out = {"top": self.top.to_scipy()}

        def add(name, inv):
            if inv.kind == "dense":
                out[name] = sp.csr_matrix(inv.mat.cpu().numpy())
                return
            if inv.kind != "diagonal":
                out[name] = inv.mat.to_scipy()
            if inv.diag is not None:
                out[name + " diag"] = sp.diags(inv.diag.cpu().numpy()).tocsr()

        for i, lev in enumerate(self.levels):
            for key, val in lev.items():
                if key.startswith("inv_"):
                    add(f"level {i} {key}", val)
                elif key not in ("mask_f", "mask_c", "coarse"):
                    out[f"level {i} {key}"] = val.to_scipy()
        add("coarse inverse", self.coarse_inv)
        return out


class HostShim:
    """nnz/shape placeholder for a released host matrix -- the reference
    destroys the level matrix and substitutes a matshell when only
    F-smoothing needs it (reference: src/AIR_MG_Setup.F90:614-639).
    Stats keep working; the memory is released."""

    __slots__ = ("nnz", "shape")

    def __init__(self, M):
        self.nnz = int(M.nnz)
        self.shape = tuple(M.shape)


def _csr_bytes(M) -> int:
    return int(M.data.nbytes + M.indices.nbytes + M.indptr.nbytes)


@dataclass
class Hierarchy:
    levels: list            # list[LevelData]
    coarse_matrix: sp.csr_matrix
    coarse_inv: Inverse
    options: AIROptions
    auto_truncated: bool = False
    # the constraints' candidate vectors (None: the constant vector), which
    # the device re-setup smooths anew
    near_nullspace: list | None = None
    # uploads still to come from this host hierarchy: its PCAIR's own and
    # one for each twin ``PCAIR.on`` made; the last one compacts it
    pending_uploads: int = 0
    compacted: bool = False
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    @property
    def n_levels(self):
        return len(self.levels) + 1

    def expect_upload(self):
        """Register one more upload to come (a new PCAIR sharing this
        hierarchy); after compaction there is nothing left to upload."""
        with self._lock:
            if self.compacted:
                raise ValueError(
                    "this host hierarchy was compacted after its last "
                    "pending upload (no reuse_sparsity): its level "
                    "matrices are released, so no further PCAIR can "
                    "upload it; make twins with on() before uploading, or "
                    "set up again")
            self.pending_uploads += 1

    def upload_done(self) -> int:
        """One registered upload happened; the last one compacts the host
        hierarchy unless sparsity reuse needs it.  Returns the host bytes
        that compaction released (0 if none ran)."""
        with self._lock:
            self.pending_uploads -= 1
            if self.pending_uploads > 0 or self.options.reuse_sparsity:
                return 0
            return self.compact_host()

    def compact_host(self) -> int:
        """Release the host CSR copies the live configuration can no
        longer need (no sparsity reuse): every level matrix except the
        finest operator, the assembled ``inv_Aff_host`` and the stored
        patterns become ``HostShim``s (reference:
        pflare_tpu/air/hierarchy.py:127-163, src/AIR_MG_Setup.F90:614-639).
        The inverses and the coarsest matrix stay: ``stats`` reads them.
        Returns the bytes of the CSR arrays no longer referenced."""
        kept = {id(self.coarse_matrix)}
        if self.levels:
            kept.add(id(self.levels[0].A))
        for lvl in self.levels:
            for inv in (lvl.inv_Aff, lvl.inv_Acc):
                if inv is not None and inv.host_csr is not None:
                    kept.add(id(inv.host_csr))
        released = {}

        def shim(M):
            if not sp.issparse(M):
                return M
            if id(M) not in kept:
                released[id(M)] = _csr_bytes(M)
            return HostShim(M)

        for i, lvl in enumerate(self.levels):
            for name in ("A_ff", "A_fc", "A_cf", "A_cc", "R", "P"):
                setattr(lvl, name, shim(getattr(lvl, name)))
            if i > 0:
                lvl.A = shim(lvl.A)
            shim(lvl.inv_Aff_host)       # counted; dropped as the reference
            lvl.inv_Aff_host = None      # drops it
            for key, val in lvl.patterns.items():
                lvl.patterns[key] = shim(val)
        self.compacted = True
        return sum(released.values())

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
                            sparsity_order, matrix_free, coefficients=None,
                            patterns=None, plan_key=None):
    """A level's approximate inverse of ``M``.  With ``patterns`` a stored
    polynomial plan ``patterns[plan_key]`` evaluates an assembled
    polynomial, and a first setup with ``reuse_amount`` >= 3 stores one
    (the numeric plan of the device re-setup)."""
    if _is_diagonal_only(M):
        return _diag_inverse(M)
    poly_plan = None if patterns is None else patterns.get(plan_key)
    inv = build_inverse(
        M, inverse_type, poly_order=poly_order, sparsity_order=sparsity_order,
        matrix_free=matrix_free, diag_scale=opts.diag_scale_polys,
        coefficients=coefficients, seed=opts.seed, poly_plan=poly_plan)
    if (patterns is not None and poly_plan is None and opts.reuse_sparsity
            and opts.reuse_amount >= 3 and inv.kind == "assembled"
            and inverse_type in (InverseType.POWER, InverseType.ARNOLDI,
                                 InverseType.NEWTON,
                                 InverseType.NEWTON_NO_EXTRA)):
        from ..sparse.pattern import SparsityPattern
        from ..sparse.spgemm import FixedSparsityPolyPlan

        patterns[plan_key] = FixedSparsityPolyPlan(
            SparsityPattern(M.indptr, M.indices, M.shape),
            max(1, min(poly_order, max(M.shape[0] - 1, 0))), sparsity_order)
    return inv


def _build_coarse_inverse(A, opts: AIROptions, coefficients=None) -> Inverse:
    return build_inverse(
        A, opts.coarsest_inverse_type, poly_order=opts.coarsest_poly_order,
        sparsity_order=opts.coarsest_inverse_sparsity_order,
        matrix_free=opts.coarsest_matrix_free_polys,
        diag_scale=opts.coarsest_diag_scale_polys,
        coefficients=coefficients, seed=opts.seed)


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
                    previous: Hierarchy | None = None, near_nullspace=None,
                    injected_coeffs: dict | None = None) -> Hierarchy:
    """Build the full AIR hierarchy of ``A`` on the host, or rebuild it
    numerically when ``previous`` (a setup of a matrix with the same
    pattern) is given.  ``near_nullspace``: the candidate vectors of the
    constraints (default the constant vector).  ``injected_coeffs``:
    polynomial coefficients by level (-1 the coarse solver) that replace
    the coefficient iterations (PCAIRSetPolyCoeffs)."""
    A = sp.csr_matrix(A)
    A.sort_indices()
    levels: list[LevelData] = []
    reuse = previous is not None
    injected_coeffs = injected_coeffs or {}
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
        level_idx = len(levels)
        # auto-truncation: stop where the coarse solver alone is good
        # enough (reference: src/AIR_MG_Setup.F90:158-256)
        if (opts.auto_truncate_start_level > 0
                and level_idx + 1 >= opts.auto_truncate_start_level):
            with timer("air_inverse"):
                probe = _build_coarse_inverse(A, opts)
            if _coarse_solver_quality(A, probe, opts.seed) <= \
                    opts.auto_truncate_tol:
                auto_truncated = True
                coarse_inv = probe
                break

        prev_lvl = (previous.levels[level_idx]
                    if reuse and level_idx < len(previous.levels) else None)
        if prev_lvl is not None:
            # the stored CF splitting (every reuse_amount)
            fine, coarse = prev_lvl.fine, prev_lvl.coarse
        else:
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

        # reuse_amount 1 keeps only the CF splitting, >= 2 the stored
        # patterns too (reference: src/AIR_Data_Type.F90:388-422)
        if prev_lvl is not None and opts.reuse_amount < 2:
            prev_lvl = None
        injected = injected_coeffs.get(level_idx)
        if (prev_lvl is not None and injected is None
                and "host_fast" in prev_lvl.patterns):
            # numeric-only rebuild from the stored index plans
            from .host_resetup import rebuild_level

            lvl = rebuild_level(A, prev_lvl, opts)
        else:
            lvl = _build_level(A, fine, coarse, opts, prev_lvl, left_nulls,
                               right_nulls, injected)
        levels.append(lvl)

        # RCM coarse repartition (the ParMETIS stand-in, reference:
        # src/C_PETSc_Routines.c:17-175): the next level lives in the
        # permuted coarse order; the transfers' gathers carry the basis
        # change and every level-local block and stored pattern keeps the
        # sorted order.  A re-setup reapplies the stored permutation, so
        # the patterns stay aligned across setups.
        perm = None
        if prev_lvl is not None and "coarse_perm" in prev_lvl.patterns:
            perm = prev_lvl.patterns["coarse_perm"]
        elif repartition and not opts.full_smoothing_up_and_down:
            from ..parallel.repartition import coarse_repartition_perm

            with timer("air_repartition"):
                perm = coarse_repartition_perm(lvl.patterns["coarse_A"])
        coarse_used = coarse
        if perm is not None:
            lvl.coarse_order = np.asarray(coarse)[perm]
            lvl.patterns["coarse_perm"] = perm
            Ap = sp.csr_matrix(lvl.patterns["coarse_A"][perm][:, perm])
            Ap.sort_indices()
            lvl.patterns["coarse_A"] = Ap
            coarse_used = lvl.coarse_order
        if left_nulls is not None:
            left_nulls = [v[coarse_used] for v in left_nulls]
        if right_nulls is not None:
            right_nulls = [v[coarse_used] for v in right_nulls]
        A = lvl.patterns["coarse_A"]

    if coarse_inv is None:
        with timer("air_inverse"):
            if _is_diagonal_only(A):
                coarse_inv = _diag_inverse(A)
            else:
                coeffs = injected_coeffs.get(-1)
                if (coeffs is None and reuse and opts.reuse_poly_coeffs
                        and previous.coarse_inv.coefficients is not None):
                    coeffs = np.asarray(previous.coarse_inv.coefficients)
                coarse_inv = _build_coarse_inverse(A, opts, coeffs)
    return Hierarchy(levels, A, coarse_inv, opts,
                     auto_truncated=auto_truncated,
                     near_nullspace=near_nullspace)


def _build_level(A, fine, coarse, opts: AIROptions, prev: LevelData | None,
                 left_nulls=None, right_nulls=None, injected=None):
    """One level's operators (reference: src/AIR_Operators_Setup.F90:
    36-1082).  ``prev``: the level of a same-pattern setup, whose stored
    patterns take the values (their dict is shared and updated);
    ``injected``: coefficients for the level's inverse."""
    n = A.shape[0]
    patterns = prev.patterns if prev is not None else {}
    keep_patterns = opts.reuse_sparsity and opts.reuse_amount >= 2
    want_plans = opts.reuse_sparsity and opts.reuse_amount >= 3
    if left_nulls is not None or right_nulls is not None:
        with timer("air_constrain"):
            smooth_near_nullspace(A, left_nulls, right_nulls)

    need_acc = opts.any_c_smooths and not opts.full_smoothing_up_and_down
    with timer("air_extract"):
        A_ff, A_fc, A_cf, A_cc = extract_submatrices(A, fine, coarse,
                                                     need_acc=need_acc)

    # strong-R dropped copies, used only for the grid transfers; on a
    # re-setup the values go onto the stored dropped patterns (the
    # reference's MAT_*_DROP slots, remove_from_sparse_match)
    with timer("air_drop"):
        if (prev is not None and opts.strong_r_threshold != 0.0
                and "Aff_drop" in patterns):
            A_ff_drop = remove_from_sparse_match(A_ff, patterns["Aff_drop"])
            A_cf_drop = remove_from_sparse_match(A_cf, patterns["Acf_drop"])
            A_fc_drop = (None if patterns["Afc_drop"] is None else
                         remove_from_sparse_match(A_fc, patterns["Afc_drop"]))
        else:
            A_ff_drop, A_cf_drop, A_fc_drop = strong_r_drop(
                A, fine, coarse, opts.strong_r_threshold,
                need_afc=not opts.one_point_classical_prolong)
            if A_ff_drop is not None and keep_patterns:
                patterns["Aff_drop"] = A_ff_drop
                patterns["Acf_drop"] = A_cf_drop
                patterns["Afc_drop"] = A_fc_drop
    if A_ff_drop is None:
        A_ff_drop, A_cf_drop, A_fc_drop = A_ff, A_cf, A_fc

    with timer("air_inverse"):
        # injected coefficients win over reuse_poly_coeffs (reference:
        # include/pflare.h:244, docs/reuse.md:216-390)
        coeffs = injected
        if (coeffs is None and prev is not None and opts.reuse_poly_coeffs
                and prev.inv_Aff.coefficients is not None):
            coeffs = np.asarray(prev.inv_Aff.coefficients)
        # the smoother's inverse: of the whole A under full smoothing
        # (reference: src/AIR_MG_Setup.F90:1014-1048)
        smooth_mat = A if opts.full_smoothing_up_and_down else A_ff
        inv_Aff = _build_smoother_inverse(
            smooth_mat, opts, opts.inverse_type, opts.poly_order,
            opts.inverse_sparsity_order, opts.matrix_free_polys,
            coefficients=coeffs, patterns=patterns,
            plan_key="inv_aff_poly_plan")
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
                drop_coeffs = None
                if (injected is None and prev is not None
                        and opts.reuse_poly_coeffs):
                    drop_coeffs = patterns.get("inv_dropped_coeffs")
                inv_dropped = _build_smoother_inverse(
                    A_ff_drop, opts, opts.inverse_type, opts.poly_order,
                    opts.inverse_sparsity_order, matrix_free=False,
                    coefficients=drop_coeffs, patterns=patterns,
                    plan_key="inv_aff_drop_poly_plan")
                if inv_dropped.coefficients is not None:
                    patterns["inv_dropped_coeffs"] = np.asarray(
                        inv_dropped.coefficients)
            else:
                inv_dropped = inv_Aff
            inv_Aff_host = _assembled_host(inv_dropped)

    inv_Acc = None
    if need_acc:
        with timer("air_inverse"):
            inv_Acc = _build_smoother_inverse(
                A_cc, opts, opts.c_inverse_type_eff, opts.c_poly_order_eff,
                opts.c_inverse_sparsity_order_eff, opts.matrix_free_polys,
                patterns=patterns, plan_key="inv_acc_poly_plan")

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
                if prev is not None and "W_drop" in patterns:
                    W_drop = patterns["W_drop"]  # never changes on reuse
                else:
                    W_drop = one_point_strongest(A_fc)
            else:
                W = compute_w_ideal(inv_Aff_host, A_fc_drop)
                if opts.improve_w_its > 0:
                    W = improve_transfer(W, A_ff, A_fc, inv_diag_Aff,
                                         opts.improve_w_its, is_z=False)
                if want_plans and "W_numeric_plan" not in patterns:
                    # (improvement keeps W's pattern, so the plan holds)
                    patterns["W_numeric_plan"] = _make_product_plan(
                        inv_Aff_host, A_fc_drop, W)
                if prev is not None and "W_drop" in patterns:
                    W_drop = remove_from_sparse_match(W, patterns["W_drop"])
                else:
                    W_drop = remove_small_from_sparse(W, opts.r_drop,
                                                      relative_max_row_tol=1)
            if opts.constrain_w and right_nulls is not None:
                with timer("air_constrain"):
                    W_drop = constrain_grid_transfer(
                        W_drop, [v[fine] for v in right_nulls],
                        [v[coarse] for v in right_nulls], is_z=False)
            patterns["W_drop"] = W_drop

    Z_drop = None
    with timer("air_restrict"):
        if opts.z_type == ZType.PRODUCT:
            zplan = patterns.get("Z_numeric_plan")
            if (prev is None and opts.improve_z_its == 0
                    and not want_plans):
                # nothing needs the undropped Z: the product and the r_drop
                # fuse in one native sweep when it can
                Z_drop = compute_z_airg(A_cf_drop, inv_Aff_host,
                                        opts.r_drop)
            elif (prev is not None and zplan is None
                    and opts.improve_z_its == 0
                    and not (opts.constrain_z and left_nulls is not None)
                    and "Z_drop" in patterns):
                # numeric-only product straight onto the stored pattern,
                # never forming the undropped Z
                from ..native import spgemm_onto_pattern_native

                Z_drop = spgemm_onto_pattern_native(
                    A_cf_drop, inv_Aff_host, patterns["Z_drop"], lump=False)
                if Z_drop is not None:
                    Z_drop.data *= -1.0
            if Z_drop is not None:
                Z = None
            elif (prev is not None and zplan is not None
                    and zplan.pat_A.nnz == A_cf_drop.nnz
                    and zplan.pat_B.nnz == inv_Aff_host.nnz):
                # amount 3: the stored plan, the device re-setup's product
                Z = _plan_product_host(zplan, A_cf_drop, inv_Aff_host)
                Z.data *= -1.0
            else:
                # the inputs' patterns are unchanged on a re-setup, so the
                # product pattern is too; the stored Z_drop match below
                # gives the reference's MAT_REUSE_MATRIX result
                Z = compute_z_airg(A_cf_drop, inv_Aff_host)
                if want_plans and "Z_numeric_plan" not in patterns:
                    patterns["Z_numeric_plan"] = _make_product_plan(
                        A_cf_drop, inv_Aff_host, Z)
        else:
            lair_pat = patterns.get("Z_lair_sparsity")
            Z = compute_z_lair(A_ff, A_cf, A_ff_drop, A_cf_drop,
                               opts.lair_distance,
                               incomplete=(opts.z_type == ZType.LAIR),
                               sparsity=lair_pat)
            if lair_pat is None and keep_patterns:
                patterns["Z_lair_sparsity"] = sp.csr_matrix(
                    (np.ones(Z.nnz), Z.indices.copy(), Z.indptr.copy()),
                    shape=Z.shape)
        if opts.improve_z_its > 0:
            Z = improve_transfer(Z, A_ff, A_cf, inv_diag_Aff,
                                 opts.improve_z_its, is_z=True)
    with timer("air_drop"):
        if Z_drop is None:
            if prev is not None and "Z_drop" in patterns:
                Z_drop = remove_from_sparse_match(Z, patterns["Z_drop"])
            else:
                Z_drop = remove_small_from_sparse(Z, opts.r_drop,
                                                  relative_max_row_tol=1)
        patterns["Z_drop"] = Z_drop
    if opts.constrain_z and left_nulls is not None:
        with timer("air_constrain"):
            Z_drop = constrain_grid_transfer(
                Z_drop, [v[fine] for v in left_nulls],
                [v[coarse] for v in left_nulls], is_z=True)

    with timer("air_restrict"):
        R = assemble_r(Z_drop, fine, coarse, n)
    with timer("air_prolong"):
        P = (sp.csr_matrix(R.T) if opts.symmetric
             else assemble_p(W_drop, fine, coarse, n))

    AP = None
    with timer("air_rap"):
        ap_plan = patterns.get("AP_numeric_plan")
        if (prev is not None and "RAP_drop" in patterns
                and ap_plan is not None and ap_plan.pat_A.nnz == A.nnz
                and ap_plan.pat_B.nnz == P.nnz):
            # amount 3: the stored plans, the device re-setup's products
            AP = _plan_product_host(ap_plan, A, P)
            RAP = _plan_product_host(patterns["RAP_numeric_plan"], R, AP)
            coarse_A = remove_from_sparse_match(RAP, patterns["RAP_drop"],
                                                lump=opts.a_lump)
        elif prev is not None and "RAP_drop" in patterns:
            # amount 2: the second product straight onto the stored
            # dropped pattern with the lumping fused, never forming the
            # undropped RAP
            from ..native import spgemm_onto_pattern_native

            Rm = sp.csr_matrix(P.T).tocsr() if opts.symmetric else R
            AP = ap_product(A, P)
            coarse_A = spgemm_onto_pattern_native(
                Rm, AP, patterns["RAP_drop"], lump=opts.a_lump)
            if coarse_A is None:
                coarse_A = remove_from_sparse_match(
                    sp.csr_matrix(Rm @ AP), patterns["RAP_drop"],
                    lump=opts.a_lump)
        else:
            coarse_A, RAP, AP = compute_coarse_matrix(
                A, R, P, opts.a_drop, opts.a_lump, opts.symmetric,
                need_rap=want_plans)
            patterns["RAP_drop"] = coarse_A
            if want_plans:
                patterns["AP_numeric_plan"] = _make_product_plan(A, P, AP)
                patterns["RAP_numeric_plan"] = _make_product_plan(R, AP, RAP)
    patterns["coarse_A"] = coarse_A

    lvl = LevelData(n=n, fine=fine, coarse=coarse, A=A, A_ff=A_ff, A_fc=A_fc,
                    A_cf=A_cf if need_acc else None, A_cc=A_cc, R=R, P=P,
                    inv_Aff=inv_Aff, inv_Acc=inv_Acc,
                    inv_Aff_host=inv_Aff_host, patterns=patterns)
    if prev is None and injected is None and keep_patterns:
        from .host_resetup import build_plan, eligible

        if eligible(opts):
            with timer("air_reuse_plan"):
                build_plan(lvl, A, AP, opts)
    return lvl


def _make_product_plan(A: sp.csr_matrix, B: sp.csr_matrix,
                       C: sp.csr_matrix):
    """The numeric plan of C = A@B on the pattern of the first setup's C
    (scipy's product prunes value-dependent zeros, so C may be a subset of
    the structural product; the device re-setup and the amount-3 host
    re-setup both keep exactly this pattern)."""
    from ..sparse.pattern import SparsityPattern
    from ..sparse.spgemm import build_spgemm_plan

    return build_spgemm_plan(SparsityPattern(A.indptr, A.indices, A.shape),
                             SparsityPattern(B.indptr, B.indices, B.shape),
                             SparsityPattern(C.indptr, C.indices, C.shape))


def _plan_product_host(plan, A: sp.csr_matrix, B: sp.csr_matrix
                       ) -> sp.csr_matrix:
    """A stored numeric plan executed on host CSR values."""
    return sp.csr_matrix(
        (plan.execute_host(A.data, B.data), plan.pat_C.indices,
         plan.pat_C.indptr), shape=plan.pat_C.shape)
