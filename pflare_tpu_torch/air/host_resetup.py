"""The host's same-pattern numeric re-setup, by stored index plans.

Ported from ``pflare_tpu.air.host_resetup``.  The reference's
MAT_REUSE_MATRIX re-setup (src/AIR_Data_Type.F90:388-422 reuse tables,
src/PETSc_Helper.F90:490 remove_from_sparse_match; docs/reuse.md's
"10-20x faster re-setup") skips every symbolic step when the nonzero
pattern is the same.  Taken to its limit here: the first reuse-enabled
setup of a level stores *index plans* -- the gather positions of its
submatrices in A's values, the product triples of Z and of RAP
enumerated onto the stored dropped patterns (the products outside the
RAP pattern redirected onto the diagonal when lumping), and the value
permutation that assembles R -- so a re-setup is a chain of native
streaming passes (gather, plan execution, polynomial on the sparsity)
with no pattern discovery, search or sort.  The plan executions and
gathers run in float64, as the reference's do: an f32 matrix gives an
f64 R, P and coarse matrix from the first re-built level on.

Eligible is the default AIRG configuration (one-point prolongator,
product Z, no strong-R drop, improvement or constraints, F-point
smoothing with an assembled polynomial); anything else takes the generic
reuse path of ``hierarchy._build_level``, which reuses the patterns but
runs the products.  Without the native kernels no plan is built.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..inverse.build import Inverse
from ..params import InverseType, ZType
from ..utils.timers import timer

_POLY_TYPES = (InverseType.POWER, InverseType.ARNOLDI)
_NEWTON_TYPES = (InverseType.NEWTON, InverseType.NEWTON_NO_EXTRA)


def eligible(opts) -> bool:
    """Whether the options allow the plan re-setup."""
    return (opts.one_point_classical_prolong
            and opts.z_type == ZType.PRODUCT
            and opts.strong_r_threshold == 0.0
            and opts.improve_z_its == 0 and opts.improve_w_its == 0
            and not opts.constrain_z and not opts.constrain_w
            and not opts.full_smoothing_up_and_down
            and not opts.symmetric
            and not opts.matrix_free_polys
            and not opts.any_c_smooths
            and not opts.diag_scale_polys
            and opts.inverse_type in _POLY_TYPES + _NEWTON_TYPES)


def _csr_view(data: np.ndarray, like: sp.csr_matrix) -> sp.csr_matrix:
    """New values on ``like``'s structure arrays (shared, not copied)."""
    out = sp.csr_matrix((data, like.indices, like.indptr), shape=like.shape)
    out.has_sorted_indices = True
    return out


def build_plan(lvl, A: sp.csr_matrix, AP: sp.csr_matrix, opts) -> None:
    """Store the level's re-setup plan in ``lvl.patterns["host_fast"]``
    (left unset where a plan cannot be built).  Called at the end of a
    first reuse-enabled setup of the level; ``AP = A @ P`` is the product
    it computed."""
    from ..native import plan_triples32_native
    from ..sparse.ops import _diag_positions
    from .operators import extract_submatrices

    inv_host = lvl.inv_Aff_host
    if lvl.inv_Aff.kind not in ("assembled", "diagonal") or inv_host is None:
        return
    if A.nnz >= 2**31 or AP.nnz >= 2**31:
        return      # int32 gather positions would wrap

    pf: dict = {}
    # the submatrices of the matrix of A's entry positions are gather
    # indices into A's values (exact in f64 below 2^53 entries)
    pos = _csr_view(np.arange(A.nnz, dtype=np.float64), A)
    p_ff, p_fc, p_cf, _ = extract_submatrices(pos, lvl.fine, lvl.coarse)
    pf["pos_ff"] = p_ff.data.astype(np.int32)
    pf["pos_fc"] = p_fc.data.astype(np.int32)
    pf["pos_cf"] = p_cf.data.astype(np.int32)
    pf["cf_struct"] = p_cf     # A_cf's structure (not kept on the level)

    if lvl.inv_Aff.kind == "diagonal":
        dpos = _diag_positions(lvl.A_ff)
        pf["inv"] = ("diag", np.where(
            dpos >= 0, pf["pos_ff"][np.maximum(dpos, 0)], -1
        ).astype(np.int32))
    else:
        from ..inverse.build import _poly_sparsity

        coeffs = np.asarray(lvl.inv_Aff.coefficients, dtype=np.float64)
        if opts.inverse_type in _NEWTON_TYPES:
            order = coeffs.shape[1] if coeffs.ndim == 2 else len(coeffs) - 1
        else:
            order = len(coeffs) - 1
        si, sx = _poly_sparsity(lvl.A_ff, opts.inverse_sparsity_order, order)
        if len(sx) != inv_host.nnz:
            return  # the assembled pattern lost value-pruned entries
        pf["inv"] = ("newton" if opts.inverse_type in _NEWTON_TYPES
                     else "poly", si, sx)

    # Z = -A_cf inv(A_ff) straight onto the stored dropped pattern
    zd = lvl.patterns["Z_drop"]
    trip = plan_triples32_native(p_cf.indptr, p_cf.indices, inv_host.indptr,
                                 inv_host.indices, zd.indptr, zd.indices,
                                 inv_host.shape[1])
    if trip is None:
        return      # no native kernels: the generic reuse path
    pf["zplan"] = trip

    # the value permutation of R = [Z I] (reference:
    # src/Grid_Transfer.F90:465); -1 marks the identity's ones
    n_c = len(lvl.coarse)
    rows = np.concatenate([
        np.repeat(np.arange(zd.shape[0], dtype=np.int64), np.diff(zd.indptr)),
        np.arange(n_c, dtype=np.int64)])
    cols = np.concatenate([np.asarray(lvl.fine)[zd.indices],
                           np.asarray(lvl.coarse)])
    vals = np.concatenate([np.arange(zd.nnz, dtype=np.float64),
                           np.full(n_c, -1.0)])
    Rp = sp.csr_matrix((vals, (rows, cols)), shape=lvl.R.shape)
    Rp.sort_indices()
    if Rp.nnz != lvl.R.nnz:
        return
    pf["rperm"] = Rp.data.astype(np.int32)

    # AP = A @ P: P's values are all 1 (the one-point W)
    trip = plan_triples32_native(A.indptr, A.indices, lvl.P.indptr,
                                 lvl.P.indices, AP.indptr, AP.indices,
                                 AP.shape[1])
    pf["applan"] = (trip[0], trip[2])
    pf["ap_nnz"] = AP.nnz

    # RAP onto the stored dropped pattern, the products outside it lumped
    # onto the diagonal with a_lump (the fused a_drop/a_lump of
    # src/AIR_Operators_Setup.F90:1038-1082 under MAT_REUSE)
    rapd = lvl.patterns["RAP_drop"]
    pf["rapplan"] = plan_triples32_native(
        lvl.R.indptr, lvl.R.indices, AP.indptr, AP.indices, rapd.indptr,
        rapd.indices, rapd.shape[1], lump=opts.a_lump)
    lvl.patterns["host_fast"] = pf


def rebuild_level(A: sp.csr_matrix, prev, opts):
    """A level rebuilt from ``prev``'s plans on the values of ``A``: a new
    LevelData sharing every structure array with ``prev`` (the
    reference's MAT_REUSE_MATRIX semantics), its patterns dict updated."""
    from ..native import gather_fill_native, plan_execute_native
    from .hierarchy import LevelData

    pf = prev.patterns["host_fast"]
    patterns = prev.patterns
    d = A.data

    # the resetup_* timers split the re-setup: gathers, coefficients,
    # inverse values and the onto-pattern products
    with timer("resetup_gather"):
        A_ff = _csr_view(d[pf["pos_ff"]], prev.A_ff)
        A_fc = _csr_view(d[pf["pos_fc"]], prev.A_fc)
        A_cf = _csr_view(d[pf["pos_cf"]], pf["cf_struct"])

    spec = pf["inv"]
    if spec[0] == "diag":
        diagv = gather_fill_native(d, spec[1], 0.0)
        inv_d = np.where(diagv != 0, 1.0 / diagv, 0.0)
        inv_Aff = Inverse("diagonal", diag=inv_d)
        inv_host = sp.diags(inv_d).tocsr()
        inv_host.sort_indices()
    else:
        kind, si, sx = spec
        with timer("resetup_coeffs"):
            coeffs = _inverse_coefficients(A_ff, prev, opts, kind)
        with timer("resetup_inverse"):
            if kind == "newton":
                from ..native import newton_on_sparsity_native
                from ..params import tolerances

                data = newton_on_sparsity_native(
                    A_ff, si, sx, coeffs[0], coeffs[1],
                    tolerances(np.float64).zero)
                coeffs = np.stack([coeffs[0], coeffs[1]])
            else:
                from ..native import poly_on_sparsity_native

                data = poly_on_sparsity_native(A_ff, si, sx, coeffs)
            inv_host = sp.csr_matrix((data, sx, si), shape=A_ff.shape)
            inv_host.has_sorted_indices = True
        inv_Aff = Inverse("assembled", host_csr=inv_host, coefficients=coeffs)

    # Z = -A_cf inv(A_ff) onto the stored Z_drop pattern
    with timer("resetup_products"):
        zd_prev = patterns["Z_drop"]
        za, zb, zc = pf["zplan"]
        zvals = plan_execute_native(A_cf.data, inv_host.data, za, zb, zc,
                                    zd_prev.nnz, alpha=-1.0)
    Z_drop = patterns["Z_drop"] = _csr_view(zvals, zd_prev)

    # R = [Z I]; P keeps its values (the one-point W's are all 1)
    with timer("resetup_gather"):
        R = _csr_view(gather_fill_native(zvals, pf["rperm"], 1.0), prev.R)

    # the coarse matrix: AP, then RAP onto the stored dropped pattern
    with timer("resetup_products"):
        apos, cpos = pf["applan"]
        ap_vals = plan_execute_native(d, None, apos, None, cpos,
                                      pf["ap_nnz"])
        ra, rb, rc = pf["rapplan"]
        rapd_prev = patterns["RAP_drop"]
        coarse_vals = plan_execute_native(R.data, ap_vals, ra, rb, rc,
                                          rapd_prev.nnz)
    coarse_A = _csr_view(coarse_vals, rapd_prev)
    patterns["RAP_drop"] = patterns["coarse_A"] = coarse_A

    return LevelData(
        n=A.shape[0], fine=prev.fine, coarse=prev.coarse, A=A, A_ff=A_ff,
        A_fc=A_fc, A_cf=None, A_cc=None, R=R, P=prev.P, inv_Aff=inv_Aff,
        inv_Acc=None, inv_Aff_host=inv_host, patterns=patterns)


def _inverse_coefficients(A_ff, prev, opts, kind):
    """The stored coefficients under ``reuse_poly_coeffs``, else the
    coefficients iterated anew on the new values (reference:
    src/Approx_Inverse_Setup.F90:52-64), in float64."""
    if opts.reuse_poly_coeffs and prev.inv_Aff.coefficients is not None:
        return np.asarray(prev.inv_Aff.coefficients, dtype=np.float64)
    matvec = lambda v: A_ff @ v
    n = A_ff.shape[0]
    if kind == "newton":
        from ..inverse.newton import newton_roots

        wr, wi = newton_roots(
            matvec, n, opts.poly_order, np.float64,
            add_roots=(opts.inverse_type == InverseType.NEWTON),
            seed=opts.seed)
        return np.stack([wr, wi])
    from ..inverse.gmres_poly import coefficients_arnoldi, coefficients_power

    order = max(min(opts.poly_order, n - 1), 0)
    fn = (coefficients_power if opts.inverse_type == InverseType.POWER
          else coefficients_arnoldi)
    return fn(matvec, n, order, np.float64, seed=opts.seed)
