"""Solve-time smoothing and the V-cycles.

Reference: src/FC_Smooth.F90 + the PCMG Kaskade assembly in
src/AIR_MG_Setup.F90:967-1156, ported from ``pflare_tpu.air.smooth``.  The
preconditioner application restricts the RHS down, applies the coarse
solve, then interpolates and runs norm-free F/C-point Richardson smoothing
on the way up.  No reductions anywhere: every step is an SpMV, a
gather/scatter or an axpy, so the cycle never waits on the host.  Kaskade
levels are full-space dicts (air/fullspace.py); ``vcycle_full`` runs the
full-smoothing form.
"""

from __future__ import annotations

import torch


def _point_smooth(b_masked, A_other, A_diag, inv, x, its: int):
    """x <- x + inv(b_masked - A_other x - A_diag x), ``its`` times, with
    every operator in full-space form."""
    t = b_masked - A_other.matvec(x)
    for _ in range(its):
        x = x + inv.apply(t - A_diag.matvec(x))
    return x


def f_smooth_full(level, b, x, its: int):
    """F-point smoothing with inv(A_ff) (reference: src/FC_Smooth.F90:
    499-560)."""
    return _point_smooth(level["mask_f"] * b, level["A_fc"], level["A_ff"],
                         level["inv_Aff"], x, its)


def c_smooth_full(level, b, x, its: int):
    """C-point smoothing with inv(A_cc) (reference: src/FC_Smooth.F90:
    572)."""
    return _point_smooth(level["mask_c"] * b, level["A_cf"], level["A_cc"],
                         level["inv_Acc"], x, its)


def _order_for_level(smooth_order, i: int):
    """Per-level smoothing order: ``smooth_order`` may be one order tuple
    applied everywhere, or a tuple of per-level tuples whose last entry
    repeats on deeper levels (reference: smooth_order_levels,
    src/AIR_Data_Type.F90:333)."""
    if smooth_order and isinstance(smooth_order[0], tuple):
        return smooth_order[min(i, len(smooth_order) - 1)]
    return smooth_order


def fc_point_richardson(level, b, x, smooth_order):
    """One smoother application: consecutive F/C groups per smooth_order
    (positive = F smooths, negative = C smooths; reference:
    src/FC_Smooth.F90:421-497)."""
    for group in smooth_order:
        if group > 0:
            x = f_smooth_full(level, b, x, group)
        elif group < 0:
            x = c_smooth_full(level, b, x, -group)
    return x


def _pad_to(v, n: int):
    """v zero-padded, or cut, to length n.  Levels sharded over a row mesh
    (parallel/mesh.py) carry padded row spaces whose pads hold zeros, so
    the vectors between levels are padded or cut to the next level's
    (pflare_tpu/air/smooth.py:105-145).  A row-sharded vector of a split
    mesh (``Rows``) is laid out anew over its devices."""
    if not isinstance(v, torch.Tensor):
        return v.fit(n)
    if v.shape[0] < n:
        return torch.cat([v, v.new_zeros(n - v.shape[0])])
    return v[:n]


def _place_coarse(x, coarse, n: int):
    """The first ``len(coarse)`` entries of x at rows ``coarse`` of a
    zero vector of length n; on a level sharded over a split mesh
    ``coarse`` is its ``CoarseMap``, which writes each device's rows."""
    if not isinstance(coarse, torch.Tensor):
        return coarse.place(x)
    x_full = torch.zeros(n, dtype=x.dtype, device=x.device)
    x_full.index_copy_(0, coarse, x[:coarse.shape[0]])
    return x_full


def vcycle_kaskade(levels, coarse_inv, r, smooth_order):
    """AIR preconditioner application M^-1 r (PETSc PC_MG_KASKADE
    semantics: no down smooths; RHS restricted down; smoothing only on the
    way up with a nonzero initial guess).  Each level's row space, padded
    or not, is the length of its ``mask_f``; the result has r's length.
    On a split mesh the sharded levels' vectors are ``Rows``, the whole
    levels' and the coarse solve's tensors on the controller device."""
    bs = [r]
    for lev in levels:
        b = _pad_to(bs[-1], lev["mask_f"].shape[0])
        bs[-1] = b
        # R_ext writes the restricted values at the coarse positions
        bs.append(lev["R"].matvec(b).index_select(0, lev["coarse"]))
    x = coarse_inv.apply(bs[-1])
    for i in range(len(levels) - 1, -1, -1):
        lev = levels[i]
        x = lev["P"].matvec(_place_coarse(x, lev["coarse"],
                                          lev["mask_f"].shape[0]))
        x = fc_point_richardson(lev, bs[i], x,
                                _order_for_level(smooth_order, i))
    return _pad_to(x, r.shape[0])


def full_smooth(level, b, x, its: int = 1):
    """Full-point Richardson with the inverse of the whole level operator
    (full_smoothing_up_and_down; reference: src/AIR_MG_Setup.F90:1014-1048
    uses PCMAT with inv_A_ff = inv(A))."""
    A = level["A"]
    inv = level["inv_Aff"]
    for _ in range(its):
        x = x + inv.apply(b - A.matvec(x))
    return x


def vcycle_full(levels, coarse_inv, r):
    """V-cycle of full_smoothing_up_and_down: the RHS restricted down with
    no down smooths (Kaskade with PCMAT), then one full smooth per level
    on the way up."""
    bs = [r]
    for lev in levels:
        bs.append(lev["R"].matvec(bs[-1]))
    x = coarse_inv.apply(bs[-1])
    for i in range(len(levels) - 1, -1, -1):
        lev = levels[i]
        x = full_smooth(lev, bs[i], lev["P"].matvec(x))
    return x
