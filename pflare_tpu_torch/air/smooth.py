"""Solve-time smoothing and the V-cycles.

Reference: src/FC_Smooth.F90 + the PCMG Kaskade assembly in
src/AIR_MG_Setup.F90:967-1156, ported from ``pflare_tpu.air.smooth``.  The
preconditioner application restricts the RHS down, applies the coarse
solve, then interpolates and runs norm-free F/C-point Richardson smoothing
on the way up.  No reductions anywhere: every step is an SpMV, a
gather/scatter or an axpy, so the cycle never waits on the host.  Kaskade
levels are full-space dicts (air/fullspace.py); ``vcycle_full`` runs the
full-smoothing form.

On a card the gather kernel does the vector work next to each product
of a gather container (TELL, ELL, DELL): ``mask * b - A x``, ``t - A x``
and ``x + inv(r)`` are epilogues of the product's launch, and R writes,
and P reads, the coarse vector through the level's coarse maps
(``sparse/ell.py::Fused``, ``fullspace.coarse_maps``), with the bits of
the separate ops.  Every other operator (DIA, banded, a sharded one), vector
(a CPU tensor, a split mesh's ``Rows``) or inverse (matrix-free,
diagonal, dense) takes the separate ops.
"""

from __future__ import annotations

import torch

from ..sparse.dell import DELL
from ..sparse.ell import ELL, TELL, Fused


def _gathers(op, v) -> bool:
    """Whether the product ``op @ v`` takes the gather kernel's fused
    route: ``op`` a gather container with a packed copy, ``v`` a plain
    CUDA tensor."""
    return (isinstance(v, torch.Tensor) and v.is_cuda
            and isinstance(op, (TELL, ELL, DELL)) and op.packed is not None)


def _point_smooth(b, mask, A_other, A_diag, inv, x, its: int):
    """x <- x + inv(mask * b - A_other x - A_diag x), ``its`` times, with
    every operator in full-space form."""
    if _gathers(A_other, x):
        t = A_other.matvec(Fused("masked", x, u=b, m=mask))
    else:
        t = mask * b - A_other.matvec(x)
    for _ in range(its):
        if _gathers(A_diag, x):
            r = A_diag.matvec(Fused("residual", x, u=t))
        else:
            r = t - A_diag.matvec(x)
        if inv.kind == "assembled" and _gathers(inv.mat, r):
            x = inv.mat.matvec(Fused("correction", r, u=x))
        else:
            x = x + inv.apply(r)
    return x


def f_smooth_full(level, b, x, its: int):
    """F-point smoothing with inv(A_ff) (reference: src/FC_Smooth.F90:
    499-560)."""
    return _point_smooth(b, level["mask_f"], level["A_fc"], level["A_ff"],
                         level["inv_Aff"], x, its)


def c_smooth_full(level, b, x, its: int):
    """C-point smoothing with inv(A_cc) (reference: src/FC_Smooth.F90:
    572)."""
    return _point_smooth(b, level["mask_c"], level["A_cf"], level["A_cc"],
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


def vcycle_kaskade(levels, coarse_inv, r, smooth_order, maps=None):
    """AIR preconditioner application M^-1 r (PETSc PC_MG_KASKADE
    semantics: no down smooths; RHS restricted down; smoothing only on the
    way up with a nonzero initial guess).  Each level's row space, padded
    or not, is the length of its ``mask_f``; the result has r's length.
    On a split mesh the sharded levels' vectors are ``Rows``, the whole
    levels' and the coarse solve's tensors on the controller device.
    ``maps``: the levels' ``DeviceHierarchy.coarse_maps``, or None."""
    maps = maps or [None] * len(levels)
    bs = [r]
    for lev, pair in zip(levels, maps):
        b = _pad_to(bs[-1], lev["mask_f"].shape[0])
        bs[-1] = b
        R, coarse = lev["R"], lev["coarse"]
        if pair and pair[0] is not None and _gathers(R, b):
            bs.append(R.matvec(Fused("coarse_out", b, packed=pair[0])))
        else:
            # R_ext writes the restricted values at the coarse positions
            bs.append(R.matvec(b).index_select(0, coarse))
    x = coarse_inv.apply(bs[-1])
    for i in range(len(levels) - 1, -1, -1):
        lev = levels[i]
        P, coarse, pair = lev["P"], lev["coarse"], maps[i]
        if pair and pair[1] is not None and _gathers(P, x):
            x = P.matvec(Fused("coarse_in", x[:coarse.shape[0]],
                               packed=pair[1]))
        else:
            x = P.matvec(_place_coarse(x, coarse, lev["mask_f"].shape[0]))
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
