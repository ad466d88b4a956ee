"""The same-pattern numeric re-setup of a PCAIR hierarchy, on the device.

Ported from ``pflare_tpu.air.device_resetup``.  With ``reuse_sparsity``
and ``reuse_amount >= 3`` every pattern, product plan and layout of a
hierarchy is static, so the whole numeric re-setup -- submatrix
extraction, the approximate inverses, Z = -A_cf inv(A_ff), R, AP and RAP,
drop and lump, the near-nullspace constraints, the coarse inverse and the
truncation probe -- is one function from the new matrix values to a new
``DeviceHierarchy``.  ``DeviceResetup`` builds its index tables on the
host once and uploads them once; each call uploads the new values and
runs the function as torch ops on the plan's device: gathers, products
and segment sums, the batched SVD least squares of the SAI/ISAI and lAIR
re-solves and of the constraints, Gauss-Jordan for a dense coarse
inverse (``dense_inverse``).

Nothing is read back but the truncation probe's quality.  On a CUDA
device each batched SVD also reads its convergence flag back (one
synchronisation a chunk: SAI/ISAI, lAIR and constraints with more than
one null vector only).  Each segment sum adds its terms one after the
other in the host's order (``sparse/spgemm.py::segment_sum``), and the
constraints' small sums, the null-space smoothing's dots and the dense
inverse run in a fixed order, so a card's install equals the CPU's but
for those SVDs.  Nothing falls back to the host re-setup: a
configuration the plan cannot rebuild raises ``ValueError`` when the
plan is built.

Polynomial coefficients are those of the setup the plan was built from
(the reference's ``reuse_poly_coeffs`` regime).  The rebuilt operators
take the containers ``air/fullspace.py::make_op`` chooses (DIA, banded,
TELL; ELL for the coarse inverse, as ``Inverse.to`` builds it), laid out
by the container's own ``from_scipy`` run once on a matrix of value
positions, so each layout is the one an upload builds: the TELL's
``[K, n]`` slots included, which the reference maps with ELL's ``[n, K]``
(its ``_op_layout``, pflare_tpu/air/device_resetup.py:121-167).

Supported, as in the reference: AIRG / lAIR / SAI-lAIR restrictors,
one-point, ideal or symmetric transfers, every inverse kind (assembled
power/Arnoldi/Newton, also diagonally scaled, SAI/ISAI re-solves,
matrix-free, diagonal; dense on the coarse grid), strong-R dropping,
improvement of W and Z, near-nullspace constraints, F/C and full
smoothing, auto-truncated hierarchies (the truncation level is stored
structure; the probe re-runs on the device and ``install`` reports a
truncation the new values no longer justify), ``reorder`` without the
coarse repartition.  Rejected, as in the reference: lAIR with the ideal
prolongator or symmetric transfers, a setup without ``reuse_sparsity``
and ``reuse_amount >= 3``, a repartitioned coarse level; and a dense (LU)
level inverse.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
import torch

from ..inverse.build import Inverse
from ..inverse.sai import SAISolvePlan, sai_execute
from ..options import AIROptions
from ..params import InverseType, ZType, tolerances
from ..sparse.banded import BandedSpMV
from ..sparse.dia import DIA
from ..sparse.dtypes import numpy_dtype
from ..sparse.ell import ELL, sell_index
from ..sparse.pattern import SparsityPattern
from ..sparse.spgemm import (FixedSparsityPolyPlan, build_spgemm_plan,
                             index_tensor, ordered_dot, ordered_sum,
                             plan_execute, poly_execute, run_lengths,
                             segment_sum, take)
from .constrain import SMOOTH_ITS
from .fullspace import _map_both, _map_cols, _map_rows, make_op
from .hierarchy import DeviceHierarchy

_NEWTON = (InverseType.NEWTON, InverseType.NEWTON_NO_EXTRA)
_SAI = (InverseType.SAI, InverseType.ISAI)
_DIAG_SOURCES = ("diag-same", "diag-own", "diag-drop")


# ~~~~~~~~~~~~~~~~~~~~~ host-side map helpers ~~~~~~~~~~~~~~~~~~~~~


def _rows(M) -> np.ndarray:
    return np.repeat(np.arange(M.shape[0], dtype=np.int64), np.diff(M.indptr))


def _keys(M) -> np.ndarray:
    return _rows(M) * np.int64(M.shape[1]) + M.indices.astype(np.int64)


def _pos_in(src: sp.csr_matrix, dst_keys: np.ndarray) -> np.ndarray:
    """Position of each key (row * n_cols + col) in src's sorted entries;
    -1 where absent."""
    skeys = _keys(src)
    if len(skeys) == 0:
        return np.full(np.shape(dst_keys), -1, dtype=np.int64)
    pos = np.minimum(np.searchsorted(skeys, dst_keys), len(skeys) - 1)
    return np.where(skeys[pos] == dst_keys, pos, -1)


def _submatrix_map(A: sp.csr_matrix, sub: sp.csr_matrix, row_sel,
                   col_sel) -> np.ndarray:
    """For each entry of ``sub`` = A[row_sel][:, col_sel], its position in
    A's values."""
    rows = np.asarray(row_sel, dtype=np.int64)[_rows(sub)]
    cols = np.asarray(col_sel, dtype=np.int64)[sub.indices]
    m = _pos_in(A, rows * np.int64(A.shape[1]) + cols)
    if np.any(m < 0):
        raise ValueError("submatrix entry missing from parent pattern")
    return m


def _positions(M: sp.csr_matrix) -> sp.csr_matrix:
    """M's structure with values 1..nnz: each entry's 1-based position in
    M's value vector."""
    return sp.csr_matrix((np.arange(1, M.nnz + 1, dtype=np.float64),
                          M.indices, M.indptr), shape=M.shape)


def _pattern_csr(pat) -> sp.csr_matrix:
    return sp.csr_matrix((np.ones(pat.nnz), pat.indices, pat.indptr),
                         shape=pat.shape)


def _diag_only(M: sp.csr_matrix) -> bool:
    return bool(np.all(_rows(M) == M.indices))


def _diag_pos1(M) -> np.ndarray:
    """1-based position of each row's diagonal in M's values, 0 where
    absent."""
    return SparsityPattern(M.indptr, M.indices, M.shape).diag_positions() + 1


def _recip(d):
    return torch.where(d != 0, 1.0 / torch.where(d != 0, d, 1.0), 0.0)


class _Tensors:
    """Uploads host arrays to the plan's device and counts their bytes."""

    def __init__(self, device, dtype):
        self.device, self.dtype, self.nbytes = device, dtype, 0

    def __call__(self, a, dtype=None):
        """An index tensor (``index_tensor``), or one of ``dtype``."""
        t = (index_tensor(a, self.device) if dtype is None else
             torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                             device=self.device))
        self.nbytes += t.numel() * t.element_size()
        return t

    def values(self, a):
        return self(a, self.dtype)

    def count(self, obj):
        """Count the tensors of ``obj`` (nested dicts and lists of
        tensors) made elsewhere; returns ``obj``."""
        if isinstance(obj, torch.Tensor):
            self.nbytes += obj.numel() * obj.element_size()
        elif isinstance(obj, dict):
            for v in obj.values():
                self.count(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                self.count(v)
        return obj


class _Layout:
    """A device container of fixed structure whose values come from a
    value vector.  ``build`` (``make_op`` or ``ELL.from_scipy``) runs once
    on ``M_pos``, a matrix whose values are the 1-based positions of its
    entries in that vector, so the container's data is the gather index of
    every slot (0: an empty slot) in the layout an upload of the matrix
    builds; calling the layout on a value vector gives the container."""

    def __init__(self, M_pos: sp.csr_matrix, build, up: _Tensors):
        t = build(M_pos, torch.float64)
        self.index = up(t.data.numpy().astype(np.int64))
        if isinstance(t, DIA):
            offsets, shape = t.offsets, t.shape
            self._make = lambda data: DIA(offsets, data, shape)
        elif isinstance(t, BandedSpMV):
            lcols = up(t.lcols, torch.int32)
            n, n_cols, w, W = t.n, t.n_cols, t.w, t.W
            self._make = lambda data: BandedSpMV(data, lcols, n, n_cols, w, W)
        else:
            cls, pattern, cols = type(t), t.pattern, up(t.cols, torch.int32)
            if cols.is_cuda:
                # the packed copy's index goes to the card now, so that
                # an install packs with no host copy (no synchronisation)
                sell_index(t, device=cols.device)
            self._make = lambda data: cls(pattern, data, cols)

    def __call__(self, vals):
        return self._make(take(vals, self.index))


def _match_arrays(src: sp.csr_matrix, dst: sp.csr_matrix, lump: bool,
                  up: _Tensors) -> dict:
    """remove_from_sparse_match as static maps: dst values from src values
    (0 where absent) and, with ``lump``, the src entries outside dst
    summed onto the dst diagonal of their row."""
    dkeys = _keys(dst)
    out = {"src": up(_pos_in(src, dkeys) + 1)}
    if lump:
        outside = np.nonzero(~np.isin(_keys(src), dkeys,
                                      assume_unique=True))[0]
        dpos = SparsityPattern(dst.indptr, dst.indices,
                               dst.shape).diag_positions()
        srows = _rows(src)[outside]
        ok = dpos[srows] >= 0
        out["lump_src"] = up(outside[ok])
        # rows ascend, so the diagonals the lumps land on do too
        out["lump_len"] = up.count(run_lengths(dpos[srows[ok]], dst.nnz,
                                               up.device))
    return out


def _exec_match(m: dict, vals):
    out = take(vals, m["src"])
    if "lump_src" in m:
        out = out + segment_sum(vals[m["lump_src"]], m["lump_len"])
    return out


# ~~~~~~~~~~~~~~~~~~~ polynomial and inverse re-assembly ~~~~~~~~~~~~~~~~~~~


def _exec_newton_poly(tables: dict, wr, wi, a_flat, tol_zero: float):
    """Assembled Newton-basis inverse on the plan's S pattern: M = sum
    T_i / theta_i with every product through the same (X @ A)|_S step plan
    as the monomial path; the root schedule is static (reference:
    src/Gmres_Poly_Newtonk.kokkos.cxx:15; conjugate pairs in real
    arithmetic as inverse/build.py)."""
    T = tables["diag"].to(a_flat.dtype)          # the identity on S
    M = torch.zeros_like(T)
    k = len(wr)
    i = 0
    while i <= k - 2:
        if wi[i] == 0.0:
            if abs(wr[i]) < tol_zero:
                i += 1
                continue
            M = M + T / wr[i]
            T = T - plan_execute(tables["step"], T, a_flat) / wr[i]
            i += 1
        else:
            s2 = wr[i] ** 2 + wi[i] ** 2
            if s2 < tol_zero:
                i += 2
                continue
            TA = plan_execute(tables["step"], T, a_flat)
            T2 = 2.0 * wr[i] * T - TA
            M = M + T2 / s2
            if i <= k - 3:
                T = T - plan_execute(tables["step"], T2, a_flat) / s2
            i += 2
    if k >= 1 and wi[k - 1] == 0.0 and abs(wr[k - 1]) > tol_zero:
        M = M + T / wr[k - 1]
    return M


@dataclass
class _InvMeta:
    kind: str                  # Inverse.kind
    steps: tuple = ()
    scaled: bool = False       # matrix-free q(D^-1 A) D^-1
    assembly: str = ""         # assembled: "poly" | "newton" | "sai"
    diag_scale: bool = False   # assembled on D^-1 A, times D^-1
    newton_wr: tuple = None
    newton_wi: tuple = None
    tol_zero: float = 0.0


def _assembled_plan(plan, coeffs, itype, diag_scale, M, up, meta, arrs):
    """The tables of an assembled polynomial on ``plan`` (poly or Newton)."""
    arrs["poly"] = up.count(plan.device_tables(up.device))
    c = np.asarray(coeffs, dtype=np.float64)
    arrs["coeffs"] = up.values(c)
    if itype in _NEWTON:
        meta.assembly = "newton"
        meta.newton_wr = tuple(float(v) for v in c[0])
        meta.newton_wi = tuple(float(v) for v in c[1])
        meta.tol_zero = float(tolerances(np.float64).zero)
    else:
        meta.assembly = "poly"
    if diag_scale:
        # q(D^-1 A) D^-1: rows of A scaled before, columns of S after
        meta.diag_scale = True
        arrs["dpos"] = up(_diag_pos1(M))
        arrs["a_rows"] = up(_rows(M))
        arrs["s_cols"] = up(plan.pat_S.indices)


def _exec_assembled(meta: _InvMeta, arrs: dict, m_flat):
    """The assembled inverse's values on its own pattern, CSR order."""
    if meta.assembly == "sai":
        return sai_execute(arrs["sai"], m_flat)
    dinv = None
    if meta.diag_scale:
        dinv = 1.0 / take(m_flat, arrs["dpos"])
        m_flat = m_flat * dinv[arrs["a_rows"]]
    if meta.assembly == "newton":
        out = _exec_newton_poly(arrs["poly"], meta.newton_wr, meta.newton_wi,
                                m_flat, meta.tol_zero)
    else:
        out = poly_execute(arrs["poly"], m_flat, arrs["coeffs"])
    return out if dinv is None else out * dinv[arrs["s_cols"]]


def _inverse_plan(inv: Inverse, itype, diag_scale: bool, M: sp.csr_matrix,
                  plan, fine, n: int, build, up: _Tensors):
    """(meta, arrays) rebuilding the device form of ``inv``, an inverse of
    ``M``, from M's values.  ``fine`` embeds it in the level's full space
    of size ``n`` (None: M's own space, the coarse grid); ``build`` makes
    the assembled inverse's container; ``plan`` is the stored polynomial
    plan of an assembled power/Arnoldi/Newton inverse (None without
    one)."""
    meta = _InvMeta(kind=inv.kind, steps=inv.steps, scaled=inv.scaled)
    arrs: dict = {}

    def placement():
        # full-space row i takes compressed row k where fine[k] = i
        place = np.zeros(n, dtype=np.int64)
        place[fine] = np.arange(1, len(fine) + 1)
        return up(place)

    if inv.kind == "diagonal":
        arrs["dpos"] = up(_diag_pos1(M))
        # a weighted Jacobi carries its weight: w / d_new, with w = d_old *
        # the old inverse diagonal (1 for a plain 1/d)
        d_old = M.diagonal()
        dvals = np.asarray(inv.diag)
        arrs["w"] = up.values(np.where(d_old != 0, dvals * d_old, 0.0))
        if fine is not None:
            arrs["place"] = placement()
        return meta, arrs
    if inv.kind == "dense":
        if fine is not None:
            raise ValueError("device re-setup does not support a dense (LU) "
                             "level inverse")
        dense = np.zeros(M.shape[0] * M.shape[1], dtype=np.int64)
        dense[_keys(M)] = np.arange(1, M.nnz + 1)
        arrs["dense"] = up(dense.reshape(M.shape))
        return meta, arrs
    if inv.kind == "assembled":
        if itype in _SAI:
            # SAI/ISAI re-solve: static gather tables + batched SVD least
            # squares (the Kokkos re-solve sibling, src/SAI_Zk.kokkos.cxx:13)
            S = inv.host_csr
            if S is None:
                raise ValueError("SAI re-solve needs the host inverse copy")
            S_pat = _pattern_csr(S)
            arrs["sai"] = up.count(SAISolvePlan(
                M, None, S_pat, incomplete=(itype == InverseType.ISAI)
            ).device_tables(up.device, up.dtype))
            meta.assembly = "sai"
        else:
            if plan is None:
                raise ValueError(
                    "device re-setup needs the stored numeric plan of the "
                    "assembled inverse; run setup with reuse_sparsity=True, "
                    "reuse_amount>=3 (assembled power/arnoldi only)")
            if inv.coefficients is None:
                raise ValueError(
                    "assembled inverse without stored coefficients is not "
                    "supported by device re-setup")
            _assembled_plan(plan, inv.coefficients, itype, diag_scale, M, up,
                            meta, arrs)
            S_pat = _pattern_csr(plan.pat_S)
        # the rebuilt inverse lives on S (the stored host matrix may have
        # dropped explicit zeros, so its own pattern is not used)
        S_pos = _positions(S_pat)
        if fine is not None:
            S_pos = _map_both(S_pos, fine, fine, n)
        arrs["op"] = _Layout(S_pos, build, up)
        return meta, arrs
    # matrix-free kinds: the new operator and the carried coefficients
    if inv.coefficients is not None:
        arrs["coeffs"] = up.values(np.asarray(inv.coefficients))
    if inv.diag is not None:
        arrs["dpos"] = up(_diag_pos1(M))
        if fine is not None:
            arrs["place"] = placement()
    return meta, arrs


def dense_inverse(D):
    """D^-1 by Gauss-Jordan elimination in place with partial pivoting
    (the first largest |entry| of the column), one pivot at a time: each
    entry takes one product and one difference a step, each rounded on
    its own, so a card computes the CPU's bits, where a library inverse
    blocks and sums in an order of its own on each device.  Nothing is
    read back (the pivot rows are device indices); a zero pivot gives
    non-finite entries, as ``inv_ex`` does not raise either."""
    n = D.shape[0]
    M = D.clone()
    idx = torch.arange(n, device=D.device)
    swaps = []
    for k in range(n):
        p = k + torch.argmax(M[k:, k].abs())
        pair = torch.stack([idx[k], p])
        M[pair] = M[pair.flip(0)]
        swaps.append(pair)
        inv_piv = 1.0 / M[k, k]
        # no scalar stores into one entry: a Python float stored into a
        # 0-d slice of a card tensor is a host-to-device copy
        at_k = idx == k
        f = torch.where(at_k, 0.0, M[:, k])
        r = torch.where(at_k, inv_piv, M[k] * inv_piv)
        M[:, k] = 0.0
        M[k] = r
        M -= f[:, None] * r[None, :]
    for pair in reversed(swaps):      # the row swaps undone on the columns
        M[:, pair] = M[:, pair.flip(0)]
    return M

def _exec_inverse(meta: _InvMeta, arrs: dict, m_flat, ext_op):
    """(the device Inverse, its values in compressed form): the diagonal
    or the assembled values on their pattern, for the products that reuse
    them (None for the matrix-free and dense kinds)."""
    if meta.kind == "diagonal":
        d = take(m_flat, arrs["dpos"])
        dinv = torch.where(d != 0, arrs["w"] / torch.where(d != 0, d, 1.0),
                           0.0)
        diag = take(dinv, arrs["place"]) if "place" in arrs else dinv
        return Inverse("diagonal", diag=diag), dinv
    if meta.kind == "dense":
        return Inverse("dense",
                       mat=dense_inverse(take(m_flat, arrs["dense"]))), None
    if meta.kind == "assembled":
        vals = _exec_assembled(meta, arrs, m_flat)
        return Inverse("assembled", mat=arrs["op"](vals),
                       coefficients=arrs.get("coeffs")), vals
    diag = None
    if "dpos" in arrs:
        d = take(m_flat, arrs["dpos"])
        d = torch.where(d != 0, d, 1.0)
        diag = (torch.where(arrs["place"] > 0, take(d, arrs["place"]), 1.0)
                if "place" in arrs else d)
    return Inverse(meta.kind, mat=ext_op, coefficients=arrs.get("coeffs"),
                   steps=meta.steps, diag=diag, scaled=meta.scaled), None


# ~~~~~~~~~~~~~~~~~~~~~ near-nullspace constraints ~~~~~~~~~~~~~~~~~~~~~


def _matvec_arrays(M: sp.csr_matrix, up: _Tensors,
                   transpose: bool = False) -> dict:
    """Static arrays for y = M x (or M^T x) from M's values: gather x at
    each entry's column, segment-sum into rows; the transpose re-sorts the
    entries by column (a static permutation)."""
    rows, cols = _rows(M), M.indices.astype(np.int64)
    if transpose:
        order = np.argsort(cols, kind="stable")
        return {"perm": up(order), "x_at": up(rows[order]),
                "lengths": up.count(run_lengths(cols[order], M.shape[1],
                                                up.device))}
    return {"perm": None, "x_at": up(cols),
            "lengths": up.count(run_lengths(rows, M.shape[0], up.device))}


def _exec_matvec(arrs: dict, m_flat, x):
    vals = m_flat if arrs["perm"] is None else m_flat[arrs["perm"]]
    return segment_sum(vals * x[arrs["x_at"]], arrs["lengths"])


def _exec_null_smooth(mv: dict, m_flat, dpos, v):
    """Self-scaled Richardson + Jacobi on M x = 0 from the guess v, with a
    fixed count of sweeps (air/constrain.py::_richardson_smooth, reference:
    src/Constrain_Z_or_W.F90:118-218); no step reads a value back."""
    dinv = _recip(take(m_flat, dpos))
    x = v
    for _ in range(SMOOTH_ITS):
        r = -_exec_matvec(mv, m_flat, x)
        z = dinv * r
        Az = _exec_matvec(mv, m_flat, z)
        denom = ordered_dot(Az, Az)
        alpha = torch.where(denom != 0, ordered_dot(Az, r)
                            / torch.where(denom != 0, denom, 1.0), 0.0)
        x = x + alpha * z
    return x


def _constrain_tables(M_pat: sp.csr_matrix, up: _Tensors) -> list:
    """Rows bucketed by support size, for the batched row-wise projector
    correction (air/constrain.py::constrain_grid_transfer)."""
    indptr, indices = M_pat.indptr, M_pat.indices
    row_len = np.diff(indptr)
    buckets = []
    for m in np.unique(row_len):
        if m == 0:
            continue
        rows = np.nonzero(row_len == m)[0]
        idx = indptr[rows][:, None] + np.arange(m)[None, :]
        buckets.append({"pos": up(idx), "rows": up(rows),
                        "cols": up(indices[idx])})
    return buckets


def _exec_constrain(buckets, data, b_row, b_col, sigma_drop: float):
    """``data``: transfer values on the fixed pattern; ``b_row``/``b_col``
    the stacked null vectors of its row and column spaces.  The corrected
    values, by batched pseudo-inverses with the reference's absolute
    cutoff.  The small products sum term by term in a fixed order, and
    with one null vector (k = 1) the pseudo-inverse of the 1 x 1 Gram
    matrix g is 1/g, so a card computes the CPU's bits; with more, a
    batched SVD (its rounding differs between devices)."""
    for bk in buckets:
        Bj = b_col[bk["cols"]]                          # [R, m, k]
        vals = data[bk["pos"]]                          # [R, m]
        m, k = Bj.shape[1], Bj.shape[2]
        G = ordered_sum([Bj[:, j, :, None] * Bj[:, j, None, :]
                         for j in range(m)])            # [R, k, k]
        diff = ordered_sum([vals[:, j, None] * Bj[:, j]
                            for j in range(m)]) - b_row[bk["rows"]]
        if k == 1:
            piv = torch.where(G > sigma_drop,
                              1.0 / torch.where(G != 0, G, 1.0), 0.0)
        else:
            U, sv, Vh = torch.linalg.svd(G)
            sinv = torch.where(sv.abs() > sigma_drop,
                               1.0 / torch.where(sv != 0, sv, 1.0), 0.0)
            piv = torch.einsum("rji,rj,rkj->rik", Vh, sinv, U)
        corr = ordered_sum([piv[:, :, l] * diff[:, l, None]
                            for l in range(k)])         # [R, k]
        new = vals - ordered_sum([Bj[:, :, l] * corr[:, l, None]
                                  for l in range(k)])
        data = data.index_put((bk["pos"].reshape(-1),), new.reshape(-1))
    return data


# ~~~~~~~~~~~~~~~~~~~~~ the per-level plan ~~~~~~~~~~~~~~~~~~~~~


@dataclass
class _LevelMeta:
    n: int
    inv: _InvMeta
    z_src: str                     # diag-same|diag-own|diag-drop|same|sep|lair
    invh: _InvMeta = None          # the separately assembled dropped inverse
    invc: _InvMeta = None          # inv(A_cc) of a C-point smooth
    transfer: str = "one-point"    # one-point | ideal | symmetric
    strong_r: bool = False
    improve_w: int = 0
    improve_z: int = 0
    improve_diag: str = ""
    constrain_w: bool = False
    constrain_z: bool = False
    sigma_drop: float = 1e-13
    full_smooth: bool = False
    static: dict = field(default_factory=dict)   # device leaves kept as is


def _dropped_inverse_coeffs(lvl) -> np.ndarray:
    """Coefficients of the dropped assembled inverse used by Z and W (the
    first setup stores them beside its plan)."""
    coeffs = lvl.patterns.get("inv_dropped_coeffs")
    if coeffs is None:
        raise ValueError("dropped inverse has no polynomial coefficients")
    return np.asarray(coeffs)


def _build_level_plan(lvl, opts: AIROptions, up: _Tensors):
    """(meta, arrays) of one level's numeric re-setup (reference:
    pflare_tpu/air/device_resetup.py:662-1186)."""
    A, fine, coarse = lvl.A, np.asarray(lvl.fine), np.asarray(lvl.coarse)
    pats = lvl.patterns
    if lvl.coarse_order is not None:
        raise ValueError(
            "device re-setup does not support coarse-level "
            "repartitioning (reorder with an RCM-repartitioned coarse "
            "level); use the host re-setup path")
    n = lvl.n
    arrs: dict = {"ff": up(_submatrix_map(A, lvl.A_ff, fine, fine)),
                  "fc": up(_submatrix_map(A, lvl.A_fc, fine, coarse))}
    cf_mat = lvl.A_cf
    if cf_mat is None:
        cf_mat = sp.csr_matrix(A[coarse][:, fine])
        cf_mat.sort_indices()
    arrs["cf"] = up(_submatrix_map(A, cf_mat, coarse, fine))
    z_is_lair = opts.z_type != ZType.PRODUCT
    strong_r = opts.strong_r_threshold != 0.0
    if not z_is_lair:
        z_amat = pats["Acf_drop"] if strong_r else cf_mat
        zplan = pats.get("Z_numeric_plan")
        if zplan is None:
            raise ValueError("device re-setup needs Z_numeric_plan "
                             "(setup with reuse_sparsity, amount>=2)")
        if z_amat.nnz != zplan.pat_A.nnz:
            raise ValueError("A_cf pattern differs from the stored Z plan")

    # the smoothing inverse: of A_ff embedded in the full space, or under
    # full smoothing of the whole level matrix in its own space
    full_smooth = opts.full_smoothing_up_and_down
    inv = lvl.inv_Aff
    smooth_mat = A if full_smooth else lvl.A_ff
    inv_meta, arrs["inv"] = _inverse_plan(
        inv, opts.inverse_type, opts.diag_scale_polys, smooth_mat,
        pats.get("inv_aff_poly_plan"), None if full_smooth else fine, n,
        make_op, up)
    inv_sai = inv_meta.assembly == "sai"

    if strong_r:
        if "Aff_drop" not in pats or "Acf_drop" not in pats:
            raise ValueError(
                "device re-setup with strong_r_threshold needs the stored "
                "dropped patterns (setup with reuse_sparsity, amount>=2)")
        arrs["ffd"] = _match_arrays(lvl.A_ff, pats["Aff_drop"], False, up)
        arrs["cfd"] = _match_arrays(cf_mat, pats["Acf_drop"], False, up)
        if (not opts.one_point_classical_prolong
                and pats.get("Afc_drop") is not None):
            arrs["fcd"] = _match_arrays(lvl.A_fc, pats["Afc_drop"], False, up)

    # the assembled inverse Z and W use: one of the smoothing inverse's
    # values (same, diag-same), 1/diag of A_ff or of its dropped copy
    # (diag-own, diag-drop), a separately assembled dropped inverse (sep),
    # or none (lAIR)
    aff_diag_only = _diag_only(lvl.A_ff)
    invh_meta = None
    lair_pat = None
    if full_smooth and not z_is_lair and not strong_r:
        z_src = ("diag-own" if inv.kind == "diagonal" or aff_diag_only
                 else "sep")
    elif z_is_lair:
        lair_pat = pats.get("Z_lair_sparsity")
        if lair_pat is None:
            raise ValueError(
                "device re-setup with lAIR needs the stored distance-d "
                "sparsity (setup with reuse_sparsity, amount>=2)")
        z_src = "lair"
        arrs["z_sai"] = up.count(SAISolvePlan(
            lvl.A_ff, cf_mat, lair_pat,
            incomplete=(opts.z_type == ZType.LAIR)
        ).device_tables(up.device, up.dtype))
    elif inv.kind == "diagonal" and not strong_r:
        z_src = "diag-same"
    elif aff_diag_only and not strong_r:
        z_src = "diag-own"
    elif (inv.kind == "assembled" and not opts.matrix_free_polys
          and not strong_r):
        z_src = "same"
    elif strong_r and _diag_only(pats["Aff_drop"]):
        z_src = "diag-drop"
    else:
        z_src = "sep"
    if z_src == "diag-own":
        arrs["invh_dpos"] = up(_diag_pos1(lvl.A_ff))
    elif z_src == "diag-drop":
        arrs["invh_dpos"] = up(_diag_pos1(pats["Aff_drop"]))
    elif z_src == "sep":
        plan = pats.get("inv_aff_drop_poly_plan")
        if plan is None:
            raise ValueError(
                "device re-setup with matrix-free smoothing, full smoothing "
                "or strong-R dropping needs the dropped-inverse numeric plan "
                "(reuse_amount>=3)")
        invh_meta = _InvMeta(kind="assembled")
        arrs["invh"] = {}
        aff_use = pats["Aff_drop"] if strong_r else lvl.A_ff
        _assembled_plan(plan, _dropped_inverse_coeffs(lvl), opts.inverse_type,
                        opts.diag_scale_polys, aff_use, up, invh_meta,
                        arrs["invh"])

    def invh_pattern():
        """The pattern of the inverse values Z and W read."""
        if z_src == "same" and inv_sai:
            return _pattern_csr(inv.host_csr)
        key = "inv_aff_poly_plan" if z_src == "same" else \
            "inv_aff_drop_poly_plan"
        return _pattern_csr(pats[key].pat_S)

    def invh_at(pat):
        """Where each entry of ``pat`` (a product plan's inverse operand)
        takes its value in the inverse's values."""
        if z_src in _DIAG_SOURCES:
            return up(pat.row_of_pos())
        m = _pos_in(invh_pattern(), _keys(_pattern_csr(pat)))
        if np.any(m < 0):
            raise ValueError("assembled-inverse pattern does not cover the "
                             "stored Z/W plan pattern")
        return up(m)

    if z_is_lair:
        z_pat = lair_pat
    else:
        arrs["z"] = zplan.device_tables(up.device)
        up.count(arrs["z"])
        arrs["z_inv_at"] = invh_at(zplan.pat_B)
        z_pat = _pattern_csr(zplan.pat_C)
    arrs["zdrop"] = _match_arrays(z_pat, pats["Z_drop"], False, up)

    # R = [Z_drop I]: Z_drop entries and the identity's ones
    R = lvl.R
    rrows, rcols = _rows(R), R.indices.astype(np.int64)
    is_ident = rcols == coarse[rrows]
    inv_f = -np.ones(n, dtype=np.int64)
    inv_f[fine] = np.arange(len(fine))
    zd = pats["Z_drop"]
    zpos = _pos_in(zd, rrows[~is_ident] * np.int64(zd.shape[1])
                   + inv_f[rcols[~is_ident]])
    if np.any(zpos < 0):
        raise ValueError("R entry missing from Z_drop")
    r_src = np.zeros(R.nnz, dtype=np.int64)
    r_src[~is_ident] = zpos + 1
    arrs["r_src"], arrs["r_ident"] = up(r_src), up(is_ident, torch.bool)

    ap_plan, rap_plan = pats.get("AP_numeric_plan"), pats.get(
        "RAP_numeric_plan")
    if ap_plan is None or rap_plan is None:
        raise ValueError("device re-setup needs AP/RAP numeric plans")
    arrs["ap"] = up.count(ap_plan.device_tables(up.device))
    arrs["rap"] = up.count(rap_plan.device_tables(up.device))

    Pm = lvl.P
    P_pos = _positions(Pm) if full_smooth else _map_cols(_positions(Pm),
                                                         coarse, n)
    static = {}
    if opts.symmetric:
        # P = R^T exactly: P's values a static permutation of R's
        # (reference: src/AIR_Operators_Setup.F90:919-922)
        transfer = "symmetric"
        m0 = _pos_in(R, Pm.indices.astype(np.int64) * np.int64(R.shape[1])
                     + _rows(Pm))
        if np.any(m0 < 0):
            raise ValueError("P is not R^T")
        arrs["p_from_r"] = up(m0)
        arrs["op_P"] = _Layout(P_pos, make_op, up)
    elif opts.one_point_classical_prolong:
        transfer = "one-point"
        arrs["p_vals"] = up.values(Pm.data)        # static
        static["P"] = _Layout(P_pos, make_op, up)(arrs["p_vals"])
    else:
        transfer = "ideal"
        wplan = pats.get("W_numeric_plan")
        if wplan is None:
            raise ValueError("device re-setup with ideal W needs the W "
                             "numeric plan (reuse_amount>=2 setup)")
        arrs["w"] = up.count(wplan.device_tables(up.device))
        arrs["w_inv_at"] = invh_at(wplan.pat_A)
        arrs["wdrop"] = _match_arrays(_pattern_csr(wplan.pat_C),
                                      pats["W_drop"], False, up)
        # P = [W_drop; I]: W_drop entries on fine rows, ones on coarse rows
        prows, pcols = _rows(Pm), Pm.indices.astype(np.int64)
        is_ident_p = inv_f[prows] < 0
        wd = pats["W_drop"]
        ppos = _pos_in(wd, inv_f[prows[~is_ident_p]] * np.int64(wd.shape[1])
                       + pcols[~is_ident_p])
        if np.any(ppos < 0):
            raise ValueError("P entry missing from W_drop")
        p_src = np.zeros(Pm.nnz, dtype=np.int64)
        p_src[~is_ident_p] = ppos + 1
        arrs["p_src"], arrs["p_ident"] = up(p_src), up(is_ident_p, torch.bool)
        arrs["op_P"] = _Layout(P_pos, make_op, up)

    # the fixed-sparsity Richardson improvement of W and Z (reference:
    # src/Grid_Transfer_Improve.F90): products restricted onto the
    # transfer's own pattern, with D the diagonal of the approximate
    # inverse (:60-66)
    improve_diag = ""
    if opts.improve_w_its > 0 or opts.improve_z_its > 0:
        patA_ff = SparsityPattern(lvl.A_ff.indptr, lvl.A_ff.indices,
                                  lvl.A_ff.shape)
        if z_src in _DIAG_SOURCES:
            improve_diag = "direct"          # the inverse IS a diagonal
        elif not z_is_lair:
            improve_diag = "pattern"
            arrs["imp_dpos"] = up(_diag_pos1(invh_pattern()))
        elif inv.kind == "diagonal":
            # lAIR: the smoothing inverse's diagonal, at the F points
            improve_diag = "smooth-diag"
            if full_smooth:
                arrs["imp_fine"] = up(fine)
        elif inv.kind == "assembled":
            improve_diag = "smooth-pattern"
            S_smooth = (_pattern_csr(inv.host_csr) if inv_sai
                        else _pattern_csr(pats["inv_aff_poly_plan"].pat_S))
            dpos = _diag_pos1(S_smooth)
            arrs["imp_dpos"] = up(dpos[fine] if full_smooth else dpos)
        else:                                # matrix-free: 1/diag(A_ff)
            improve_diag = "aff-recip"
            arrs["imp_dpos"] = up(_diag_pos1(lvl.A_ff))
    if opts.improve_z_its > 0:
        pat_Z = SparsityPattern(z_pat.indptr, z_pat.indices, z_pat.shape)
        arrs["zimp"] = up.count(build_spgemm_plan(pat_Z, patA_ff, pat_Z)
                                .device_tables(up.device))
        arrs["zimp_acf"] = up(_pos_in(cf_mat, _keys(z_pat)) + 1)
        arrs["zimp_cols"] = up(z_pat.indices)
    if opts.improve_w_its > 0 and transfer == "ideal":
        pat_W = wplan.pat_C
        arrs["wimp"] = up.count(build_spgemm_plan(patA_ff, pat_W, pat_W)
                                .device_tables(up.device))
        arrs["wimp_afc"] = up(_pos_in(lvl.A_fc, _keys(_pattern_csr(pat_W)))
                              + 1)
        arrs["wimp_rows"] = up(pat_W.row_of_pos())

    if opts.constrain_w or opts.constrain_z:
        # near-nullspace machinery (reference: src/Constrain_Z_or_W.F90)
        arrs["cn_dpos"] = up(_diag_pos1(A))
        arrs["cn_fine"], arrs["cn_coarse"] = up(fine), up(coarse)
        if opts.constrain_z:
            arrs["cn_mv_t"] = _matvec_arrays(A, up, transpose=True)
            zdT = sp.csr_matrix(zd.T)
            zdT.sort_indices()
            arrs["cnz_tables"] = _constrain_tables(zdT, up)
            # Z_drop entry <-> transposed entry permutations
            order_t = np.argsort(zd.indices.astype(np.int64)
                                 * np.int64(zd.shape[0]) + _rows(zd),
                                 kind="stable")
            inv_t = np.empty_like(order_t)
            inv_t[order_t] = np.arange(len(order_t))
            arrs["cnz_to_t"], arrs["cnz_from_t"] = up(order_t), up(inv_t)
        if opts.constrain_w:
            arrs["cn_mv"] = _matvec_arrays(A, up)
            arrs["cnw_tables"] = _constrain_tables(pats["W_drop"], up)
    arrs["coarse"] = _match_arrays(_pattern_csr(rap_plan.pat_C),
                                   pats["RAP_drop"], opts.a_lump, up)

    # the device operators, laid out as the upload lays them out
    # (air/fullspace.py): compressed under full smoothing, else masked in
    # the level's full space
    if full_smooth:
        arrs["op_A"] = _Layout(_positions(A), make_op, up)
        arrs["op_R"] = _Layout(_positions(R), make_op, up)
    else:
        arrs["op_A_ff"] = _Layout(_map_both(_positions(lvl.A_ff), fine, fine,
                                            n), make_op, up)
        arrs["op_A_fc"] = _Layout(_map_both(_positions(lvl.A_fc), fine,
                                            coarse, n), make_op, up)
        arrs["op_R"] = _Layout(_map_rows(_positions(R), coarse, n), make_op,
                               up)
        mask_f = np.zeros(n)
        mask_f[fine] = 1.0
        static["mask_f"] = up.values(mask_f)
        static["coarse"] = up(coarse, torch.int64)   # index_copy_ takes int64

    invc_meta = None
    if lvl.A_cc is not None and not full_smooth:
        A_cc = lvl.A_cc
        arrs["cc"] = up(_submatrix_map(A, A_cc, coarse, coarse))
        arrs["op_A_cc"] = _Layout(_map_both(_positions(A_cc), coarse, coarse,
                                            n), make_op, up)
        arrs["op_A_cf"] = _Layout(_map_both(_positions(lvl.A_cf), coarse,
                                            fine, n), make_op, up)
        invc_meta, arrs["invc"] = _inverse_plan(
            lvl.inv_Acc, opts.c_inverse_type_eff, opts.diag_scale_polys,
            A_cc, pats.get("inv_acc_poly_plan"), coarse, n, make_op, up)
        mask_c = np.zeros(n)
        mask_c[coarse] = 1.0
        static["mask_c"] = up.values(mask_c)

    meta = _LevelMeta(
        n=n, inv=inv_meta, z_src=z_src, invh=invh_meta, invc=invc_meta,
        transfer=transfer, strong_r=strong_r,
        improve_w=opts.improve_w_its, improve_z=opts.improve_z_its,
        improve_diag=improve_diag, constrain_w=opts.constrain_w,
        constrain_z=opts.constrain_z,
        sigma_drop=float(tolerances(numpy_dtype(up.dtype, np.float64))
                         .sigma_drop),
        full_smooth=full_smooth, static=static)
    return meta, arrs


def _exec_level(meta: _LevelMeta, arrs: dict, a_flat, nulls):
    """One level's device dict and its coarse matrix's values (reference:
    pflare_tpu/air/device_resetup.py:1255-1468).  ``nulls``: the left and
    right near-nullspace vectors ([n, k] or None), returned restricted to
    the coarse points."""
    left_v, right_v = nulls
    lv = dict(meta.static)
    if meta.constrain_z:
        # smooth the left vectors on A^T, per candidate column (reference:
        # src/Constrain_Z_or_W.F90:118-218)
        left_v = torch.stack([_exec_null_smooth(
            arrs["cn_mv_t"], a_flat, arrs["cn_dpos"], left_v[:, k])
            for k in range(left_v.shape[1])], dim=1)
    if meta.constrain_w:
        right_v = torch.stack([_exec_null_smooth(
            arrs["cn_mv"], a_flat, arrs["cn_dpos"], right_v[:, k])
            for k in range(right_v.shape[1])], dim=1)
    aff, afc, acf = (a_flat[arrs[k]] for k in ("ff", "fc", "cf"))
    affd, acf_z, afc_w = aff, acf, afc
    if meta.strong_r:
        affd = take(aff, arrs["ffd"]["src"])
        acf_z = take(acf, arrs["cfd"]["src"])
        if "fcd" in arrs:
            afc_w = take(afc, arrs["fcd"]["src"])

    if meta.full_smooth:
        lv["A"] = arrs["op_A"](a_flat)
        lv["inv_Aff"], m_smooth = _exec_inverse(meta.inv, arrs["inv"],
                                                a_flat, lv["A"])
    else:
        lv["A_ff"] = arrs["op_A_ff"](aff)
        lv["A_fc"] = arrs["op_A_fc"](afc)
        lv["inv_Aff"], m_smooth = _exec_inverse(meta.inv, arrs["inv"], aff,
                                                lv["A_ff"])

    # the inverse values Z and W read
    invh = None
    if meta.z_src in ("same", "diag-same"):
        invh = m_smooth
    elif meta.z_src == "diag-own":
        invh = _recip(take(aff, arrs["invh_dpos"]))
    elif meta.z_src == "diag-drop":
        invh = _recip(take(affd, arrs["invh_dpos"]))
    elif meta.z_src == "sep":
        invh = _exec_assembled(meta.invh, arrs["invh"], affd)

    if meta.z_src == "lair":
        # lAIR: Z rows from batched local solves on the stored sparsity,
        # against the undropped blocks, as the host solves them
        z = sai_execute(arrs["z_sai"], aff, acf)
    else:
        z = -plan_execute(arrs["z"], acf_z, invh[arrs["z_inv_at"]])
    dinv = None
    if meta.improve_diag == "direct":
        dinv = invh
    elif meta.improve_diag == "pattern":
        dinv = take(invh, arrs["imp_dpos"])
    elif meta.improve_diag == "smooth-diag":
        dinv = (m_smooth[arrs["imp_fine"]] if "imp_fine" in arrs
                else m_smooth)
    elif meta.improve_diag == "smooth-pattern":
        dinv = take(m_smooth, arrs["imp_dpos"])
    elif meta.improve_diag == "aff-recip":
        dinv = _recip(take(aff, arrs["imp_dpos"]))
    for _ in range(meta.improve_z):
        za = plan_execute(arrs["zimp"], z, aff)
        z = z - (take(acf, arrs["zimp_acf"]) + za) * dinv[arrs["zimp_cols"]]
    zdrop = take(z, arrs["zdrop"]["src"])
    if meta.constrain_z:
        zt = _exec_constrain(arrs["cnz_tables"], zdrop[arrs["cnz_to_t"]],
                             left_v[arrs["cn_fine"]],
                             left_v[arrs["cn_coarse"]], meta.sigma_drop)
        zdrop = zt[arrs["cnz_from_t"]]
    r_flat = torch.where(arrs["r_ident"], 1.0, take(zdrop, arrs["r_src"]))
    lv["R"] = arrs["op_R"](r_flat)

    if meta.transfer == "ideal":
        w = -plan_execute(arrs["w"], invh[arrs["w_inv_at"]], afc_w)
        for _ in range(meta.improve_w):
            aw = plan_execute(arrs["wimp"], aff, w)
            w = w - dinv[arrs["wimp_rows"]] * (take(afc, arrs["wimp_afc"])
                                               + aw)
        wdrop = take(w, arrs["wdrop"]["src"])
        if meta.constrain_w:
            wdrop = _exec_constrain(arrs["cnw_tables"], wdrop,
                                    right_v[arrs["cn_fine"]],
                                    right_v[arrs["cn_coarse"]],
                                    meta.sigma_drop)
        p_flat = torch.where(arrs["p_ident"], 1.0,
                             take(wdrop, arrs["p_src"]))
        lv["P"] = arrs["op_P"](p_flat)
    elif meta.transfer == "symmetric":
        p_flat = r_flat[arrs["p_from_r"]]
        lv["P"] = arrs["op_P"](p_flat)
    else:
        p_flat = arrs["p_vals"]
    ap = plan_execute(arrs["ap"], a_flat, p_flat)
    rap = plan_execute(arrs["rap"], r_flat, ap)
    coarse_vals = _exec_match(arrs["coarse"], rap)

    if "cc" in arrs:
        acc = a_flat[arrs["cc"]]
        lv["A_cc"] = arrs["op_A_cc"](acc)
        lv["A_cf"] = arrs["op_A_cf"](acf)
        lv["inv_Acc"] = _exec_inverse(meta.invc, arrs["invc"], acc,
                                      lv["A_cc"])[0]
    if meta.constrain_z:
        left_v = left_v[arrs["cn_coarse"]]
    if meta.constrain_w:
        right_v = right_v[arrs["cn_coarse"]]
    return lv, coarse_vals, (left_v, right_v)


# ~~~~~~~~~~~~~~~~~~~~~ the public plan ~~~~~~~~~~~~~~~~~~~~~


class DeviceResetup:
    """The device re-setup of a PCAIR hierarchy.

    ``plan = DeviceResetup(hierarchy, dtype, device)`` validates the
    hierarchy and builds and uploads the static tables; ``plan(A_new)``
    computes a new ``DeviceHierarchy`` (levels, coarse inverse and the
    Krylov operator ``top``) on ``device`` in ``dtype`` from one upload of
    the values of ``A_new``; ``plan.install(pc, A_new)`` puts it in place.
    ``perm``: the RCM permutation of the hierarchy (``PCAIR``'s reorder),
    under which ``A_new`` comes in the caller's order.
    ``device_bytes``: the bytes of the plan's tables on the device.
    """

    def __init__(self, hierarchy, dtype=torch.float64, device="cuda",
                 perm=None):
        opts: AIROptions = hierarchy.options
        _validate(opts, hierarchy)
        self.hierarchy = hierarchy
        self.dtype = dtype
        self.device = torch.device(device)
        up = _Tensors(self.device, dtype)
        self.meta, self.arrays = [], []
        for lvl in hierarchy.levels:
            m, a = _build_level_plan(lvl, opts, up)
            self.meta.append(m)
            self.arrays.append(a)
        self._coarse = self._build_coarse_plan(hierarchy, opts, up)
        A0 = hierarchy.levels[0].A if hierarchy.levels else \
            hierarchy.coarse_matrix
        self._top = _Layout(_positions(A0), make_op, up)
        # the near-nullspace vectors the constraints start from, in the
        # hierarchy's order (default the constant vector)
        k_null = None
        if opts.constrain_z or opts.constrain_w:
            nn = hierarchy.near_nullspace
            if nn is None:
                nn = [np.ones(A0.shape[0])]
            k_null = up.values(np.stack(nn, axis=1))
        self._nulls = (k_null if opts.constrain_z else None,
                       k_null if opts.constrain_w else None)
        # the truncation level is stored structure, like the CF splitting;
        # the probe (reference: src/AIR_MG_Setup.F90:158-256) re-runs on
        # the rebuilt coarse values with the host probe's seeded RHS
        self._probe = None
        self.probe_quality: float | None = None
        if hierarchy.auto_truncated:
            Ac = hierarchy.coarse_matrix
            b = np.random.default_rng(opts.seed + 101).standard_normal(
                Ac.shape[0])
            self._probe = {"mv": _matvec_arrays(Ac, up), "b": up.values(b)}
        # A_new's pattern, in the caller's order, and the value gather
        # into the hierarchy's order
        self._vperm = None
        pattern = A0
        if perm is not None:
            iperm = np.empty_like(perm)
            iperm[perm] = np.arange(len(perm))
            pattern = sp.csr_matrix(_positions(A0)[iperm][:, iperm])
            pattern.sort_indices()
            vperm = np.empty(A0.nnz, dtype=np.int64)
            vperm[pattern.data.astype(np.int64) - 1] = np.arange(A0.nnz)
            self._vperm = up(vperm)
            self._vperm_host = vperm
        self._indptr = pattern.indptr.copy()
        self._indices = pattern.indices.copy()
        self._A0 = A0
        self.device_bytes = up.nbytes

    def _build_coarse_plan(self, hierarchy, opts: AIROptions, up):
        """The coarse inverse's plan (reference:
        pflare_tpu/air/device_resetup.py:1188-1247): its containers are
        ELLs, as ``Inverse.to`` builds them; an assembled polynomial gets
        a plan of its own (a setup stores none for the coarse grid)."""
        inv = hierarchy.coarse_inv
        Ac = hierarchy.coarse_matrix
        plan = None
        if inv.kind == "assembled":
            if inv.coefficients is None:
                raise ValueError("assembled coarse inverse without "
                                 "coefficients not supported")
            c = np.asarray(inv.coefficients)
            order = (c.shape[1] if c.ndim == 2 else len(c)) - 1
            plan = FixedSparsityPolyPlan(
                SparsityPattern(Ac.indptr, Ac.indices, Ac.shape),
                max(1, min(order, max(Ac.shape[0] - 1, 0))),
                opts.coarsest_inverse_sparsity_order)
        meta, arrs = _inverse_plan(
            inv, opts.coarsest_inverse_type, opts.coarsest_diag_scale_polys,
            Ac, plan, None, Ac.shape[0], ELL.from_scipy, up)
        if inv.kind not in ("diagonal", "dense", "assembled"):
            arrs["mat"] = _Layout(_positions(Ac), ELL.from_scipy, up)
        return meta, arrs

    def _execute(self, a_flat):
        """(levels, coarse inverse, top, probe quality tensor or None)."""
        top = self._top(a_flat)
        nulls = self._nulls
        levels = []
        for meta, arrs in zip(self.meta, self.arrays):
            lv, a_flat, nulls = _exec_level(meta, arrs, a_flat, nulls)
            levels.append(lv)
        meta, arrs = self._coarse
        mat = arrs["mat"](a_flat) if "mat" in arrs else None
        coarse_inv = _exec_inverse(meta, arrs, a_flat, mat)[0]
        quality = None
        if self._probe is not None:
            b = self._probe["b"]
            r = b - _exec_matvec(self._probe["mv"], a_flat,
                                 coarse_inv.apply(b))
            quality = torch.linalg.norm(r) / torch.linalg.norm(b)
        return levels, coarse_inv, top, quality

    def _values(self, A_new) -> np.ndarray:
        """A_new's values in the caller's CSR order, after the
        same-pattern guard."""
        if sp.issparse(A_new):
            M = sp.csr_matrix(A_new)
            M.sort_indices()
            # out-of-pattern values would be silently mis-gathered
            if (M.nnz != len(self._indices)
                    or not np.array_equal(M.indptr, self._indptr)
                    or not np.array_equal(M.indices, self._indices)):
                raise ValueError(
                    "device re-setup requires the SAME sparsity pattern as "
                    "the matrix the plan was built for; run a full "
                    "setup() for a new pattern")
            return M.data
        vals = np.asarray(A_new)
        if vals.shape != (len(self._indices),):
            raise ValueError("value array length does not match the plan's "
                             "matrix nnz")
        return vals

    def __call__(self, A_new) -> DeviceHierarchy:
        """The device hierarchy of ``A_new``: a scipy matrix with the
        pattern of the matrix the plan was built for (in the caller's
        order), or its CSR value array."""
        vals = np.ascontiguousarray(self._values(A_new),
                                    dtype=numpy_dtype(self.dtype, np.float64))
        host = torch.from_numpy(vals)
        if self.device.type == "cuda":
            # pinned, so the copy is asynchronous and the host does not wait
            a_flat = host.pin_memory().to(self.device, non_blocking=True)
        else:
            a_flat = host.to(self.device)
        if self._vperm is not None:
            a_flat = a_flat[self._vperm]
        levels, coarse_inv, top, quality = self._execute(a_flat)
        # the one read of the re-setup
        self.probe_quality = None if quality is None else float(quality)
        return DeviceHierarchy(levels, coarse_inv, top,
                               self.hierarchy.options
                               .full_smoothing_up_and_down)

    def install(self, pc, A_new):
        """Re-set up ``pc``'s device form from the values of ``A_new``:
        ``pc.upload()`` returns the new hierarchy, Krylov operator
        included, until the next ``setup``.

        The host hierarchy is left stale but for its finest matrix,
        replaced by A_new (in the hierarchy's order), so that a later
        host ``setup(A3, structure="same")`` still re-sets up from it.
        A twin made by ``pc.on(device)`` uploads that host hierarchy, so
        it does not see an install: a twin builds its own plan with
        ``build_device_resetup()`` and installs the same matrix.  For an
        auto-truncated hierarchy the truncation level stays fixed; a
        probe quality above ``auto_truncate_tol`` on the new values is
        reported on stderr (a new truncation needs a full ``setup``).
        ``pc``'s CUDA graphs read the old operators, so they are dropped:
        the next solve captures anew."""
        pc._device_hierarchy = self(A_new)
        pc.drop_graphs()
        tol = self.hierarchy.options.auto_truncate_tol
        if self.probe_quality is not None and self.probe_quality > tol:
            print(f"# device re-setup: truncation probe "
                  f"{self.probe_quality:.2e} exceeds auto_truncate_tol "
                  f"{tol:.2e} on the new values; structure kept -- run a "
                  "full setup() to re-truncate", file=sys.stderr)
        if sp.issparse(A_new) and pc.hierarchy.levels:
            vals = self._values(A_new)
            if self._vperm is not None:
                vals = vals[self._vperm_host]
            pc.hierarchy.levels[0].A = sp.csr_matrix(
                (vals, self._A0.indices, self._A0.indptr),
                shape=self._A0.shape)
        return pc


def _validate(opts: AIROptions, hierarchy):
    bad = []
    if (opts.z_type != ZType.PRODUCT
            and not opts.one_point_classical_prolong):
        bad.append("z_type=lair with ideal prolongator")
    if opts.z_type != ZType.PRODUCT and opts.symmetric:
        bad.append("z_type=lair with symmetric")
    if not opts.reuse_sparsity or opts.reuse_amount < 3:
        bad.append("reuse_sparsity/amount")
    if bad:
        raise ValueError(
            "device re-setup does not support: " + ", ".join(bad))
