"""Holding two device-built AIR hierarchies against each other, level by
level, with the rounding ties that may part them named.

Two device first setups (``air/device_setup.py``) of one matrix, run on
two devices or by two implementations, sum in other orders, so from the
second level on their matrices differ by rounding.  Where an entry sits
exactly on a decision's edge (the strength threshold, a DDC bin edge,
the largest |A_fc| that the one-point W picks) the two can decide
otherwise and their hierarchies part there.  ``compare_setups`` holds
markers, operators, layouts and inverses equal level by level, and at
the first differing decision requires that it is such a tie and names
it.  ``LevelMatrices`` records the level matrices the comparison needs.
Views are plain numpy/scipy, so a hierarchy of the JAX package can be
viewed the same way by its caller and compared here.
"""

import numpy as np
import scipy.sparse as sp
import torch

from ..params import C_POINT, F_POINT
from ..sparse.dell import DELL, max_row_count
from . import device_setup

OPERATORS = ("A_ff", "A_fc", "R", "P")
TIE_RTOL = 1e-12     # a decision this close to its threshold is a tie


class LevelMatrices:
    """Context manager recording each level matrix (as scipy) that
    ``module``'s CF splitting (``_cf_split_device``) receives: this
    package's ``air/device_setup.py`` by default."""

    def __init__(self, module=device_setup):
        self.module, self.seen = module, []

    def __enter__(self):
        self._orig = self.module._cf_split_device

        def rec(A, opts):
            self.seen.append(A.to_scipy())
            return self._orig(A, opts)

        self.module._cf_split_device = rec
        return self.seen

    def __exit__(self, *exc):
        self.module._cf_split_device = self._orig


def inverse_view(inv, applied) -> dict:
    """Plain numpy/scipy view of a device Inverse (this package's, or
    one with the same fields);
    ``applied``: the inverse applied to ``probe_vector`` of its size."""
    mat = getattr(inv, "mat", None)
    arr = lambda a: None if a is None else np.asarray(
        a.cpu() if isinstance(a, torch.Tensor) else a, dtype=np.float64)
    return {"kind": inv.kind, "diag": arr(inv.diag),
            "coefficients": arr(inv.coefficients),
            "mat": (mat.to_scipy() if inv.kind == "assembled" else None),
            "mat_type": type(mat).__name__ if inv.kind == "assembled"
            else None, "applied": arr(applied)}


def probe_vector(n: int) -> np.ndarray:
    return np.random.default_rng(0).standard_normal(n)


def port_inverse_view(inv, n: int, like) -> dict:
    """``inverse_view`` of an Inverse of this package acting on vectors like ``like``
    (a tensor on its device, in its dtype)."""
    x = torch.as_tensor(probe_vector(n), dtype=like.dtype, device=like.device)
    return inverse_view(inv, inv.apply(x))


def setup_levels(h) -> list:
    """Plain views of the levels of a ``DeviceSetupHierarchy``."""
    out = []
    for lvl in h.levels:
        d = lvl.device
        out.append({
            "n": lvl.n, "fine": lvl.fine.cpu().numpy(),
            "coarse": lvl.coarse.cpu().numpy(),
            "ops": {k: (type(d[k]).__name__, getattr(d[k], "offsets", None),
                        d[k].to_scipy()) for k in OPERATORS},
            "inv": port_inverse_view(d["inv_Aff"], lvl.n, d["mask_f"])})
    return out


def _close(a, b, rtol, what):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    for m in (a, b):
        m.eliminate_zeros()
        m.sort_indices()
    assert a.shape == b.shape, f"{what}: shapes {a.shape} {b.shape}"
    assert np.array_equal(a.indptr, b.indptr) and np.array_equal(
        a.indices, b.indices), f"{what}: patterns differ"
    scale = max(abs(a).max() if a.nnz else 0.0, 1e-300)
    diff = np.abs(a.data - b.data).max(initial=0.0)
    assert diff <= rtol * scale, f"{what}: {diff / scale:.3e} of its max"
    return diff / scale


def inverses_close(ia, ib, rtol, coeff_rtol, what):
    """Two inverse views: kind, diagonal, assembled matrix and applied
    probe (each within ``rtol`` of its largest entry), and coefficients
    within ``coeff_rtol`` (None: not held; a polynomial's monomial
    coefficients amplify rounding where its values do not).  Returns
    (the largest relative difference of diagonal, matrix and applied
    probe, that of the coefficients)."""
    assert ia["kind"] == ib["kind"], what
    worst, coeff = 0.0, 0.0
    for key in ("diag", "applied", "coefficients"):
        a, b = ia[key], ib[key]
        assert (a is None) == (b is None), f"{what} {key}"
        if a is None:
            continue
        assert a.shape == b.shape, f"{what} {key}"
        d = np.abs(a - b).max(initial=0.0) / max(np.abs(a).max(initial=0),
                                                 1e-300)
        if key == "coefficients":
            coeff = d
            assert coeff_rtol is None or d <= coeff_rtol, (
                f"{what} {key}: {d:.3e}")
        else:
            assert d <= rtol, f"{what} {key}: {d:.3e}"
            worst = max(worst, d)
    if ia["mat"] is not None:
        assert ia["mat_type"] == ib["mat_type"], f"{what} layout"
        worst = max(worst, _close(ia["mat"], ib["mat"], rtol, what))
    return worst, coeff


def _strength(M, theta):
    """Strength pattern (as ``_strength_cols``) and its ties: entries
    within TIE_RTOL of theta times the row's off-diagonal max."""
    M = sp.csr_matrix(M)
    rows = np.repeat(np.arange(M.shape[0]), np.diff(M.indptr))
    off = rows != M.indices
    av = np.where(off, np.abs(M.data), 0.0)
    rowmax = np.zeros(M.shape[0])
    np.maximum.at(rowmax, rows, av)
    thr = theta * rowmax[rows]
    strong = off & (av >= thr) & (av > 0)
    tie = off & (np.abs(av - thr) <= TIE_RTOL * rowmax[rows])
    return strong, tie, av, thr


def split_divergence(Ma, Mb, opts, fine_a, fine_b, level):
    """Explain differing markers at a level whose matrices agree to
    rounding: the strength patterns differ only at entries on the
    threshold, or (same strength) the DDC swaps differ only at F points
    whose ratio sits on a bin edge.  Returns a note; raises
    AssertionError when the difference is no tie."""
    _close(Ma, Mb, TIE_RTOL, f"level {level} matrix")
    theta = float(opts.strong_threshold)
    sa, tie, av, thr = _strength(Ma, theta)
    sb = _strength(Mb, theta)[0]
    flips = np.nonzero(sa != sb)[0]
    if len(flips):
        assert np.all(tie[flips]), (
            f"level {level}: strength differs off the threshold")
        k = flips[0]
        return (f"level {level} strength ties",
                f"{len(flips)} entries, e.g. |a| {av[k]!r} against theta * "
                f"rowmax {thr[k]!r} (tolerance {TIE_RTOL} of the row max)")
    n = Mb.shape[0]
    cfa = np.full(n, C_POINT)
    cfa[fine_a] = F_POINT
    cfb = np.full(n, C_POINT)
    cfb[fine_b] = F_POINT
    T = DELL.from_scipy(Mb, device="cpu")
    sc = device_setup._strength_cols(T, theta)
    sc = device_setup._compact_cols(sc, max(max_row_count(sc), 1))
    rand = torch.as_tensor(np.random.default_rng(opts.seed).random(n))
    pre = device_setup._split_fused(T, sc, rand, float(opts.ddc_fraction),
                                   25, False, 0)
    is_f = (pre == F_POINT).numpy()
    d = np.abs(Mb.diagonal())
    A = sp.csr_matrix(Mb)
    A.setdiag(0)
    off = np.asarray(abs(A) @ is_f.astype(float)).ravel()
    ratio = np.where(is_f, off / np.where(d > 0, d, 1.0), 0.0)
    swap = np.nonzero(cfa != cfb)[0]
    edge = np.abs(ratio[swap] * 1000 - np.round(ratio[swap] * 1000))
    assert np.all(is_f[swap]) and np.all(edge <= 1e-9), (
        f"level {level}: DDC swaps differ off a bin edge")
    return (f"level {level} DDC bin-edge ties",
            f"{len(swap)} points, e.g. ratio {ratio[swap[0]]!r} (edges at "
            f"multiples of 1e-3, tolerance 1e-9 of a bin)")


def w_ties(Pa, Pb, A_fc, level):
    """Rows where two one-point W differ must be ties: their |A_fc|
    within TIE_RTOL of the row max.  Returns a note, or None when the
    two P are equal."""
    D = sp.csr_matrix(abs(Pa - Pb))
    D.eliminate_zeros()
    rows = np.unique(D.nonzero()[0])
    if not len(rows):
        return None
    A_fc = sp.csr_matrix(A_fc)
    for r in rows:
        va = abs(A_fc[r, Pa[r].indices[0]])
        vb = abs(A_fc[r, Pb[r].indices[0]])
        assert abs(va - vb) <= TIE_RTOL * abs(A_fc[r]).max(), (
            f"level {level}: W differs off a tie at row {r}")
    r = rows[0]
    return (f"level {level} one-point W ties",
            f"{len(rows)} rows, e.g. |A_fc| {abs(A_fc[r, Pa[r].indices[0]])!r}"
            f" against {abs(A_fc[r, Pb[r].indices[0]])!r} (tolerance "
            f"{TIE_RTOL} of the row max)")


def compare_setups(la, lb, mats_a, mats_b, opts, rtol=1e-12,
                   coeff_rtol=1e-10):
    """Hold two device-built hierarchies (``setup_levels`` views, and the
    level matrices their splittings received) level by level: markers
    equal, every operator within ``rtol`` of its largest entry with the
    same layout (DIA offsets too), inverses as ``inverses_close``.  At
    the first decision that differs by a tie (``split_divergence``,
    ``w_ties``) the comparison stops.  Returns (notes, diverged, the
    largest relative difference of an operator, that of the polynomial
    coefficients)."""
    notes, worst, coeff = [], 0.0, 0.0
    for i, (a, b) in enumerate(zip(la, lb)):
        if a["n"] != b["n"] or not np.array_equal(a["fine"], b["fine"]):
            notes.append(split_divergence(mats_a[i], mats_b[i], opts,
                                          a["fine"], b["fine"], i))
            return notes, True, worst, coeff
        assert np.array_equal(a["coarse"], b["coarse"]), f"level {i} coarse"
        worst = max(worst, _close(mats_a[i], mats_b[i], rtol,
                                  f"level {i} matrix"))
        tie = None
        for key in OPERATORS:
            ta, oa, Ma = a["ops"][key]
            tb, ob, Mb = b["ops"][key]
            assert ta == tb, f"level {i} {key}: {ta} against {tb}"
            assert (oa is None) == (ob is None) and (
                oa is None or tuple(oa) == tuple(ob)), f"level {i} {key}"
            if key == "P":
                tie = w_ties(Ma, Mb, a["ops"]["A_fc"][2], i)
                if tie:
                    continue
            worst = max(worst, _close(Ma, Mb, rtol, f"level {i} {key}"))
        w, c = inverses_close(a["inv"], b["inv"], rtol, coeff_rtol,
                              f"level {i} inverse")
        worst, coeff = max(worst, w), max(coeff, c)
        if tie:
            notes.append(tie)
            return notes, True, worst, coeff
    assert len(la) == len(lb), f"{len(la)} against {len(lb)} levels"
    return notes, False, worst, coeff
