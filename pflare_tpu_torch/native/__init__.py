"""Host setup kernels: ``native/kernels.cpp`` through ctypes.

The C++ source is this package's own copy of the reference's host
kernels (same functions, same C interface).  It is compiled with g++ into
this package's ``_build`` directory at first use, and rebuilt when the
source is newer.  Every entry point returns None when no compiler is
available; its caller then takes the numpy fallback, which computes the
same result; ``PFLARE_NO_NATIVE=1`` forces that fallback.  These are
host setup kernels, not device work.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import scipy.sparse as sp

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "kernels.cpp")
BUILD_DIR = os.path.normpath(os.path.join(_HERE, "..", "_build"))

_LIB = None
_TRIED = False

# (name, restype, argument codes, variants).  Codes: p pointer, n int64,
# d double, i int.  Variant suffixes name the (index, value) dtypes:
# "" int64/double, "_i32" int32/double, "_f32" int64/float, "_i32f32"
# int32/float.  Each wrapper converts its arrays to the variant's dtypes.
_ALL = ("", "_i32", "_f32", "_i32f32")
_SIGNATURES = (
    ("pmisr_luby", ctypes.c_int, "ppnpppi", ("", "_i32")),
    ("sym_union_count", ctypes.c_int64, "ppnppp", ("", "_i32")),
    ("sym_union_fill", None, "ppppnppp", _ALL),
    ("dd_ratio", None, "ppppnp", _ALL),
    ("drop_small_count", ctypes.c_int64, "pppndiiiip", _ALL),
    ("drop_small_fill", None, "pppndiiiipp", _ALL),
    ("spgemm_drop", ctypes.c_int64, "ppppppnndiippp", _ALL),
    ("split_cf", None, "pppnpp" + "ppp" * 4 + "i", _ALL),
    ("ap_onepoint", ctypes.c_int64, "pppppnppp", _ALL),
    ("poly_on_sparsity", None, "pppppnnpnp", _ALL),
    ("newton_on_sparsity", None, "pppppnnppndp", _ALL),
    ("one_point_strongest", ctypes.c_int64, "pppnp", _ALL),
    ("aggregation", ctypes.c_int64, "ppnpp", ("",)),
    ("plan_count", ctypes.c_int64, "pppn", ("", "_i32")),
    ("plan_fill", ctypes.c_int64, "ppppppnnppp", ("", "_i32")),
    ("plan_fill_lump", ctypes.c_int64, "ppppppnnppp", ("", "_i32")),
    ("plan_fill32", ctypes.c_int64, "ppppppnnppp", ("", "_i32")),
    ("plan_fill_lump32", ctypes.c_int64, "ppppppnnppp", ("", "_i32")),
    ("plan_execute", None, "pppppndpn", ("", "_i32")),
    ("gather_fill", None, "ppndp", ("", "_i32")),
    ("spgemm_onto_pattern", None, "ppppppppnnip", _ALL),
)
_CTYPES = {"p": ctypes.c_void_p, "n": ctypes.c_int64, "d": ctypes.c_double,
           "i": ctypes.c_int}


def _so_path():
    return os.path.join(BUILD_DIR, f"_kernels_{sys.implementation.cache_tag}.so")


def _build(out: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private name and rename: concurrent test workers may
    # build at once, and a reader must never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                        "-std=c++17", SOURCE, "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    """The loaded ctypes library, or None when it cannot be built or when
    ``PFLARE_NO_NATIVE=1`` forces the numpy paths (as in the reference,
    pflare_tpu/native/__init__.py:40)."""
    global _LIB, _TRIED
    if os.environ.get("PFLARE_NO_NATIVE") == "1":
        return None
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _so_path()
    try:
        if (not os.path.exists(path)
                or os.path.getmtime(path) < os.path.getmtime(SOURCE)):
            _build(path)
        lib = ctypes.CDLL(path)
    except (OSError, subprocess.CalledProcessError):
        return None
    for name, restype, codes, variants in _SIGNATURES:
        for suffix in variants:
            fn = getattr(lib, name + suffix)
            fn.restype = restype
            fn.argtypes = [_CTYPES[c] for c in codes]
    _LIB = lib
    return _LIB


def _p(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _dispatch(index_arrays, value_arrays=()):
    """(index dtype, value dtype, symbol suffix): int32 indices when every
    index array is int32 (scipy's default), float32 values when every value
    array is float32 -- zero-copy either way.  Without value arrays the
    suffix names the index variant only."""
    i32 = all(getattr(a, "dtype", None) == np.int32 for a in index_arrays)
    f32 = bool(value_arrays) and all(
        getattr(a, "dtype", None) == np.float32 for a in value_arrays)
    suffix = ("_i32" if i32 else "") + ("f32" if i32 and f32 else
                                         "_f32" if f32 else "")
    return (np.int32 if i32 else np.int64,
            np.float32 if f32 else np.float64, suffix)


def _c(a, dtype):
    return np.ascontiguousarray(a, dtype=dtype)


def _opt(a):
    """A pointer, or NULL for None."""
    return None if a is None else _p(a)


def pmisr_luby_native(indptr, indices, measure, cf, assigned, max_steps):
    """Returns (cf, rounds) or None when native is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    idt, _, suffix = _dispatch((indptr, indices))
    indptr, indices = _c(indptr, idt), _c(indices, idt)
    measure = _c(measure, np.float64)
    cf = _c(cf, np.int64)
    assigned = _c(assigned, np.uint8)
    rounds = getattr(lib, "pmisr_luby" + suffix)(
        _p(indptr), _p(indices), len(indptr) - 1, _p(measure), _p(cf),
        _p(assigned), int(max_steps))
    return cf, rounds


def drop_small_native(A, tol, rel_mode, diag_strength, drop_diag_mode, lump):
    """Compact threshold-drop of a sorted csr in one count+fill sweep.
    Returns the new csr, or None when native is unavailable or lumping
    would need to insert a missing diagonal (the caller's COO path)."""
    lib = get_lib()
    if lib is None:
        return None
    idt, vdt, suffix = _dispatch((A.indptr, A.indices), (A.data,))
    indptr, indices = _c(A.indptr, idt), _c(A.indices, idt)
    data = _c(A.data, vdt)
    n_rows = A.shape[0]
    args = (float(tol), int(rel_mode), int(diag_strength),
            int(drop_diag_mode), int(lump))
    out_indptr = np.empty(n_rows + 1, dtype=idt)
    nnz = getattr(lib, "drop_small_count" + suffix)(
        _p(indptr), _p(indices), _p(data), n_rows, *args, _p(out_indptr))
    if nnz < 0:
        return None
    out_cols = np.empty(nnz, dtype=idt)
    out_data = np.empty(nnz, dtype=vdt)
    getattr(lib, "drop_small_fill" + suffix)(
        _p(indptr), _p(indices), _p(data), n_rows, *args, _p(out_cols),
        _p(out_data))
    out = sp.csr_matrix((out_data, out_cols, out_indptr), shape=A.shape)
    out.has_sorted_indices = True
    return out


def spgemm_drop_native(R, B, tol, relative, lump):
    """Fused C = drop(R @ B) with a relative row tolerance and optional
    diagonal lumping.  Returns the dropped product, or None when native is
    unavailable / a lumped row keeps no diagonal (the caller then forms
    the product and drops it)."""
    lib = get_lib()
    if lib is None:
        return None
    idt, vdt, suffix = _dispatch((R.indptr, R.indices, B.indptr, B.indices),
                                 (R.data, B.data))
    r = [_c(R.indptr, idt), _c(R.indices, idt), _c(R.data, vdt)]
    b = [_c(B.indptr, idt), _c(B.indices, idt), _c(B.data, vdt)]
    n_rows, n_cols = R.shape[0], B.shape[1]
    # upper bound on the product's nnz: the triple count
    ub = max(int(np.diff(B.indptr)[R.indices].sum()) if R.nnz else 0, 1)
    out_indptr = np.empty(n_rows + 1, dtype=idt)
    out_cols = np.empty(ub, dtype=idt)
    out_data = np.empty(ub, dtype=vdt)
    nnz = getattr(lib, "spgemm_drop" + suffix)(
        *map(_p, r), *map(_p, b), n_rows, n_cols, float(tol), int(relative),
        int(lump), _p(out_indptr), _p(out_cols), _p(out_data))
    if nnz < 0:
        return None
    out = sp.csr_matrix((out_data[:nnz].copy(), out_cols[:nnz].copy(),
                         out_indptr), shape=(n_rows, n_cols))
    out.has_sorted_indices = True
    return out


def dd_ratio_native(indptr, indices, data, f_mask):
    lib = get_lib()
    if lib is None:
        return None
    idt, vdt, suffix = _dispatch((indptr, indices), (data,))
    indptr, indices = _c(indptr, idt), _c(indices, idt)
    data = _c(data, vdt)
    fm = _c(f_mask, np.uint8)
    n = len(indptr) - 1
    out = np.zeros(n, dtype=np.float64)
    getattr(lib, "dd_ratio" + suffix)(_p(indptr), _p(indices), _p(data),
                                      _p(fm), n, _p(out))
    return out


def _on_sparsity(name, A, s_indptr, s_indices, *extra):
    lib = get_lib()
    if lib is None:
        return None
    idt, vdt, suffix = _dispatch(
        (A.indptr, A.indices, s_indptr, s_indices), (A.data,))
    a = [_c(A.indptr, idt), _c(A.indices, idt), _c(A.data, vdt)]
    s = [_c(s_indptr, idt), _c(s_indices, idt)]
    out = np.empty(int(s_indptr[-1]), dtype=vdt)
    getattr(lib, name + suffix)(*map(_p, a), *map(_p, s), A.shape[0],
                                A.shape[1], *extra, _p(out))
    return out


def poly_on_sparsity_native(A, s_indptr, s_indices, coeffs):
    """(sum_k coeffs[k] A^k)|_S on the S pattern in one native sweep.
    Returns the data in S's CSR entry order, or None."""
    coeffs = _c(coeffs, np.float64)
    return _on_sparsity("poly_on_sparsity", A, s_indptr, s_indices,
                        _p(coeffs), len(coeffs) - 1)


def newton_on_sparsity_native(A, s_indptr, s_indices, wr, wi, tol_zero):
    """Assembled Newton-basis inverse data on the S pattern, or None."""
    wr, wi = _c(wr, np.float64), _c(wi, np.float64)
    return _on_sparsity("newton_on_sparsity", A, s_indptr, s_indices,
                        _p(wr), _p(wi), len(wr), float(tol_zero))


def split_cf_native(A, fine, coarse, need_cc: bool):
    """(A_ff, A_fc, A_cf, A_cc) in ONE streaming pass over A by the CF
    classes.  fine/coarse are sorted index arrays partitioning range(n).
    Returns the 4 csr matrices (A_cc None unless need_cc), or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = A.shape[0]
    if len(fine) + len(coarse) != n:   # must partition range(n)
        return None
    idt, vdt, suffix = _dispatch((A.indptr, A.indices), (A.data,))
    a = [_c(A.indptr, idt), _c(A.indices, idt), _c(A.data, vdt)]
    n_f, n_c = len(fine), len(coarse)
    is_fine = np.zeros(n, dtype=np.uint8)
    is_fine[fine] = 1
    col_new = np.empty(n, dtype=idt)      # position within its class
    col_new[fine] = np.arange(n_f, dtype=idt)
    col_new[coarse] = np.arange(n_c, dtype=idt)
    nnz = max(A.nnz, 1)                   # routing is exclusive
    blocks = [(np.empty(m + 1, dtype=idt), np.empty(nnz, dtype=idt),
               np.empty(nnz, dtype=vdt)) for m in (n_f, n_f, n_c, n_c)]
    getattr(lib, "split_cf" + suffix)(
        *map(_p, a), n, _p(is_fine), _p(col_new),
        *(_p(arr) for blk in blocks for arr in blk), int(need_cc))

    def _mk(blk, shape):
        indptr, cols, data = blk
        m = int(indptr[-1])
        M = sp.csr_matrix((data[:m].copy(), cols[:m].copy(), indptr),
                          shape=shape)
        M.has_sorted_indices = True
        return M

    return (_mk(blocks[0], (n_f, n_f)), _mk(blocks[1], (n_f, n_c)),
            _mk(blocks[2], (n_c, n_f)),
            _mk(blocks[3], (n_c, n_c)) if need_cc else None)


def ap_onepoint_native(A, P):
    """C = A @ P when every row of P holds at most ONE entry (the
    one-point prolongator P = [W; I]): a streaming column relabel plus a
    per-row duplicate merge.  The caller checks P's row widths.  Returns
    the product csr, or None."""
    lib = get_lib()
    if lib is None:
        return None
    idt, vdt, suffix = _dispatch((A.indptr, A.indices), (A.data, P.data))
    a = [_c(A.indptr, idt), _c(A.indices, idt), _c(A.data, vdt)]
    n_rows = A.shape[0]
    # dense per-row (column, value) view of P; -1 marks an empty row
    pcol = np.full(P.shape[0], -1, dtype=idt)
    pval = np.zeros(P.shape[0], dtype=vdt)
    prows = np.flatnonzero(np.diff(P.indptr) == 1)
    pcol[prows] = P.indices
    pval[prows] = P.data
    ub = max(A.nnz, 1)                 # <=1 output entry per A entry
    out_indptr = np.empty(n_rows + 1, dtype=idt)
    out_cols = np.empty(ub, dtype=idt)
    out_data = np.empty(ub, dtype=vdt)
    nnz = getattr(lib, "ap_onepoint" + suffix)(
        *map(_p, a), _p(pcol), _p(pval), n_rows, _p(out_indptr),
        _p(out_cols), _p(out_data))
    out = sp.csr_matrix((out_data[:nnz].copy(), out_cols[:nnz].copy(),
                         out_indptr), shape=(n_rows, P.shape[1]))
    out.has_sorted_indices = True
    return out


def symmetrize_pattern_native(S):
    """Union pattern S | S^T (values unspecified: the caller overwrites
    them with 1.0).  Returns a sorted csr or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = S.shape[0]
    if S.shape[1] != n:
        return None
    idt, vdt, suffix = _dispatch((S.indptr, S.indices), (S.data,))
    indptr, indices = _c(S.indptr, idt), _c(S.indices, idt)
    t_indptr = np.empty(n + 1, dtype=idt)
    t_indices = np.empty(max(S.nnz, 1), dtype=idt)
    rowcnt = np.empty(n, dtype=idt)
    total = getattr(lib, "sym_union_count" + _dispatch(
        (S.indptr, S.indices))[2])(
        _p(indptr), _p(indices), n, _p(t_indptr), _p(t_indices), _p(rowcnt))
    out_indptr = np.zeros(n + 1, dtype=idt)
    np.cumsum(rowcnt, out=out_indptr[1:])
    out_indices = np.empty(total, dtype=idt)
    out_data = np.empty(total, dtype=vdt)
    getattr(lib, "sym_union_fill" + suffix)(
        _p(indptr), _p(indices), _p(t_indptr), _p(t_indices), n,
        _p(out_indptr), _p(out_indices), _p(out_data))
    out = sp.csr_matrix((out_data, out_indices, out_indptr), shape=S.shape)
    out.has_sorted_indices = True
    return out


def one_point_strongest_native(A):
    """W: one strongest-|entry| column per row (lowest-column tie-break;
    reference: src/Grid_Transfer.F90:26).  Returns a sorted unit-valued
    csr, or None."""
    lib = get_lib()
    if lib is None:
        return None
    n_rows = A.shape[0]
    idt, vdt, suffix = _dispatch((A.indptr, A.indices), (A.data,))
    indptr, indices = _c(A.indptr, idt), _c(A.indices, idt)
    data = _c(A.data, vdt)
    out_cols = np.empty(n_rows, dtype=idt)
    cnt = getattr(lib, "one_point_strongest" + suffix)(
        _p(indptr), _p(indices), _p(data), n_rows, _p(out_cols))
    keep = out_cols >= 0
    out_indptr = np.zeros(n_rows + 1, dtype=idt)
    np.cumsum(keep, out=out_indptr[1:], dtype=idt)
    W = sp.csr_matrix((np.ones(int(cnt), dtype=A.data.dtype),
                       out_cols[keep], out_indptr), shape=A.shape)
    W.has_sorted_indices = True
    return W


def aggregation_native(indptr, indices, cf, aggregates):
    """The sequential root-node aggregation sweeps; fills the int64 arrays
    ``cf`` and ``aggregates`` in place.  Returns the aggregate count, or
    None."""
    lib = get_lib()
    if lib is None:
        return None
    if cf.dtype != np.int64 or aggregates.dtype != np.int64:
        raise TypeError("aggregation_native: cf and aggregates must be int64")
    indptr, indices = _c(indptr, np.int64), _c(indices, np.int64)
    return lib.aggregation(_p(indptr), _p(indices), len(indptr) - 1, _p(cf),
                           _p(aggregates))


def _plan_triples(fill, out_dtype, a_indptr, a_indices, b_indptr, b_indices,
                  c_indptr, c_indices, n_cols):
    """The product triples (a_pos, b_pos, c_pos) of C = A@B on C's
    pattern, row by row (the ``fill`` kernel decides what happens to the
    products outside it).  int32 positions unless they would wrap."""
    lib = get_lib()
    if lib is None:
        return None
    idt, _, suffix = _dispatch((a_indptr, a_indices, b_indptr, b_indices,
                                c_indptr, c_indices))
    arrs = [_c(a, idt) for a in (a_indptr, a_indices, b_indptr, b_indices,
                                 c_indptr, c_indices)]
    n_rows = len(arrs[0]) - 1
    total = getattr(lib, "plan_count" + suffix)(
        _p(arrs[0]), _p(arrs[1]), _p(arrs[2]), n_rows)
    if out_dtype == np.int32 and total >= 2**31:
        fill, out_dtype = fill.replace("32", ""), np.int64
    pos = [np.empty(total, dtype=out_dtype) for _ in range(3)]
    kept = getattr(lib, fill + suffix)(*map(_p, arrs), n_rows, int(n_cols),
                                       *map(_p, pos))
    return tuple(p_[:kept] for p_ in pos)


def plan_triples_native(a_indptr, a_indices, b_indptr, b_indices, c_indptr,
                        c_indices, n_cols):
    """(a_pos, b_pos, c_pos) int64 of the products of C = A@B that land
    in C's pattern, or None.  ``n_cols`` is the column count of B and C."""
    return _plan_triples("plan_fill", np.int64, a_indptr, a_indices,
                         b_indptr, b_indices, c_indptr, c_indices, n_cols)


def plan_triples_lump_native(a_indptr, a_indices, b_indptr, b_indices,
                             c_indptr, c_indices, n_cols):
    """Like ``plan_triples_native``, but a product outside C's pattern is
    redirected to the diagonal of its row (the fused drop and lump of the
    RAP re-product); rows without a diagonal drop it.  Or None."""
    return _plan_triples("plan_fill_lump", np.int64, a_indptr, a_indices,
                         b_indptr, b_indices, c_indptr, c_indices, n_cols)


def plan_triples32_native(a_indptr, a_indices, b_indptr, b_indices,
                          c_indptr, c_indices, n_cols, lump=False):
    """``plan_triples_native`` (``plan_triples_lump_native`` with
    ``lump``) with int32 positions, half the triple memory; int64 when a
    count would wrap.  Or None."""
    return _plan_triples("plan_fill_lump32" if lump else "plan_fill32",
                         np.int32, a_indptr, a_indices, b_indptr, b_indices,
                         c_indptr, c_indices, n_cols)


def plan_execute_native(a_data, b_data, a_pos, b_pos, c_pos, nnz_out,
                        alpha=1.0):
    """out[c_pos[k]] += alpha * a[a_pos[k]] * b[b_pos[k]] over k ascending
    (b None: a unit second operand), in float64: the accumulation order of
    a numpy bincount over the same triples.  Returns out, or None."""
    lib = get_lib()
    if lib is None:
        return None
    pos = (a_pos, c_pos) + (() if b_pos is None else (b_pos,))
    idt, _, suffix = _dispatch(pos)
    a, a_pos, c_pos = _c(a_data, np.float64), _c(a_pos, idt), _c(c_pos, idt)
    b = None if b_data is None else _c(b_data, np.float64)
    b_pos = None if b_pos is None else _c(b_pos, idt)
    out = np.empty(int(nnz_out), dtype=np.float64)
    getattr(lib, "plan_execute" + suffix)(
        _p(a), _opt(b), _p(a_pos), _opt(b_pos), _p(c_pos), len(a_pos),
        float(alpha), _p(out), int(nnz_out))
    return out


def gather_fill_native(src, idx, fill):
    """out[k] = src[idx[k]] where idx[k] >= 0, else ``fill``, in float64.
    Returns out, or None."""
    lib = get_lib()
    if lib is None:
        return None
    idt, _, suffix = _dispatch((idx,))
    src, idx = _c(src, np.float64), _c(idx, idt)
    out = np.empty(len(idx), dtype=np.float64)
    getattr(lib, "gather_fill" + suffix)(_p(src), _p(idx), len(idx),
                                         float(fill), _p(out))
    return out


def spgemm_onto_pattern_native(A, B, P, lump: bool):
    """(A @ B) restricted onto P's pattern, the product outside it lumped
    onto P's diagonal with ``lump``, without forming the whole product
    (the numeric-only re-setup product).  Returns a csr with P's pattern,
    or None."""
    lib = get_lib()
    if lib is None:
        return None
    idt, vdt, suffix = _dispatch(
        (A.indptr, A.indices, B.indptr, B.indices, P.indptr, P.indices),
        (A.data, B.data))
    a = [_c(A.indptr, idt), _c(A.indices, idt), _c(A.data, vdt)]
    b = [_c(B.indptr, idt), _c(B.indices, idt), _c(B.data, vdt)]
    p = [_c(P.indptr, idt), _c(P.indices, idt)]
    out = np.empty(P.nnz, dtype=vdt)
    getattr(lib, "spgemm_onto_pattern" + suffix)(
        *map(_p, a), *map(_p, b), *map(_p, p), A.shape[0], B.shape[1],
        int(lump), _p(out))
    res = sp.csr_matrix((out, P.indices.copy(), P.indptr.copy()),
                        shape=(A.shape[0], B.shape[1]))
    res.has_sorted_indices = True
    return res
