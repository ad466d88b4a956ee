"""Device-resident sparse setup primitives (DELL: device ELL).

Ported from ``pflare_tpu.sparse.dell``.  The first setup on the device
(air/device_setup.py) discovers every pattern there, so its matrices are
padded rectangles whose width follows the fill level by level:

  * a ``DELL`` is a padded pair (data, cols) ``[n, K]`` whose dead slots
    hold (0, PADCOL) and whose live columns are sorted ascending, so the
    live entries sit left of the dead ones;
  * SpGEMM is expand (gather B's rows at A's columns) -> stable row sort
    -> segmented sum -> fused threshold drop and lump -> row-sort
    compaction, every step a torch op on the tensors' device;
  * the host reads one integer per product (the largest kept row) and
    slices the padded width down to it before the next product.

``cols`` is int32 (the expanded products are the setup's largest
tensors); it widens to int64 only where it indexes.  Every PADCOL index
is clamped or sent to a sentinel before it indexes anything: an
out-of-range index on a CUDA tensor is a device-side assert.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .dtypes import numpy_dtype

PADCOL = 2**30
OFFBIG = 2**29
CENSUS_ROWS = 1024

# Above this many candidate entries (rows x Ka x Kb) the expand -> sort ->
# segsum -> drop pipeline runs in row chunks of at most this many
# candidates, each compacted to its own width: the full-width
# intermediates of a large product would otherwise hold several times the
# output (pflare_tpu/sparse/dell.py:271-278)
_SPGEMM_CHUNK_LIMIT = 1 << 26
# the per-row lookup of a restriction plan (restrict_plan) works on
# [rows, K, max(K, Ka)] tensors; chunks keep them within this many
_RESTRICT_CHUNK_LIMIT = 1 << 26


class DELL:
    """Padded device sparse matrix: ``data``/``cols`` ``[n, K]``, live
    columns sorted ascending per row, dead slots (0, PADCOL); ``n_cols``
    is the column count."""

    def __init__(self, data, cols, n_cols: int):
        self.data = data
        self.cols = cols
        self.n_cols = int(n_cols)
        self._safe = None

    @property
    def shape(self):
        return (self.data.shape[0], self.n_cols)

    @property
    def K(self):
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def safe_cols(self):
        """The columns clamped into range (dead slots gather a real entry
        and multiply it by their 0), built once."""
        if self._safe is None:
            self._safe = torch.clamp(self.cols, max=self.n_cols - 1).long()
        return self._safe

    def matvec(self, x):
        """y = A @ x: one gather of x at the clamped columns, row sums."""
        n, K = self.data.shape
        g = x.index_select(0, self.safe_cols().reshape(-1)).reshape(n, K)
        return (self.data * g).sum(dim=1)

    def __matmul__(self, x):
        return self.matvec(x)

    def diagonal(self):
        n = self.data.shape[0]
        isd = self.cols == _ridx(n, self.device)[:, None]
        return torch.where(isd, self.data, 0.0).sum(dim=1)

    def row_counts(self):
        return (self.cols < PADCOL).sum(dim=1)

    def to(self, device) -> "DELL":
        return DELL(self.data.to(device), self.cols.to(device), self.n_cols)

    @staticmethod
    def from_scipy(A, dtype=torch.float64, device="cuda") -> "DELL":
        """From a scipy matrix, at the width of its longest row."""
        A = sp.csr_matrix(A)
        A.sort_indices()
        n = A.shape[0]
        row_len = np.diff(A.indptr)
        K = max(int(row_len.max()) if A.nnz else 1, 1)
        cols = np.full((n, K), PADCOL, dtype=np.int32)
        data = np.zeros((n, K), dtype=numpy_dtype(dtype, np.float64))
        if A.nnz:
            rows = np.repeat(np.arange(n), row_len)
            offs = np.arange(A.nnz) - np.repeat(A.indptr[:-1], row_len)
            cols[rows, offs] = A.indices.astype(np.int32)
            data[rows, offs] = A.data
        return DELL(torch.from_numpy(data).to(device),
                    torch.from_numpy(cols).to(device), A.shape[1])

    def to_scipy(self) -> sp.csr_matrix:
        cols = self.cols.cpu().numpy()
        data = self.data.cpu().numpy().astype(np.float64)
        live = cols < PADCOL
        n = cols.shape[0]
        indptr = np.zeros(n + 1, dtype=np.int64)
        indptr[1:] = np.cumsum(live.sum(axis=1))
        out = sp.csr_matrix(
            (data[live], cols[live].astype(np.int64), indptr),
            shape=(n, self.n_cols))
        out.has_sorted_indices = True
        return out


def _ridx(n: int, device, dtype=torch.int32):
    return torch.arange(n, dtype=dtype, device=device)


def _pad_cols(cols, width: int):
    """Pad a cols-only pattern with PADCOL slots up to ``width``."""
    extra = width - cols.shape[1]
    if extra <= 0:
        return cols
    return torch.cat([cols, torch.full((cols.shape[0], extra), PADCOL,
                                       dtype=cols.dtype,
                                       device=cols.device)], dim=1)


# ~~~~~~~~~~~~~~~~~~ row-wise building blocks ~~~~~~~~~~~~~~~~~~


def sort_rows(cols, vals):
    """Stable sort of (col, val) pairs ascending by col along the last
    axis; PADCOL pads move right."""
    c, order = torch.sort(cols, dim=-1, stable=True)
    return c, torch.gather(vals, -1, order)


def segsum_rows(cols, vals):
    """Sorted rows -> duplicate columns merged: the first slot of each run
    keeps (its column, the run's total), the others die (PADCOL, 0).  The
    totals are one ``segment_reduce`` over the runs' lengths, which adds
    each run in slot order, so a card sums as the CPU does, the same on
    every run."""
    n, K = cols.shape
    if K == 0:
        return cols, vals
    first = torch.ones_like(cols, dtype=torch.bool)
    first[:, 1:] = cols[:, 1:] != cols[:, :-1]
    slot = torch.arange(K, device=cols.device).expand(n, K)
    # the next run's first slot after each slot (K past the row's end)
    nxt = torch.where(first, slot, K)
    nxt = torch.cat([nxt[:, 1:], nxt.new_full((n, 1), K)], dim=1)
    nxt = torch.cummin(nxt.flip(1), dim=1).values.flip(1)
    lengths = torch.where(first, nxt - slot, 0)
    out_v = torch.segment_reduce(vals, "sum", lengths=lengths, axis=1,
                                 unsafe=True, initial=0.0)
    keep = first & (cols < PADCOL)
    return torch.where(keep, cols, PADCOL), torch.where(keep, out_v, 0.0)


def drop_rows(cols, vals, tol, relative: bool, lump: bool, diag_of_row=None):
    """Fused threshold drop on merged rows (reference semantics:
    remove_small_from_sparse / the fused drop in spgemm_drop,
    src/PETSc_Helper.F90:108-412): a relative tolerance scales by the row
    max |value|; the diagonal is never dropped unless exactly 0; dropped
    values optionally lump onto the kept diagonal.  ``diag_of_row``: the
    column that counts as each row's diagonal (default the row index)."""
    live = cols < PADCOL
    if diag_of_row is None:
        diag_of_row = _ridx(cols.shape[0], cols.device, cols.dtype)
    is_diag = cols == diag_of_row.to(cols.dtype)[:, None]
    av = vals.abs()
    if relative:
        rowmax = torch.where(live, av, 0.0).amax(dim=1, keepdim=True) \
            if cols.shape[1] else av
        rt = tol * rowmax
    else:
        rt = torch.full_like(vals, tol)
    keep = (av >= rt) | is_diag
    keep = keep & (vals != 0.0) & live
    if lump:
        lacc = torch.where(live & ~keep, vals, 0.0).sum(dim=1, keepdim=True)
        vals = torch.where(is_diag & keep, vals + lacc, vals)
    return (torch.where(keep, cols, PADCOL),
            torch.where(keep, vals, 0.0))


def compact(cols, vals, new_K: int):
    """Push live entries left (stable sort) and set the padded width to
    ``new_K`` (slicing, or padding with dead slots)."""
    c, v = sort_rows(cols, vals)
    if new_K <= c.shape[1]:
        return c[:, :new_K], v[:, :new_K]
    extra = new_K - c.shape[1]
    return (_pad_cols(c, new_K),
            torch.cat([v, v.new_zeros((v.shape[0], extra))], dim=1))


def max_row_count(cols) -> int:
    """The largest number of live entries in a row: one integer read
    back, the shape discovery of a product."""
    if cols.numel() == 0:
        return 0
    return int((cols < PADCOL).sum(dim=1).max())


# ~~~~~~~~~~~~~~~~~~ SpGEMM ~~~~~~~~~~~~~~~~~~


def _sentinel_rows(B: DELL):
    """B's cols and data with a dead sentinel row appended: A's dead
    slots gather it."""
    Kb = B.K
    bc1 = torch.cat([B.cols, torch.full((1, Kb), PADCOL, dtype=B.cols.dtype,
                                        device=B.device)], dim=0)
    bd1 = torch.cat([B.data, B.data.new_zeros((1, Kb))], dim=0)
    return bc1, bd1


def _expand(a_data, a_cols, bc1, bd1, nb: int):
    alive = a_cols < PADCOL
    safe = torch.where(alive, torch.clamp(a_cols, max=nb - 1),
                       nb).long()
    rows = a_cols.shape[0]
    ccols = bc1[safe]                                  # [rows, Ka, Kb]
    cvals = torch.where(alive, a_data, 0.0)[:, :, None] * bd1[safe]
    return ccols.reshape(rows, -1), cvals.reshape(rows, -1)


def spgemm_expand(A: DELL, B: DELL):
    """Candidate triples of C = A @ B as padded rows ``[n, Ka*Kb]``; dead
    A slots gather B's sentinel row (PADCOL, 0)."""
    bc1, bd1 = _sentinel_rows(B)
    return _expand(A.data, A.cols, bc1, bd1, B.data.shape[0])


def spgemm_merge(A: DELL, B: DELL):
    """C = A @ B merged (duplicates summed) at full padded width."""
    ccols, cvals = spgemm_expand(A, B)
    return segsum_rows(*sort_rows(ccols, cvals))


def _spgemm_drop_rows(a_data, a_cols, bc1, bd1, nb, tol, relative, lump,
                      diag_of_row):
    ccols, cvals = _expand(a_data, a_cols, bc1, bd1, nb)
    ccols, cvals = segsum_rows(*sort_rows(ccols, cvals))
    return drop_rows(ccols, cvals, tol, relative, lump,
                     diag_of_row=diag_of_row)


def spgemm_drop_dell(A: DELL, B: DELL, tol: float, relative: bool,
                     lump: bool, diag_of_row=None) -> DELL:
    """Fused C = drop(A @ B), the device sibling of the native spgemm_drop
    and of the reference's product + drop chain.  One integer read back
    sizes the output (one a chunk for a product above
    ``_SPGEMM_CHUNK_LIMIT`` candidates, whose chunks are compacted as they
    come).  ``diag_of_row``: the column that counts as each row's
    protected diagonal (default the row index; the coarse-rows-only RAP
    passes the global coarse positions)."""
    n = A.data.shape[0]
    nb = B.data.shape[0]
    bc1, bd1 = _sentinel_rows(B)
    if diag_of_row is None:
        diag_of_row = _ridx(n, A.device, A.cols.dtype)
    per_row = max(A.K * B.K, 1)
    ch = n if n * per_row <= _SPGEMM_CHUNK_LIMIT else max(
        _SPGEMM_CHUNK_LIMIT // per_row, 1)
    parts = []
    for s in range(0, n, ch):
        c, v = _spgemm_drop_rows(A.data[s:s + ch], A.cols[s:s + ch], bc1,
                                 bd1, nb, float(tol), relative, lump,
                                 diag_of_row[s:s + ch])
        parts.append(compact(c, v, max(max_row_count(c), 1)))
    if len(parts) == 1:
        c, v = parts[0]
    else:
        K_new = max(c.shape[1] for c, _ in parts)
        c = torch.cat([_pad_cols(c, K_new) for c, _ in parts], dim=0)
        v = torch.cat([torch.cat([v, v.new_zeros((v.shape[0],
                                                   K_new - v.shape[1]))],
                                 dim=1) for _, v in parts], dim=0)
    return DELL(v, c, B.n_cols)


def onecol_product(A: DELL, pcol, pval, n_cols_new: int) -> DELL:
    """AP = A @ P for a P with at most one live entry per row: a column
    relabelling of A, AP[i, pcol[j]] += A[i, j] * pval[j], merged rowwise
    at A's own width.  ``pcol``: [n_cols(A)] target column per P row
    (PADCOL: empty row); ``pval``: the matching value."""
    live = A.cols < PADCOL
    safe = torch.clamp(A.cols, max=pcol.shape[0] - 1).long()
    newc = torch.where(live, pcol[safe].to(A.cols.dtype), PADCOL)
    newv = torch.where(live, A.data * pval[safe], 0.0)
    newc = torch.where(newv == 0.0, PADCOL, newc)
    c, v = segsum_rows(*sort_rows(newc, newv))
    return DELL(v, c, n_cols_new)


# ~~~~~~~~~~~~~~~~~~ extraction ~~~~~~~~~~~~~~~~~~


def extract_dell(A: DELL, row_idx, col_mask, col_newidx, n_cols_new: int,
                 ensure_diag: bool = False,
                 compact_width: bool = True) -> DELL:
    """Submatrix A[row_idx][:, col_mask] with columns renumbered by
    ``col_newidx`` (the device analogue of MatCreateSubMatrix, reference:
    src/PETSc_Helperk.kokkos.cxx:1801-2403).  ``ensure_diag`` appends a
    structural diagonal slot where one is missing (the polynomial's c0 I
    term must land); ``compact_width=False`` keeps the input width (an
    extraction only shrinks rows) and reads nothing back."""
    row_idx = row_idx.long()
    cols = A.cols[row_idx]
    vals = A.data[row_idx]
    live = cols < PADCOL
    safe = torch.clamp(cols, max=col_mask.shape[0] - 1).long()
    keep = live & col_mask[safe]
    ncols = torch.where(keep, col_newidx[safe].to(cols.dtype), PADCOL)
    nvals = torch.where(keep, vals, 0.0)
    if ensure_diag:
        ridx = _ridx(row_idx.shape[0], A.device, cols.dtype)
        has_diag = (ncols == ridx[:, None]).any(dim=1)
        ncols = torch.cat([ncols, torch.where(has_diag, PADCOL,
                                              ridx)[:, None]], dim=1)
        nvals = torch.cat([nvals, nvals.new_zeros((nvals.shape[0], 1))],
                          dim=1)
    K_new = (max(max_row_count(ncols), 1) if compact_width
             else ncols.shape[1])
    c, v = compact(ncols, nvals, K_new)
    return DELL(v, c, n_cols_new)


# ~~~~~~~~~~ restriction plan: products onto one fixed pattern ~~~~~~~~~~
#
# When products restrict onto the pattern Xc (the polynomial power
# recurrence, the Newton basis steps, the fixed-sparsity improvement of
# Z), each collapses to a per-row local operator
#     T[i, k, j] = A[Xc[i, k], Xc[i, j]]
# and a product is out[i, j] = sum_k Xv[i, k] T[i, k, j]: A's rows are
# looked up once per pattern, not once per product.


def _restrict_plan_rows(xc, A: DELL):
    nb = A.data.shape[0]
    alive = xc < PADCOL
    safe = torch.where(alive, torch.clamp(xc, max=nb - 1), 0).long()
    rows, K = xc.shape
    Ka = A.K
    gc = A.cols[safe].reshape(rows * K, Ka)           # sorted rows of A
    gv = A.data[safe].reshape(rows * K, Ka)
    q = xc[:, None, :].expand(rows, K, K).reshape(rows * K, K).contiguous()
    idx = torch.searchsorted(gc, q)
    idx = torch.clamp(idx, max=Ka - 1)
    hit = (torch.gather(gc, 1, idx) == q) & (q < PADCOL)
    T = torch.where(hit, torch.gather(gv, 1, idx), 0.0).reshape(rows, K, K)
    return torch.where(alive[:, :, None], T, 0.0)


def restrict_plan(Xc, A: DELL):
    """T ``[n, K, K]`` with T[i,k,j] = A[Xc[i,k], Xc[i,j]] (0 where either
    index is dead or the entry lies outside A's pattern), by a per-row
    binary search of A's sorted rows."""
    n, K = Xc.shape
    per_row = K * max(K, A.K)
    if n * per_row <= _RESTRICT_CHUNK_LIMIT:
        return _restrict_plan_rows(Xc, A)
    ch = max(_RESTRICT_CHUNK_LIMIT // max(per_row, 1), 1)
    return torch.cat([_restrict_plan_rows(Xc[s:s + ch], A)
                      for s in range(0, n, ch)], dim=0)


def apply_restrict_plan(T, Xv):
    """out[i, j] = sum_k Xv[i, k] T[i, k, j]: one restricted product."""
    return torch.bmm(Xv[:, None, :], T)[:, 0, :]


def restricted_product(Xc, Xv, A: DELL):
    """(X @ A) restricted to X's own pattern (device sibling of
    mat_mult_powers_share_sparsity, reference: src/Gmres_Poly.F90:
    777-920)."""
    return apply_restrict_plan(restrict_plan(Xc, A), Xv)


# ~~~~~~~~~~~~~~~~~~ fixed-sparsity polynomials ~~~~~~~~~~~~~~~~~~


def poly_dell(A: DELL, coeffs) -> DELL:
    """Assembled polynomial sum_k c_k A^k restricted onto A's pattern
    (sparsity order 1; A must carry a structural diagonal, see
    extract_dell(..., ensure_diag=True)).  The powers share one
    restriction plan.  ``coeffs``: a 1-D tensor of A's dtype and device."""
    n = A.data.shape[0]
    acc = coeffs[1] * A.data
    order = coeffs.shape[0] - 1
    if order >= 2:
        T = restrict_plan(A.cols, A)
        cur = A.data
        for k in range(2, order + 1):
            cur = apply_restrict_plan(T, cur)
            acc = acc + coeffs[k] * cur
    isd = A.cols == _ridx(n, A.device, A.cols.dtype)[:, None]
    acc = torch.where(isd, acc + coeffs[0], acc)
    acc = torch.where(A.cols < PADCOL, acc, 0.0)
    return DELL(acc, A.cols, A.n_cols)


def newton_poly_dell(A: DELL, wr, wi, tol_zero: float) -> DELL:
    """Assembled Newton-basis inverse restricted onto A's pattern (device
    sibling of src/Gmres_Poly_Newtonk.kokkos.cxx:15; real arithmetic for
    conjugate pairs).  ``wr``/``wi``: host arrays (the root schedule is
    resolved on the host)."""
    wr = np.asarray(wr, dtype=np.float64)
    wi = np.asarray(wi, dtype=np.float64)
    n = A.data.shape[0]
    isd = A.cols == _ridx(n, A.device, A.cols.dtype)[:, None]
    T = isd.to(A.dtype)
    M = torch.zeros_like(T)
    plan = []

    def restrict(X):
        # one plan for the whole recurrence, built on first use, so a
        # schedule of skipped roots never pays for it
        if not plan:
            plan.append(restrict_plan(A.cols, A))
        return apply_restrict_plan(plan[0], X)

    k = len(wr)
    i = 0
    while i <= k - 2:
        if wi[i] == 0.0:
            if abs(wr[i]) < tol_zero:
                i += 1
                continue
            M = M + T / wr[i]
            T = T - restrict(T) / wr[i]
            i += 1
        else:
            s = wr[i] ** 2 + wi[i] ** 2
            if s < tol_zero:
                i += 2
                continue
            T2 = 2.0 * wr[i] * T - restrict(T)
            M = M + T2 / s
            if i <= k - 3:
                T = T - restrict(T2) / s
            i += 2
    if k >= 1 and wi[k - 1] == 0.0 and abs(wr[k - 1]) > tol_zero:
        M = M + T / wr[k - 1]
    M = torch.where(A.cols < PADCOL, M, 0.0)
    return DELL(M, A.cols, A.n_cols)


def gather_at_pattern(pc, B: DELL):
    """Values of B at pattern columns ``pc`` (rows aligned; 0 where the
    entry lies outside B's pattern), by a per-row binary search of B's
    sorted rows (the analogue of remove_from_sparse_match's restriction
    gather, reference: src/PETSc_Helper.F90:490)."""
    q = pc.to(B.cols.dtype).contiguous()
    idx = torch.searchsorted(B.cols.contiguous(), q)
    idx = torch.clamp(idx, max=B.K - 1)
    hit = (torch.gather(B.cols, 1, idx) == q) & (q < PADCOL)
    return torch.where(hit, torch.gather(B.data, 1, idx), 0.0)


# ~~~~~~~~~~~~~~~~~~ offset census (DIA detection) ~~~~~~~~~~~~~~~~~~


def distinct_offsets_device(cols, cap: int = 16):
    """Distinct (col - row) offsets of a square padded pattern as a
    presence bitmap over the 2n-1 possible offsets, reduced blockwise:
    the bitmap reshapes to [CENSUS_ROWS, C] and a row sort gives each
    block's first cap+1 candidates.  Returns [CENSUS_ROWS, cap+1]
    ascending candidates padded with OFFBIG; the host finishes with
    np.unique.  Exact when the distinct count is at most ``cap`` (no
    block then holds more than cap+1); otherwise the count already
    exceeds cap."""
    n, _ = cols.shape
    ridx = _ridx(n, cols.device, torch.int64)
    live = cols < PADCOL
    offk = torch.where(live, cols.long() - ridx[:, None] + (n - 1), 2 * n)
    bitmap = torch.zeros(2 * n + 1, dtype=torch.int32, device=cols.device)
    bitmap.index_fill_(0, offk.reshape(-1), 1)
    bitmap = bitmap[: 2 * n]
    C = -((-2 * n) // CENSUS_ROWS)
    pad = CENSUS_ROWS * C - 2 * n
    if pad:
        bitmap = torch.cat([bitmap, bitmap.new_zeros(pad)])
    b2 = bitmap.reshape(CENSUS_ROWS, C)
    iota = torch.arange(C, dtype=torch.int64, device=cols.device)[None, :]
    base = (torch.arange(CENSUS_ROWS, dtype=torch.int64, device=cols.device)
            * C)[:, None]
    keys = torch.where(b2 > 0, base + iota - (n - 1), OFFBIG)
    out = torch.sort(keys, dim=1).values
    if C >= cap + 1:
        return out[:, : cap + 1]
    return torch.cat([out, torch.full((CENSUS_ROWS, cap + 1 - C), OFFBIG,
                                      dtype=out.dtype, device=out.device)],
                     dim=1)


# ~~~~~~~~~~~~~~~~~~ pattern transpose / union ~~~~~~~~~~~~~~~~~~


def transpose_pattern(A: DELL):
    """A^T's pattern as padded cols ``[n_cols, K_T]`` (the in-neighbour
    lists that symmetrise the strength graph, src/SAbs.F90).  One integer
    read back sizes K_T."""
    n_rows, K = A.cols.shape
    n_cols = A.n_cols
    dev = A.device
    rows = torch.arange(n_rows, dtype=torch.int64,
                        device=dev)[:, None].expand(n_rows, K).reshape(-1)
    cols = A.cols.reshape(-1).long()
    key, order = torch.sort(cols * n_rows + rows)
    col_s = cols[order]
    row_s = rows[order]
    live = col_s < PADCOL
    group_start = torch.searchsorted(col_s, col_s)
    slot = torch.arange(col_s.shape[0], dtype=torch.int64,
                        device=dev) - group_start
    K_T = max(int(torch.where(live, slot, -1).max()) + 1, 1) \
        if col_s.numel() else 1
    flat = torch.full((n_cols * K_T + 1,), PADCOL, dtype=torch.int32,
                      device=dev)
    target = torch.where(live, col_s * K_T + slot, n_cols * K_T)
    flat.scatter_(0, target, row_s.to(torch.int32))
    return flat[: n_cols * K_T].reshape(n_cols, K_T)


def union_patterns(cols_a, cols_b):
    """Per-row sorted union of two padded column sets at the combined
    width (dead = PADCOL); the caller compacts."""
    allc = torch.sort(torch.cat([cols_a, cols_b], dim=1), dim=1).values
    first = torch.ones_like(allc, dtype=torch.bool)
    first[:, 1:] = allc[:, 1:] != allc[:, :-1]
    return torch.where(first & (allc < PADCOL), allc, PADCOL)
