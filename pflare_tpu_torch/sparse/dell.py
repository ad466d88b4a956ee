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

The product ``DELL.matvec`` runs the gather kernel ``csrc/sell_spmv.cu``
on a CUDA tensor, over a packed copy of the DELL (``packed``, a
``sparse/ell.py::Sell``: rows sorted by length in slices, only the live
slots, pads (0, 0), so PADCOL never reaches the kernel), and on a CPU
tensor its plain version ``dell_spmv_plain`` (one gather and row sums,
the reference's product, pflare_tpu/sparse/dell.py:78-80).  The packing
index comes from the row lengths, built on the DELL's device and cached
on its ``cols`` tensor, so operators that share a pattern share one
index; ``pack_dells`` packs many DELLs with one host read.  A DELL made
with ``nonzero_slots`` (the device setup's masked A_ff and A_fc, which
keep all of A's slots and zero those outside their blocks) packs only
its nonzero entries, by an index of its own.  The device
setup packs its solve form before any CUDA graph captures it; a capture
never packs.
"""

from __future__ import annotations

import collections
from contextlib import nullcontext

import numpy as np
import scipy.sparse as sp
import torch

from .. import cuda
from ..utils.timers import span
from .dtypes import numpy_dtype
from .ell import (SORT_WINDOW, Fused, fused_product, pack, sell_indices,
                  sell_spmv_cuda)

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
# a recurrence on a restriction plan of more values (rows x K x K) than
# this runs chunk by chunk (by_chunks) and never holds the whole plan.  No
# memory rule: it lies above the largest plan of the 3072^2 FD benchmark
# (3.35e9 values), because cuBLAS's batched product over a chunk can round
# otherwise than over the whole batch, and a lower limit changes the last
# bits of such a set-up
_RESTRICT_PLAN_LIMIT = 1 << 32
PACKS = 0  # DELLs packed so far (a CUDA-graph capture packs none)
# the device set-up's passes over row chunks, by product: "spgemm" (each
# pass reads one integer back), "restrict" (restrict_plan) and "lair"
# (air/device_setup.py's local least-squares blocks); a product that fits
# its limit counts one pass
SETUP_CHUNKS = collections.Counter()


def chunk_passes(kind: str, passes: int):
    """Count ``passes`` passes of a ``kind`` product in ``SETUP_CHUNKS``;
    the context to run them in: a ``dell.chunks`` span (tagged ``kind``)
    where there is more than one, else nothing."""
    SETUP_CHUNKS[kind] += passes
    return span("dell.chunks", kind) if passes > 1 else nullcontext()


class DELL:
    """Padded device sparse matrix: ``data``/``cols`` ``[n, K]``, live
    columns sorted ascending per row, dead slots (0, PADCOL); ``n_cols``
    is the column count.  ``nonzero_slots``: the packed copy holds only
    the live slots whose value is not 0 (for a DELL that stores many
    zeros in live slots)."""

    def __init__(self, data, cols, n_cols: int,
                 nonzero_slots: bool = False):
        self.data = data
        self.cols = cols
        self.n_cols = int(n_cols)
        self.nonzero_slots = nonzero_slots
        self._safe = None
        self._packed = None

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

    @property
    def packed(self):
        """The packed copy the gather kernel reads (a ``Sell``): made at
        the first product on a CUDA device, or by ``pack`` on any device;
        None on the CPU until then."""
        if self._packed is None and self.data.is_cuda:
            pack_dells([self])
        return self._packed

    def pack(self, lanes: int | None = None):
        """Make the packed copy (on the DELL's device) with ``lanes``
        lanes a row (default: chosen from its nonzeros) and return it."""
        pack_dells([self], lanes)
        return self._packed

    def matvec(self, x):
        """y = A @ x: the gather kernel over the packed copy on a CUDA
        tensor, ``dell_spmv_plain`` on a CPU one.  A ``Fused`` operand:
        the product with its vector work (``ell.fused_product``)."""
        if isinstance(x, Fused):
            return fused_product(self.packed, x)
        if x.is_cuda:
            return sell_spmv_cuda(self.packed, x.contiguous())
        return dell_spmv_plain(self, x)

    def __matmul__(self, x):
        return self.matvec(x)

    def diagonal(self):
        n = self.data.shape[0]
        isd = self.cols == _ridx(n, self.device)[:, None]
        return torch.where(isd, self.data, 0.0).sum(dim=1)

    def row_counts(self):
        return (self.cols < PADCOL).sum(dim=1)

    def to(self, device) -> "DELL":
        return DELL(self.data.to(device), self.cols.to(device), self.n_cols,
                    self.nonzero_slots)

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


def dell_spmv_plain(M: DELL, x):
    """Plain PyTorch DELL product: one gather of x at the clamped columns
    (a dead slot multiplies a real entry by its 0) and row sums over all
    K slots.  The CPU's product, and the device setup's own products of
    operators that the solve form does not keep."""
    n, K = M.data.shape
    g = x.index_select(0, M.safe_cols().reshape(-1)).reshape(n, K)
    return (M.data * g).sum(dim=1)


def pack_dells(dells, lanes: int | None = None):
    """Give each DELL of ``dells`` without one its packed copy, on its own
    device, with ``lanes`` lanes a row where given (a sharded operator's
    device blocks take the whole operator's, so that each row sums in the
    same order).  The ``cols`` tensors not yet indexed get their packing
    indexes (``sparse/ell.py::sell_indices``: row lengths
    ``(cols < PADCOL).sum(1)``, width K, row stride K, slot stride 1,
    ``choose_lanes`` of the nonzeros) with one host read a device, which
    also checks that every row's live slots come before its dead ones
    (ValueError if not: the index packs a row's first slots).  The index
    is cached on ``cols``, so DELLs that share a cols tensor share it.  A
    ``nonzero_slots`` DELL gets an index of its own in the same read,
    over its live nonzero slots wherever they lie in the row.  Raises
    RuntimeError inside a CUDA-graph capture (the read would break it):
    pack before capturing."""
    global PACKS
    todo = {id(M): M for M in dells if M._packed is None}
    if not todo:
        return
    for dev in {M.data.device for M in todo.values() if M.data.is_cuda}:
        with cuda.guard(dev):     # the capture state of that card's stream
            capturing = torch.cuda.is_current_stream_capturing()
        if capturing:
            raise RuntimeError("a DELL cannot be packed inside a CUDA-graph "
                               "capture: pack it first (DELL.pack, "
                               "pack_dells)")
    # what needs an index, by device: a nonzero_slots DELL, or a cols
    # tensor not indexed yet
    by_device = {}
    for M in todo.values():
        if M.nonzero_slots:
            by_device.setdefault(M.cols.device, {})[id(M)] = M
        elif getattr(M.cols, "_sell_index", None) is None:
            by_device.setdefault(M.cols.device, {})[id(M.cols)] = M.cols
    own = {}
    for dev, items in by_device.items():
        specs, order_bad = [], []
        for item in items.values():
            if isinstance(item, DELL):
                # the live nonzero slots, in their order along the row
                keep = (item.cols < PADCOL) & (item.data != 0)
                K = keep.shape[1]
                slot_of = torch.sort((~keep).to(torch.int8), dim=1,
                                     stable=True).indices
                specs.append((keep.sum(dim=1), K, lanes, K, 1, SORT_WINDOW,
                              slot_of))
                continue
            live = item < PADCOL
            K = item.shape[1]
            specs.append((live.sum(dim=1), K, lanes, K, 1, SORT_WINDOW,
                          None))
            order_bad.append((live[:, 1:] & ~live[:, :-1]).any())
        with cuda.guard(dev):     # built, and read back, on that card
            indexes, bad = sell_indices(
                specs, torch.stack(order_bad) if order_bad else None)
        if any(bad):
            raise ValueError(
                f"pack_dells: {sum(bad)} of {len(bad)} DELL patterns have "
                "a dead slot (PADCOL) before a live one")
        for (key, item), index in zip(items.items(), indexes):
            if isinstance(item, DELL):
                own[key] = index
            else:
                item._sell_index = index
    for M in todo.values():
        M._packed = pack(M, index=own.get(id(M)) or M.cols._sell_index)
        PACKS += 1


class ShardedDELL(DELL):
    """A DELL row-sharded over a mesh (parallel/mesh.py): its rows, a
    multiple of the mesh's size, in equal blocks; ``label`` names it in
    the mesh's log."""

    def __init__(self, data, cols, n_cols: int, mesh, label: str = ""):
        super().__init__(data, cols, n_cols)
        self.mesh = mesh
        self.label = label


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
    ``new_K`` (a copy of the first ``new_K`` slots, or padding with dead
    slots).  A narrower result is a copy and not a view, so it does not
    keep the sorted full width alive: a SpGEMM chunk's candidates run to
    hundreds of times its kept width on 3-D AIR's coarse levels."""
    c, v = sort_rows(cols, vals)
    if new_K <= c.shape[1]:
        return c[:, :new_K].contiguous(), v[:, :new_K].contiguous()
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


def spgemm_drop_parts(a_data, a_cols, bc1, bd1, nb: int, tol: float,
                      relative: bool, lump: bool, diag_of_row):
    """drop(A @ B) of a block of A's rows against B's rows with their
    sentinel (``bc1``/``bd1``, ``nb`` live rows), in row chunks of at most
    ``_SPGEMM_CHUNK_LIMIT`` candidates: a list of (cols, vals), each chunk
    compacted to its own width (one integer read back a chunk)."""
    n = a_data.shape[0]
    per_row = max(a_data.shape[1] * bd1.shape[1], 1)
    ch = n if n * per_row <= _SPGEMM_CHUNK_LIMIT else max(
        _SPGEMM_CHUNK_LIMIT // per_row, 1)
    parts = []
    starts = range(0, n, ch)
    with chunk_passes("spgemm", len(starts)):
        for s in starts:
            c, v = _spgemm_drop_rows(a_data[s:s + ch], a_cols[s:s + ch],
                                     bc1, bd1, nb, float(tol), relative,
                                     lump, diag_of_row[s:s + ch])
            parts.append(compact(c, v, max(max_row_count(c), 1)))
    return parts


def stack_parts(parts):
    """Row blocks of (cols, vals) stacked at the widest one's width."""
    if len(parts) == 1:
        return parts[0]
    K_new = max(c.shape[1] for c, _ in parts)
    c = torch.cat([_pad_cols(c, K_new) for c, _ in parts], dim=0)
    v = torch.cat([torch.cat([v, v.new_zeros((v.shape[0],
                                               K_new - v.shape[1]))], dim=1)
                   for _, v in parts], dim=0)
    return c, v


def spgemm_drop_dell(A: DELL, B: DELL, tol: float, relative: bool,
                     lump: bool, diag_of_row=None) -> DELL:
    """Fused C = drop(A @ B), the device sibling of the native spgemm_drop
    and of the reference's product + drop chain.  One integer read back
    sizes the output (one a chunk for a product above
    ``_SPGEMM_CHUNK_LIMIT`` candidates, whose chunks are compacted as they
    come).  Without lumping the product runs over live candidates alone
    (``_spgemm_drop_live``: one more read, of the rows' candidate counts),
    with the padded product's result bit for bit.  ``diag_of_row``: the
    column that counts as each row's protected diagonal (default the row
    index; the coarse-rows-only RAP passes the global coarse positions).

    Row-sharded operands (``ShardedDELL`` on one mesh) take the
    neighbour-only halo product when the partition is banded
    (parallel/halo_spgemm.py), else the product over all of B, counted
    as an all-gather of B; the result is row-sharded like A."""
    n = A.data.shape[0]
    if diag_of_row is None:
        diag_of_row = _ridx(n, A.device, A.cols.dtype)
    parts = None
    if isinstance(A, ShardedDELL):
        from ..parallel.halo_spgemm import halo_mesh_for, spgemm_drop_halo

        mesh = halo_mesh_for(A, B)
        if mesh is not None:
            parts = spgemm_drop_halo(A, B, tol, relative, lump, mesh,
                                     diag_of_row)
        if parts is None:
            A.mesh.all_gather(B.data, A.label)
            A.mesh.all_gather(B.cols, A.label)
    if parts is None and not lump:
        c, v = _spgemm_drop_live(A, B, tol, relative, diag_of_row)
    else:
        if parts is None:
            bc1, bd1 = _sentinel_rows(B)
            parts = spgemm_drop_parts(A.data, A.cols, bc1, bd1,
                                      B.data.shape[0], tol, relative, lump,
                                      diag_of_row)
        c, v = stack_parts(parts)
    if isinstance(A, ShardedDELL):
        return ShardedDELL(v, c, B.n_cols, A.mesh, A.label)
    return DELL(v, c, B.n_cols)


def _expand_live(a_data, a_cols, bc1, bd1, blen1, width: int):
    """The live candidates of a block of A's rows against B's left-packed
    rows (``bc1``/``bd1`` with a dead sentinel row last, ``blen1`` their
    live lengths, 0 for the sentinel), ``width`` slots a row: slot p of row
    i holds entry j of B's row at A's slot k, in (k, j) order, as the
    padded expansion holds them less its dead slots; slots past the row's
    candidates are dead (PADCOL, 0)."""
    rows, Ka = a_cols.shape
    nb, Kb = bc1.shape[0] - 1, bc1.shape[1]
    alive = a_cols < PADCOL
    safe = torch.where(alive, torch.clamp(a_cols, max=nb - 1), nb).long()
    lens = blen1[safe]
    ends = torch.cumsum(lens, dim=1)
    p = torch.arange(width, device=a_cols.device).expand(rows, width)
    k = torch.searchsorted(ends, p.contiguous(), right=True)
    live = k < Ka
    k = torch.clamp(k, max=Ka - 1)
    j = p - (torch.gather(ends, 1, k) - torch.gather(lens, 1, k))
    flat = torch.gather(safe, 1, k) * Kb + torch.clamp(j, 0, Kb - 1)
    cols = torch.where(live, bc1.reshape(-1)[flat], PADCOL)
    vals = torch.where(live, torch.gather(a_data, 1, k)
                       * bd1.reshape(-1)[flat], 0.0)
    return cols, vals


def _spgemm_drop_live(A: DELL, B: DELL, tol: float, relative: bool,
                      diag_of_row):
    """drop(A @ B) without lumping over live candidates alone: A's rows
    sorted by their count of live candidates, most first, cut into chunks
    of at most ``_SPGEMM_CHUNK_LIMIT`` slots padded to the chunk's first
    (largest) count, each expanded by ``_expand_live``, merged, dropped
    and compacted as ``_spgemm_drop_rows`` does, the rows put back in
    their order at the end.  Each row's candidates come in the padded
    expansion's order, so its sums and drops are the padded product's,
    bit for bit; on 3-D AIR's coarse levels, whose rows are padded to the
    widest, the padded expansion sorts many times the live candidates.
    Reads the candidate counts back once, then one integer a chunk.
    (With lumping the dropped values' row sum runs over the padded width,
    so a lumped product keeps ``spgemm_drop_parts``.)"""
    n = A.data.shape[0]
    bc, bd = compact(B.cols, B.data, B.K)     # live slots first
    bc1, bd1 = _sentinel_rows(DELL(bd, bc, B.n_cols))
    blen1 = (bc1 < PADCOL).sum(dim=1)
    alive = A.cols < PADCOL
    safe = torch.where(alive, torch.clamp(A.cols, max=B.data.shape[0] - 1),
                       B.data.shape[0]).long()
    counts, order = torch.sort(blen1[safe].sum(dim=1), descending=True,
                               stable=True)
    counts = counts.cpu().tolist()
    chunks, s = [], 0
    while s < n:
        width = max(counts[s], 1)
        e = min(n, s + max(_SPGEMM_CHUNK_LIMIT // width, 1))
        chunks.append((s, e, width))
        s = e
    parts = []
    with chunk_passes("spgemm", len(chunks)):
        for s, e, width in chunks:
            rows = order[s:e]
            ccols, cvals = _expand_live(A.data[rows], A.cols[rows], bc1,
                                        bd1, blen1, width)
            ccols, cvals = segsum_rows(*sort_rows(ccols, cvals))
            c, v = drop_rows(ccols, cvals, float(tol), relative, False,
                             diag_of_row=diag_of_row[rows])
            del ccols, cvals
            parts.append(compact(c, v, max(max_row_count(c), 1)))
    if not parts:
        return (torch.full((0, 1), PADCOL, dtype=A.cols.dtype,
                           device=A.device), A.data.new_zeros((0, 1)))
    c, v = stack_parts(parts)
    back = torch.empty_like(order)
    back[order] = torch.arange(n, device=order.device)
    return c[back], v[back]


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
    extraction only shrinks rows) and reads nothing back.  A row-sharded
    A takes the neighbour-only halo extraction when the partition is
    banded (parallel/halo_spgemm.py::extract_halo), else gathers over all
    of A, counted as an all-gather."""
    out = None
    if isinstance(A, ShardedDELL):
        from ..parallel.halo_spgemm import extract_halo

        out = extract_halo(A, row_idx, col_mask, col_newidx,
                           bool(ensure_diag), A.mesh)
        if out is None:
            A.mesh.all_gather(A.data, A.label)
            A.mesh.all_gather(A.cols, A.label)
    if out is None:
        out = _extract_rows(A, row_idx, col_mask, col_newidx, ensure_diag)
    ncols, nvals = out
    K_new = (max(max_row_count(ncols), 1) if compact_width
             else ncols.shape[1])
    c, v = compact(ncols, nvals, K_new)
    return DELL(v, c, n_cols_new)


def _extract_rows(A: DELL, row_idx, col_mask, col_newidx, ensure_diag):
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
    return ncols, nvals


# ~~~~~~~~~~ restriction plan: products onto one fixed pattern ~~~~~~~~~~
#
# When products restrict onto the pattern Xc (the polynomial power
# recurrence, the Newton basis steps, the fixed-sparsity improvement of
# Z), each collapses to a per-row local operator
#     T[i, k, j] = A[Xc[i, k], Xc[i, j]]
# and a product is out[i, j] = sum_k Xv[i, k] T[i, k, j]: A's rows are
# looked up once per pattern, not once per product.  Every such
# recurrence is row by row, so past ``_RESTRICT_PLAN_LIMIT`` it runs over
# row chunks (``plan_chunks``), each chunk's plan built once and dropped
# after its rows' last product: a whole plan holds rows x K^2 values,
# which on 3-D AIR's coarse levels (K in the hundreds) is many times the
# level's own matrices.


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


def plan_chunks(Xc, A: DELL):
    """The restriction plan of ``Xc`` against ``A`` in row chunks: yields
    (first row, last row + 1, T of those rows), each chunk's T built as it
    comes, at most ``_RESTRICT_CHUNK_LIMIT`` values of T and of its
    lookups (rows x K x max(K, Ka)) a chunk."""
    n, K = Xc.shape
    per_row = max(K * max(K, A.K), 1)
    ch = max(n if n * per_row <= _RESTRICT_CHUNK_LIMIT
             else _RESTRICT_CHUNK_LIMIT // per_row, 1)
    starts = range(0, n, ch)
    with chunk_passes("restrict", len(starts)):
        for s in starts:
            yield s, min(s + ch, n), _restrict_plan_rows(Xc[s:s + ch], A)


def restrict_plan(Xc, A: DELL):
    """T ``[n, K, K]`` with T[i,k,j] = A[Xc[i,k], Xc[i,j]] (0 where either
    index is dead or the entry lies outside A's pattern), by a per-row
    binary search of A's sorted rows, built chunk by chunk into one
    tensor."""
    n, K = Xc.shape
    T = None
    for s, e, part in plan_chunks(Xc, A):
        if s == 0 and e == n:
            return part
        if T is None:
            T = part.new_empty((n, K, K))
        T[s:e] = part
    return T if T is not None else A.data.new_zeros((0, K, K))


def by_chunks(Xc, A: DELL, step):
    """``step(rows, T)``: a row-by-row recurrence on the restriction plan
    T of ``Xc`` against ``A``.  On the whole plan (``rows`` all rows)
    where it holds at most ``_RESTRICT_PLAN_LIMIT`` values, else over
    ``plan_chunks`` (``rows`` a chunk's slice) with one chunk's plan held
    at a time and the row blocks concatenated."""
    n, K = Xc.shape
    if n * K * K <= _RESTRICT_PLAN_LIMIT:
        return step(slice(None), restrict_plan(Xc, A))
    return torch.cat([step(slice(s, e), T)
                      for s, e, T in plan_chunks(Xc, A)], dim=0)


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
    restriction plan (``by_chunks``).  ``coeffs``: a 1-D tensor of A's
    dtype and device."""
    n = A.data.shape[0]
    acc = coeffs[1] * A.data
    order = coeffs.shape[0] - 1
    if order >= 2:
        def powers(rows, T):
            cur, out = A.data[rows], acc[rows]
            for k in range(2, order + 1):
                cur = apply_restrict_plan(T, cur)
                out = out + coeffs[k] * cur
            return out

        acc = by_chunks(A.cols, A, powers)
    isd = A.cols == _ridx(n, A.device, A.cols.dtype)[:, None]
    acc = torch.where(isd, acc + coeffs[0], acc)
    acc = torch.where(A.cols < PADCOL, acc, 0.0)
    return DELL(acc, A.cols, A.n_cols)


def newton_poly_dell(A: DELL, wr, wi, tol_zero: float) -> DELL:
    """Assembled Newton-basis inverse restricted onto A's pattern (device
    sibling of src/Gmres_Poly_Newtonk.kokkos.cxx:15; real arithmetic for
    conjugate pairs).  ``wr``/``wi``: host arrays (the root schedule is
    resolved on the host).  The recurrence is row by row, so its
    restricted products share one restriction plan (``by_chunks``)."""
    wr = np.asarray(wr, dtype=np.float64)
    wi = np.asarray(wi, dtype=np.float64)
    n = A.data.shape[0]
    isd = A.cols == _ridx(n, A.device, A.cols.dtype)[:, None]
    # the schedule: (root, None) for a real root, (wr, |w|^2, whether the
    # pair updates T) for a conjugate pair; roots near zero are skipped
    k = len(wr)
    steps = []
    i = 0
    while i <= k - 2:
        if wi[i] == 0.0:
            if abs(wr[i]) >= tol_zero:
                steps.append((wr[i], None, False))
            i += 1
        else:
            s = wr[i] ** 2 + wi[i] ** 2
            if s >= tol_zero:
                steps.append((wr[i], s, i <= k - 3))
            i += 2
    last = (wr[k - 1] if k >= 1 and wi[k - 1] == 0.0
            and abs(wr[k - 1]) > tol_zero else None)

    def recurrence(rows, plan):
        T = isd[rows].to(A.dtype)
        M = torch.zeros_like(T)
        for w, s, update in steps:
            if s is None:
                M = M + T / w
                T = T - apply_restrict_plan(plan, T) / w
            else:
                T2 = 2.0 * w * T - apply_restrict_plan(plan, T)
                M = M + T2 / s
                if update:
                    T = T - apply_restrict_plan(plan, T2) / s
        return M if last is None else M + T / last

    # a schedule of skipped roots never pays for the plan
    M = (by_chunks(A.cols, A, recurrence) if steps
         else recurrence(slice(None), None))
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
