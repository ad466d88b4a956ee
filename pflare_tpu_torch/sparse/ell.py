"""Padded-ELL sparse matrices and the sliced gather SpMV.

``ELL`` keeps values and columns as ``[n_rows, K]``; ``TELL`` as
``[K, n_rows]``, the layout of the solve-phase operators that are neither
DIA nor banded: slot k of every row is one contiguous row of the tensor.
Padded slots hold value 0 and column 0, so they add nothing.  The
reference computes both products with XLA, not Pallas
(pflare_tpu/sparse/ell.py:98-101, 217-223).

On a CUDA device each container also carries a packed copy of itself
(``Sell``, ``pack``): its rows sorted stably by length, longest first,
cut into slices of 32 / L rows (L lanes a row, ``choose_lanes``), each
slice padded only to its own longest row and stored step-major, so that a
warp reads 32 neighbouring slots at every step.  The packing index
(``SellIndex``: slice offsets, the original row of each packed row, and
each packed slot's flat position in the container's own storage) is built
from the row lengths with torch ops on the device, with one host read of
its sizes (``sell_indices``), once per pattern and storage layout
(``sell_index``, cached on the ``SparsityPattern``), and makes the packed
copy with one gather; the container's own tensors stay as they are.
``TELL.matvec`` and ``ELL.matvec`` launch the hand-written kernel
``csrc/sell_spmv.cu`` on a CUDA tensor, and on a CPU tensor run their
plain versions (``tell_spmv_plain``, the slot loop; ELL's gather and row
sum).

A ``Fused`` operand asks the same launch to do the V-cycle's vector work
around the product (air/smooth.py): an epilogue on each row's sum
(``u - A x``, ``m u - A x``, ``u + A x``), or a product through a copy
of the packed copy with its output rows or input columns renumbered
(the V-cycle's R writing, and P reading, the coarse vector).  Each such
launch counts once in ``KERNEL_LAUNCHES`` and once, by kind, in
``EPILOGUE_LAUNCHES``.

The device setup's ``DELL`` (``sparse/dell.py``), an ``[n, K]`` layout
with dead slots (0, PADCOL) after the live ones, packs by the same
index and runs the same kernel.  ``sell_spmv_plain`` walks the packed
layout in the kernel's order and is what the card holds the kernel to,
bit for bit.
"""

from __future__ import annotations

import collections
import sys

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from .. import cuda
from ..utils import graphs
from .pattern import SparsityPattern
from .dtypes import numpy_dtype
from .spgemm import segment_sum

KERNEL_LAUNCHES = 0  # launches of csrc/sell_spmv.cu since the last reset
# the same launches by card index (a mesh's shards launch on their own)
LAUNCHES_BY_DEVICE = collections.Counter()
graphs.count_launches(sys.modules[__name__], "sell_spmv_kernel")
# the kernel's epilogues, numbered as csrc/sell_spmv.cu's ``Epilogue``
EPILOGUES = {"plain": 0, "residual": 1, "masked": 2, "correction": 3}
MAPS = ("coarse_out", "coarse_in")
# launches that carried an epilogue or ran through a renumbered copy, by
# kind (each also counts in KERNEL_LAUNCHES); a replay adds what its
# capture counted
EPILOGUE_LAUNCHES = collections.Counter()
graphs.count_kinds(EPILOGUE_LAUNCHES)
# the packed slots (pads included) that the kernel's launches read, by the
# launch's lanes a row; a replay adds what its capture counted
SLOTS_BY_LANES = collections.Counter()
graphs.count_kinds(SLOTS_BY_LANES)
WARP = 32            # threads of a warp: one slice a warp
BLOCK_THREADS = 256  # csrc/sell_spmv.cu's kThreads: eight slices a block
LANES = (1, 2, 4, 8, 16, 32)
# choose_lanes: a row takes more lanes while each lane keeps this many
# slots of a mean row, or, keeping one, while the operator makes fewer
# warps than half of what an H100 holds at once (132 SMs x 64 warps / 2)
SLOTS_PER_LANE = 8
MIN_WARPS = 4224
# rows are sorted by length within runs of this many rows (SELL-C-sigma's
# sigma): a warp's rows stay near each other, so its gathers of x and
# writes of y share sectors (tools/torch_sell_lanes.py, PERF.md)
SORT_WINDOW = 512


def tell_spmv_plain(data, cols, x):
    """Plain PyTorch TELL product: one gather, one multiply and one add a
    slot, summed in slot order (the reference's XLA loop,
    pflare_tpu/sparse/ell.py:217-223)."""
    y = None
    for k in range(data.shape[0]):
        term = data[k] * x.index_select(0, cols[k])
        y = term if y is None else y + term
    if y is None:
        return x.new_zeros(data.shape[1])
    return y


def choose_lanes(nnz: int, n_rows: int) -> int:
    """Lanes a row for an operator of ``nnz`` nonzeros in ``n_rows`` rows:
    the most, up to 32, that leave each lane ``SLOTS_PER_LANE`` slots of a
    mean row, then doubled, while each lane keeps a slot of a mean row,
    as long as the operator makes fewer than ``MIN_WARPS`` warps (one a
    slice of 32 / L rows), so that few rows still have enough gathers in
    flight.  The large R, A_ff and A_fc take one lane, the coarse
    inverse's long rows 8-16."""
    mean = nnz / max(n_rows, 1)
    lanes = 1
    while lanes < LANES[-1] and (
            2 * lanes * SLOTS_PER_LANE <= mean
            or (2 * lanes <= mean and n_rows * lanes < MIN_WARPS * WARP)):
        lanes *= 2
    return lanes


class SellIndex:
    """The packing index of one pattern in one storage layout, on one
    device: ``slice_ptr`` [n_slices + 1] int64, the offsets of the slices
    in the packed arrays (multiples of 32); ``row_of`` [n_slices * 32 / L]
    int32, the original row of each packed row (-1 past the last row);
    ``steps`` [n_slices] int64, each slice's 32-slot steps; ``src`` [P],
    each packed slot's flat position in the container's storage, -1 for a
    pad (int32 where every position fits, else int64).  Within slice s,
    packed slot ``slice_ptr[s] + 32 t + l (32 / L) + r`` is slot ``t L +
    l`` of packed row ``s (32 / L) + r``.  The rows are sorted by length,
    longest first and stably, within each run of ``window`` rows (a
    multiple of 32), or over all n rows for ``None`` (SELL-C-sigma's
    sigma; tools/torch_sell_lanes.py times both).  A row of length m
    packs its slots 0 .. m - 1, so its entries must come before its
    padding, unless a slot map names the storage slot of each entry.

    Built by ``sell_indices`` with torch ops on the device of the row
    lengths, with one read of the packed sizes: the same index built by
    numpy on the host of an H100 machine took about 12 s for the 2048^2
    hierarchy's 122M nonzeros (PERF.md)."""

    def __init__(self, slice_ptr, row_of, steps, src, lanes: int,
                 max_steps: int):
        self.slice_ptr = slice_ptr
        self.row_of = row_of
        self.steps = steps
        self.src = src
        self.lanes = lanes
        self.max_steps = max_steps

    @property
    def n_slices(self) -> int:
        return self.steps.shape[0]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.slice_ptr, self.row_of, self.steps, self.src))


class _SellPlan:
    """The first half of a ``SellIndex``, device work alone: the rows'
    order and, for each candidate lane count (``lanes``, or each of
    ``LANES`` for None), each slice's steps.  ``sizes`` holds what the
    host reads before the second half: the nonzeros, then the total and
    the largest steps of each candidate."""

    def __init__(self, row_len, width: int, lanes: int | None,
                 window: int | None):
        dev = row_len.device
        n = row_len.shape[0]
        if window is None:
            run = torch.zeros(n, dtype=torch.int64, device=dev)
        else:
            if window <= 0 or window % WARP:
                raise ValueError(f"sort window {window}: a positive "
                                 f"multiple of {WARP}")
            run = torch.div(torch.arange(n, device=dev), window,
                            rounding_mode="floor")
        self.order = torch.sort(run * (width + 1) + (width - row_len),
                                stable=True).indices
        self.lens = row_len[self.order]
        self.n = n
        self.lanes = LANES if lanes is None else (lanes,)
        self.steps = {}
        zero = row_len.new_zeros(())
        sizes = [row_len.sum()]
        for L in self.lanes:
            rows_per = WARP // L
            lens = F.pad(self.lens, (0, -(-n // rows_per) * rows_per - n))
            # the first row of a slice is its longest
            steps = torch.div(lens[::rows_per] + L - 1, L,
                              rounding_mode="floor")
            self.steps[L] = steps
            sizes += ([steps.sum(), steps.max()] if steps.numel()
                      else [zero, zero])
        self.sizes = torch.stack(sizes)

    def index(self, sizes, row_stride: int, slot_stride: int,
              width: int, slot_of=None) -> SellIndex:
        """The index, from ``sizes`` as the host read them: its lanes
        (the one candidate, or ``choose_lanes`` of the nonzeros), the
        slices' offsets and each packed slot's source.  ``slot_of``
        ([n, width] int64, optional): the storage slot of each row's
        j-th entry, where the entries are not the row's first slots."""
        n = self.n
        lanes = (self.lanes[0] if len(self.lanes) == 1
                 else choose_lanes(int(sizes[0]), n))
        at = 1 + 2 * self.lanes.index(lanes)
        blocks, max_steps = int(sizes[at]), int(sizes[at + 1])
        dev = self.order.device
        rows_per = WARP // lanes
        steps = self.steps[lanes]
        n_slices = steps.shape[0]
        pad = n_slices * rows_per - n
        rows = F.pad(self.order, (0, pad), value=-1)
        lens = F.pad(self.lens, (0, pad))
        slice_ptr = F.pad(torch.cumsum(steps * WARP, 0), (1, 0))
        slice_of = torch.repeat_interleave(
            torch.arange(n_slices, device=dev), steps, output_size=blocks)
        step = torch.arange(blocks, device=dev) - torch.repeat_interleave(
            torch.div(slice_ptr[:-1], WARP, rounding_mode="floor"), steps,
            output_size=blocks)
        lane = torch.arange(WARP, device=dev)
        sub = lane % rows_per
        row = rows.view(n_slices, rows_per)[slice_of][:, sub]
        slot = step[:, None] * lanes + torch.div(lane, rows_per,
                                                 rounding_mode="floor")
        keep = slot < lens.view(n_slices, rows_per)[slice_of][:, sub]
        if slot_of is not None:
            slot = slot_of[row.clamp(min=0),
                           slot.clamp(max=max(slot_of.shape[1] - 1, 0))]
        src = torch.where(keep, row * row_stride + slot * slot_stride,
                          -1).reshape(-1)
        last = (n - 1) * row_stride + (width - 1) * slot_stride
        return SellIndex(slice_ptr, rows.to(torch.int32), steps,
                         src.to(torch.int32) if last < 2**31 else src,
                         lanes, max_steps)


def sell_indices(specs, check=None):
    """The packing indexes of several patterns with one host read for all
    of them: ``specs`` a list of (row lengths [n] int64, width, lanes or
    None, row stride, slot stride, window, slot map or None: see
    ``_SellPlan.index``), every row no longer than its width, all on one
    device; ``check`` an optional integer tensor there, read in the same
    copy.  Returns (the ``SellIndex`` of each spec, ``check``'s values as
    a list)."""
    plans = [_SellPlan(row_len, width, lanes, window)
             for row_len, width, lanes, _, _, window, _ in specs]
    parts = [p.sizes for p in plans]
    if check is not None:
        parts.append(check.reshape(-1).to(torch.int64))
    got = torch.cat(parts).tolist() if parts else []
    out, at = [], 0
    for plan, (_, width, _, row_stride, slot_stride, _, slot_of) in zip(
            plans, specs):
        k = plan.sizes.numel()
        out.append(plan.index(got[at:at + k], row_stride, slot_stride,
                              width, slot_of))
        at += k
    return out, got[at:]


def sell_index(M, lanes: int | None = None, device=None,
               window: int | None = SORT_WINDOW) -> SellIndex:
    """The packing index of container ``M`` (a TELL or ELL) with ``lanes``
    lanes a row (``choose_lanes`` by default), on ``device`` (its values'
    by default), cached on its pattern by storage layout, lanes, device
    and window: one build for each."""
    pat = M.pattern
    if lanes is None:
        lanes = choose_lanes(pat.nnz, pat.shape[0])
    if lanes not in LANES:
        raise ValueError(f"lanes {lanes}: one of {LANES}")
    device = torch.device(M.data.device if device is None else device)
    if isinstance(M, TELL):
        k_store, n_store = M.data.shape
        strides = (1, n_store)
    else:
        n_store, k_store = M.data.shape
        strides = (k_store, 1)
    key = (type(M).__name__, tuple(M.data.shape), lanes, str(device),
           window)
    index = pat._packs.get(key)
    if index is None:
        row_len = np.diff(pat.indptr)
        if n_store != pat.shape[0] or row_len.max(initial=0) > k_store:
            raise ValueError(f"{type(M).__name__} storage "
                             f"{tuple(M.data.shape)} does not hold its "
                             f"pattern ({pat.shape[0]} rows, K={pat.K})")
        with cuda.guard(device):  # built, and read back, on that card
            (index,), _ = sell_indices([(
                torch.as_tensor(row_len, device=device), k_store, lanes,
                *strides, window, None)])
        pat._packs[key] = index
    return index


class Sell:
    """The packed copy of a TELL, ELL or DELL on one device: ``data`` [P]
    values and ``cols`` [P] int32 columns in ``index``'s order (0 and 0
    in pads), with the index's ``slice_ptr``, ``row_of`` and ``steps``;
    ``shape`` is its product's.  ``row_of`` given: the rows of y that
    the packed rows write, in place of the index's (-1: none)."""

    def __init__(self, index: SellIndex, data, cols, shape, row_of=None):
        self.index = index
        self.data = data
        self.cols = cols
        self.shape = shape
        self.slice_ptr, self.steps = index.slice_ptr, index.steps
        self.row_of = index.row_of if row_of is None else row_of

    @property
    def lanes(self) -> int:
        return self.index.lanes

    @property
    def nbytes(self) -> int:
        """Bytes of the packed values and columns."""
        return (self.data.numel() * self.data.element_size()
                + self.cols.numel() * self.cols.element_size())


def pack(M, lanes: int | None = None, index: SellIndex | None = None) -> Sell:
    """The packed copy of container ``M`` on its own device, by ``index``
    (``sell_index(M, lanes)`` by default; a DELL passes its own): one
    gather of its values and one of its columns, pads set to 0."""
    index = index or sell_index(M, lanes)
    src = index.src
    if src.device != M.data.device:
        raise ValueError(f"pack: the index lies on {src.device}, the "
                         f"values on {M.data.device}")
    keep, at = src >= 0, src.clamp(min=0)
    data = torch.where(keep, M.data.reshape(-1).index_select(0, at), 0)
    cols = torch.where(keep, M.cols.reshape(-1).index_select(0, at), 0)
    return Sell(index, data, cols, M.shape)


def sell_spmv_plain(packed: Sell, x, epilogue: str = "plain", u=None,
                    m=None):
    """Plain PyTorch product over the packed layout, in the kernel's
    order: each of a slice's 32 threads sums its slots in slot order from
    0 (one gather, multiply and add a step, kept only in the slices that
    still have that step), then the lanes of each row combine by the
    kernel's shuffle tree, and each row's sum goes to its original row;
    then the ``epilogue`` (see ``EPILOGUES``) as PyTorch's elementwise
    ops."""
    y = _sell_sum_plain(packed, x)
    if epilogue == "residual":
        return u - y
    if epilogue == "masked":
        return m * u - y
    if epilogue == "correction":
        return u + y
    if epilogue != "plain":
        raise ValueError(f"epilogue {epilogue!r}: one of {list(EPILOGUES)}")
    return y


def _sell_sum_plain(packed: Sell, x):
    index = packed.index
    rows_per = WARP // index.lanes
    acc = x.new_zeros(index.n_slices, WARP)
    lane = torch.arange(WARP, device=x.device)
    last = max(packed.data.shape[0] - 1, 0)
    for t in range(index.max_steps):
        p = (packed.slice_ptr[:-1, None] + t * WARP + lane).clamp(max=last)
        term = packed.data[p] * x.index_select(
            0, packed.cols[p].reshape(-1)).reshape(p.shape)
        acc = torch.where(packed.steps[:, None] > t, acc + term, acc)
    off = WARP // 2
    while off >= rows_per:
        acc[:, :off] = acc[:, :off] + acc[:, off:2 * off]
        off //= 2
    n = packed.shape[0]
    out_rows = torch.where(packed.row_of >= 0, packed.row_of,
                           n).to(torch.int64)
    y = x.new_zeros(n + 1)
    y.index_copy_(0, out_rows, acc[:, :rows_per].reshape(-1))
    return y[:n]


def sell_spmv_cuda(packed: Sell, x, epilogue: str = "plain", u=None,
                   m=None, kind: str | None = None):
    """Launch ``csrc/sell_spmv.cu`` on PyTorch's current stream (no
    synchronisation): ``packed`` a ``Sell`` of float32/float64 values on a
    CUDA device, ``x`` a contiguous vector of the same dtype there, every
    column inside x; with an ``epilogue`` (``EPILOGUES``), its vectors
    ``u`` (and ``m`` for "masked"), contiguous, one entry a row of y.
    A launch counts as ``count_launch`` says."""
    if packed is None:
        raise ValueError("sell_spmv_cuda: the container has no packed copy "
                         "(its values are not on a CUDA device)")
    data, cols = packed.data, packed.cols
    if not (data.is_cuda and cols.device == data.device
            and x.device == data.device):
        raise ValueError("sell_spmv_cuda: tensors must be on one CUDA "
                         "device")
    if data.dtype not in (torch.float32, torch.float64) or x.dtype != data.dtype:
        raise ValueError(f"sell_spmv_cuda: dtypes {data.dtype}/{x.dtype}; "
                         "need float32 or float64, equal")
    if (cols.dtype != torch.int32 or cols.shape != data.shape
            or not (data.is_contiguous() and cols.is_contiguous())):
        raise ValueError("sell_spmv_cuda: values and int32 columns must be "
                         "contiguous, one column a value")
    if not (x.is_contiguous() and x.dim() == 1
            and x.shape[0] == packed.shape[1]):
        raise ValueError(f"sell_spmv_cuda: x must be a contiguous vector of "
                         f"{packed.shape[1]} entries")
    if epilogue not in EPILOGUES:
        raise ValueError(f"sell_spmv_cuda: epilogue {epilogue!r}, one of "
                         f"{list(EPILOGUES)}")
    reads = {"plain": (), "masked": (u, m)}.get(epilogue, (u,))
    for v in reads:
        if not (isinstance(v, torch.Tensor) and v.device == data.device
                and v.dtype == data.dtype and v.dim() == 1
                and v.is_contiguous() and v.shape[0] == packed.shape[0]):
            raise ValueError(f"sell_spmv_cuda: the {epilogue} epilogue's "
                             f"vectors must be contiguous {data.dtype} "
                             f"vectors of {packed.shape[0]} entries on "
                             f"{data.device}")
    y = torch.empty(packed.shape[0], dtype=data.dtype, device=data.device)
    n_slices = packed.index.n_slices
    if n_slices == 0:
        return y
    u_ptr, m_ptr = [v.data_ptr() for v in reads] + [None] * (2 - len(reads))
    cuda.launch("sell_spmv", data.dtype, data.device, data.data_ptr(),
                cols.data_ptr(), packed.slice_ptr.data_ptr(),
                packed.row_of.data_ptr(), x.data_ptr(), y.data_ptr(),
                u_ptr, m_ptr, n_slices, packed.lanes, EPILOGUES[epilogue])
    count_launch(packed, kind or (None if epilogue == "plain" else epilogue))
    return y


def count_launch(packed: Sell, kind: str | None = None):
    """Count one launch of the kernel over ``packed``: one in
    ``KERNEL_LAUNCHES`` and under its card in ``LAUNCHES_BY_DEVICE``, one
    under ``kind`` (an epilogue or a map; None for a plain product) in
    ``EPILOGUE_LAUNCHES``, and its packed slots under its lanes in
    ``SLOTS_BY_LANES``."""
    global KERNEL_LAUNCHES
    KERNEL_LAUNCHES += 1
    LAUNCHES_BY_DEVICE[packed.data.device.index] += 1
    if kind is not None:
        EPILOGUE_LAUNCHES[kind] += 1
    SLOTS_BY_LANES[packed.lanes] += packed.data.shape[0]


class Fused:
    """The operand of a gather product ``A.matvec(Fused(...))`` that does
    the vector work around it in the same launch (one positional
    argument, as any product takes, so a wrapper of ``matvec`` counts it
    like any other).  ``kind``:

    * "residual": u - A x;  "masked": m * u - A x;  "correction": u + A x
      (``EPILOGUES``, one entry of u and m a row of A);
    * "coarse_out", "coarse_in" (``MAPS``): the plain product through
      ``packed``, a copy of A's packed copy over the same index and
      values with its output rows (``row_of``) or its input columns
      renumbered; the V-cycle's R writes, and its P reads, the coarse
      vector so (air/fullspace.py::coarse_maps).

    ``x`` is the vector the product reads."""

    def __init__(self, kind: str, x, u=None, m=None, packed=None):
        if kind == "plain" or kind not in (*EPILOGUES, *MAPS):
            raise ValueError(f"Fused: kind {kind!r}")
        if (kind in MAPS) != (packed is not None):
            raise ValueError(f"Fused: kind {kind!r} "
                             + ("needs" if kind in MAPS else "takes no")
                             + " renumbered packed copy")
        self.kind = kind
        self.x = x
        self.u = u
        self.m = m
        self.packed = packed


def fused_product(packed: Sell, op: Fused):
    """The product a ``Fused`` operand asks of the operator whose packed
    copy is ``packed``: the kernel on a CUDA device, ``sell_spmv_plain``
    (the kernel's order) elsewhere."""
    if packed is None:
        raise ValueError("a Fused product needs the operator's packed copy")
    epilogue, u, m = op.kind, op.u, op.m
    if op.kind in MAPS:
        if op.packed.index is not packed.index or op.packed.data is not (
                packed.data):
            raise ValueError(f"{op.kind}: not a renumbered copy of the "
                             "operator's packed copy")
        packed, epilogue, u, m = op.packed, "plain", None, None
    if packed.data.is_cuda:
        cont = lambda v: None if v is None else v.contiguous()
        return sell_spmv_cuda(packed, op.x.contiguous(), epilogue, cont(u),
                              cont(m), kind=op.kind)
    return sell_spmv_plain(packed, op.x, epilogue, u, m)


def _packed(M):
    """The packed copy a container carries: made where its values lie on
    a CUDA device, none on the CPU (which runs the plain products)."""
    return pack(M) if M.data.is_cuda else None


class ELL:
    """Sparse matrix: static pattern + ``[n_rows, K]`` value and int32
    column tensors (and, on a CUDA device, their packed copy
    ``packed``)."""

    def __init__(self, pattern: SparsityPattern, data, cols):
        self.pattern = pattern
        self.data = data
        self.cols = cols
        self.packed = _packed(self)

    @property
    def shape(self):
        return self.pattern.shape

    @property
    def nnz(self):
        return self.pattern.nnz

    @property
    def dtype(self):
        return self.data.dtype

    @staticmethod
    def from_scipy(mat, dtype=None) -> "ELL":
        """From a scipy matrix; ``dtype`` (torch) defaults to the matrix's."""
        csr = sp.csr_matrix(mat)
        csr.sort_indices()
        pattern = SparsityPattern(csr.indptr, csr.indices, csr.shape)
        ndt = numpy_dtype(dtype, csr.data.dtype)
        flat = np.zeros(pattern.shape[0] * pattern.K, dtype=ndt)
        flat[pattern.slot_of_pos] = csr.data.astype(ndt)
        data = torch.from_numpy(flat.reshape(pattern.shape[0], pattern.K))
        return ELL(pattern, data, torch.from_numpy(pattern.ell_cols))

    @staticmethod
    def from_flat(pattern: SparsityPattern, flat_csr_data) -> "ELL":
        """From values in CSR entry order ``[nnz]`` (a tensor), on their
        device."""
        n, K = pattern.shape[0], pattern.K
        dev = flat_csr_data.device
        dense = flat_csr_data.new_zeros(n * K)
        dense[torch.as_tensor(pattern.slot_of_pos, device=dev)] = \
            flat_csr_data
        return ELL(pattern, dense.reshape(n, K),
                   torch.as_tensor(pattern.ell_cols, device=dev))

    def flat_values(self):
        """The values in CSR entry order ``[nnz]``."""
        return self.data.reshape(-1)[torch.as_tensor(
            self.pattern.slot_of_pos, device=self.data.device)]

    def with_data(self, data) -> "ELL":
        return ELL(self.pattern, data, self.cols)

    def to(self, device) -> "ELL":
        return ELL(self.pattern, self.data.to(device), self.cols.to(device))

    def to_scipy(self) -> sp.csr_matrix:
        """The matrix, from storage of any width >= the pattern's K (a
        stacked shard block keeps its operator's)."""
        flat = self.data.cpu().numpy().reshape(-1)
        sop, K = self.pattern.slot_of_pos, self.pattern.K
        return sp.csr_matrix(
            (flat[sop // K * self.data.shape[1] + sop % K],
             self.pattern.indices.astype(np.int64), self.pattern.indptr),
            shape=self.pattern.shape)

    def matvec(self, x):
        """y = A @ x: the kernel on a CUDA tensor; on a CPU one, one gather
        and row sums.  A ``Fused`` operand: the product with its vector
        work (``fused_product``)."""
        if isinstance(x, Fused):
            return fused_product(self.packed, x)
        if x.is_cuda:
            return sell_spmv_cuda(self.packed, x.contiguous())
        n, K = self.data.shape
        gathered = x.index_select(0, self.cols.reshape(-1)).reshape(n, K)
        return (self.data * gathered).sum(dim=1)

    def matvec_t(self, x):
        """y = A.T @ x: each column's terms summed in row order
        (``segment_sum``), so a card gives the CPU's bits; an
        ``index_add_`` there would add them atomically, in no fixed
        order."""
        pat = self.pattern
        by_col = np.argsort(pat.indices, kind="stable")
        slots = torch.as_tensor(pat.slot_of_pos[by_col], device=x.device)
        terms = (self.data.reshape(-1)[slots]
                 * x.index_select(0, torch.div(slots, pat.K,
                                               rounding_mode="floor")))
        return segment_sum(terms, torch.as_tensor(
            np.bincount(pat.indices, minlength=pat.shape[1]),
            device=x.device))

    def diagonal(self):
        """The diagonal, 0 where absent."""
        rows = torch.arange(self.shape[0], device=self.cols.device)
        return torch.where(self.cols == rows[:, None], self.data,
                           0).sum(dim=1)

    def __matmul__(self, x):
        return self.matvec(x)


class TELL:
    """K-transposed padded ELL: ``data``/``cols`` are ``[K, n_rows]`` (and,
    on a CUDA device, their packed copy ``packed``)."""

    def __init__(self, pattern: SparsityPattern, data, cols):
        self.pattern = pattern
        self.data = data
        self.cols = cols
        self.packed = _packed(self)

    @property
    def shape(self):
        return self.pattern.shape

    @property
    def nnz(self):
        return self.pattern.nnz

    @property
    def dtype(self):
        return self.data.dtype

    @staticmethod
    def _slot_t(pattern) -> np.ndarray:
        """Transposed flat position of each CSR entry: slot * n + row."""
        sop = pattern.slot_of_pos
        K = pattern.K
        return (sop % K) * pattern.shape[0] + sop // K

    @staticmethod
    def from_scipy(mat, dtype=None) -> "TELL":
        """From a scipy matrix; ``dtype`` (torch) defaults to the matrix's."""
        csr = sp.csr_matrix(mat)
        csr.sort_indices()
        pattern = SparsityPattern(csr.indptr, csr.indices, csr.shape)
        ndt = numpy_dtype(dtype, csr.data.dtype)
        n, K = pattern.shape[0], pattern.K
        slot_t = TELL._slot_t(pattern)
        flat = np.zeros(K * n, dtype=ndt)
        flat[slot_t] = csr.data.astype(ndt)
        cols = np.zeros(K * n, dtype=np.int32)
        cols[slot_t] = pattern.indices.astype(np.int32)
        return TELL(pattern, torch.from_numpy(flat.reshape(K, n)),
                    torch.from_numpy(cols.reshape(K, n)))

    @staticmethod
    def from_flat(pattern: SparsityPattern, flat_csr_data) -> "TELL":
        """From values in CSR entry order ``[nnz]`` (a tensor), on their
        device."""
        n, K = pattern.shape[0], pattern.K
        dev = flat_csr_data.device
        slot_t = TELL._slot_t(pattern)
        dense = flat_csr_data.new_zeros(K * n)
        dense[torch.as_tensor(slot_t, device=dev)] = flat_csr_data
        cols = np.zeros(K * n, dtype=np.int32)
        cols[slot_t] = pattern.indices.astype(np.int32)
        return TELL(pattern, dense.reshape(K, n),
                    torch.as_tensor(cols.reshape(K, n), device=dev))

    def flat_values(self):
        """The values in CSR entry order ``[nnz]``."""
        return self.data.reshape(-1)[torch.as_tensor(
            TELL._slot_t(self.pattern), device=self.data.device)]

    def with_data(self, data) -> "TELL":
        return TELL(self.pattern, data, self.cols)

    def to_ell(self) -> ELL:
        """The ``[n, K]`` layout of the same matrix."""
        return ELL(self.pattern, self.data.T.contiguous(),
                   self.cols.T.contiguous())

    def to(self, device) -> "TELL":
        return TELL(self.pattern, self.data.to(device), self.cols.to(device))

    def to_scipy(self) -> sp.csr_matrix:
        flat = self.data.cpu().numpy().reshape(-1)
        return sp.csr_matrix(
            (flat[TELL._slot_t(self.pattern)],
             self.pattern.indices.astype(np.int64), self.pattern.indptr),
            shape=self.pattern.shape)

    def matvec(self, x):
        """y = A @ x: the kernel on a CUDA tensor, the plain slot loop
        (summed in slot order) on a CPU one.  A ``Fused`` operand: the
        product with its vector work (``fused_product``)."""
        if isinstance(x, Fused):
            return fused_product(self.packed, x)
        if x.is_cuda:
            return sell_spmv_cuda(self.packed, x.contiguous())
        return tell_spmv_plain(self.data, self.cols, x)

    def diagonal(self):
        """The diagonal, 0 where absent."""
        rows = torch.arange(self.shape[0], device=self.cols.device)
        return torch.where(self.cols == rows, self.data, 0).sum(dim=0)

    def __matmul__(self, x):
        return self.matvec(x)


def spmv(A, x):
    """y = A @ x for any of the port's sparse containers."""
    return A.matvec(x)
