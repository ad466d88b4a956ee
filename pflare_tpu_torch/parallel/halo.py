"""Row-sharded operators: neighbour halo exchange or all-gather.

Ported from ``pflare_tpu.parallel.halo``.  The reference's SpMV
communication is a PetscSF halo exchange: each rank receives the x
entries its off-diagonal block needs (SURVEY.md §2.4,
src/PMISR_Module.F90:174-180 Ad/Ao split).  On a row mesh whose partition
is banded (every structured level and most RCM-ordered unstructured
ones) each shard's columns lie in its own block and one neighbour block
on each side, so the exchange is two neighbour copies:

    y_s = A_s @ concat(x_{s-1}, x_s, x_{s+1})

``HaloELL`` is that operator.  Each active shard holds its row block as
the container the serial operator uses (``air/fullspace.py::make_op``'s
choice): a DIA or banded block with its own offsets or bandwidth and a
column base (the shard's extended window starts ``w`` entries before its
own block), so the DIA and banded kernels run once per active shard, on
the shard's rows.  The gather containers (TELL, ELL, DELL) read x at
any column, and each product costs one launch of the gather kernel
``csrc/sell_spmv.cu`` over the container's packed copy, whatever its
length, so the blocks of a device's shards stack into one container over
their windows laid end to end: one product for each device of the mesh
(one for the whole mesh on one card).  A stacked DELL on a card is packed
where it is built, so a captured sharded solve packs nothing.
Every block lies on its shard's device (cut on the controller device,
then moved there), so on a split mesh each card launches its own shards'
products on the ``Rows`` of its own rows (parallel/mesh.py).  A product
takes a ``Rows`` or a plain tensor on the controller device on any mesh
(``_ShardedOp.matvec``).
``RowShardedOp`` is the fallback when the band check fails: each shard
reads the all-gathered vector, at column base ``s * w``; it takes any
shape (``shard_ell`` of a rectangular operator).  ``from_scipy``
cuts the blocks from a host matrix; ``from_op`` cuts the same blocks
from a device operator's own tensors, as a solve shards its hierarchy.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from ..sparse import ELL, TELL
from ..sparse.ell import choose_lanes, pack
from ..sparse.banded import TILE_ROWS, BandedSpMV
from ..sparse.dell import DELL, PADCOL
from ..sparse.dia import DIA
from ..sparse.pattern import SparsityPattern
from ..sparse.dtypes import torch_dtype
from .mesh import Rows, _fit, gather, make_mesh, padded_rows, split_rows


def _block(kind: str, M: sp.csr_matrix, dtype, device, col_base: int,
           lanes: int | None = None):
    """One shard's container: M's columns index the vector the shard
    reads; DIA and banded take their offsets and band about
    ``col_base + i`` (the others gather at M's columns as they are, their
    packed copy with ``lanes`` lanes a row where given)."""
    if M.nnz == 0:
        return None
    if kind == "dia":
        return DIA.from_scipy(M, dtype, col_base).to(device)
    if kind == "banded":
        return BandedSpMV.from_scipy(M, dtype, col_base).to(device)
    if kind == "tell":
        return _with_lanes(TELL.from_scipy(M, dtype).to(device), lanes)
    if kind == "ell":
        return _with_lanes(ELL.from_scipy(M, dtype).to(device), lanes)
    if kind == "dell":
        return _packed_dell(DELL.from_scipy(M, dtype, device), lanes)
    raise ValueError(f"unknown container kind {kind!r}")


def _with_lanes(M, lanes):
    """A TELL or ELL whose packed copy (on a card) has ``lanes`` lanes a
    row where given."""
    if lanes is not None and M.packed is not None and M.packed.lanes != lanes:
        M.packed = pack(M, lanes)
    return M


def _stack_lanes(kind: str, op, m: int):
    """The lanes a row of the one stacked block of ``op``'s first m rows
    (the gather kinds' block on a mesh of one device), which each
    device's stacked block takes on a split mesh, so that every row sums
    in the same order as on one card.  None on the CPU (nothing packs)."""
    if not op.data.is_cuda:
        return None
    if kind == "dell":
        live = op.cols[:m] < PADCOL
        if op.nonzero_slots:
            live &= op.data[:m] != 0
        return choose_lanes(int(live.sum()), m)
    return choose_lanes(int(op.pattern.indptr[m]), m)


def _not_banded():
    raise ValueError(
        "matrix is not banded for this partition: a row needs columns "
        "beyond the neighbouring shards (use the all-gather path or fewer "
        "shards)")


def _packed_dell(M: DELL, lanes: int | None = None) -> DELL:
    """A DELL with its packed copy made now where it lies on a card (the
    gather kernel reads it; a CUDA graph's capture cannot make it)."""
    if M.data.is_cuda:
        M.pack(lanes)
    return M


# containers whose product gathers x at any column: the shards' blocks
# stack into one (see the module docstring)
GATHER_KINDS = ("tell", "ell", "dell")


class _ShardedOp:
    """One container per active shard (None for a shard without
    entries), or for the gather kinds one stacked container of the
    active shards' rows of each device group (None for a group without
    active shards); the rest of the ``S`` shards own padding only."""

    halo = False

    def __init__(self, blocks, mesh, w: int, n_src: int, dtype, active: int,
                 stacked: bool = False, label: str = ""):
        self.blocks = blocks
        self.mesh = mesh
        self.w = int(w)          # rows per shard
        self.n_src = int(n_src)  # length of the vector a shard reads
        self.dtype = dtype
        self.active = int(active)
        self.stacked = stacked
        self.label = label

    def _spans(self):
        """(group, first shard, active shards) of each device group."""
        return [(g, grp.start, max(0, min(grp.stop, self.active) - grp.start))
                for g, grp in enumerate(self.mesh.groups)]

    @property
    def n_pad(self) -> int:
        return self.w * self.mesh.size

    @property
    def shape(self):
        return (self.n_pad, self.n_pad if self.halo else self.n_src)

    @classmethod
    def from_scipy(cls, A, mesh, dtype=None, n_pad=None, kind=None,
                   label: str = "", active=None):
        """From a host matrix on ``S`` row blocks of ``n_pad / S`` rows
        (default the rows padded to a multiple of ``S``); ``HaloELL``
        raises ValueError when that partition is not banded.  ``kind``:
        the shards' container (default ``make_op``'s choice for the whole
        matrix); ``dtype`` defaults to A's; ``active``: the shards that
        own rows (default those with any of A's rows); ``label`` names the
        operator in the mesh's log."""
        A = sp.csr_matrix(A)
        A.sort_indices()
        S = mesh.size
        n = A.shape[0]
        n_pad = padded_rows(n, mesh) if n_pad is None else int(n_pad)
        if n_pad % S or n_pad < n:
            raise ValueError(f"n_pad {n_pad} must be a multiple of the mesh "
                             f"size {S} and at least the rows {n}")
        w = n_pad // S
        if w == 0:
            raise ValueError("empty shards")
        if active is None:
            active = min(S, -(-n // w))
        cls._check(A, w)
        if kind is None:
            from ..air.fullspace import op_kind

            kind = op_kind(A)
        dtype = dtype or torch_dtype(A.data.dtype)
        n_src = cls._n_src(w, A.shape[1])
        stacked = kind in GATHER_KINDS
        # a split mesh's stacked blocks take the lanes of one whole stack
        lanes = (choose_lanes(int(A.indptr[min(active * w, n)]), active * w)
                 if stacked and mesh.split and torch.device(
                     mesh.device).type == "cuda" else None)
        blocks = []
        for grp in mesh.groups:
            shards = range(grp.start, min(grp.stop, active))
            n_cols = len(shards) * n_src if stacked and cls.halo else n_src
            parts = []
            for s in shards:
                rows = sp.csr_matrix(A[min(s * w, n):min((s + 1) * w, n)])
                indptr = np.concatenate([rows.indptr, np.full(
                    w - rows.shape[0], rows.indptr[-1])])
                # a stacked block reads shard s's window at (s - first)
                # n_src of its group's windows laid end to end (a halo's;
                # the all-gathered vector is one source for every shard)
                offset = (s - grp.start) * n_src if stacked and cls.halo \
                    else 0
                parts.append(sp.csr_matrix(
                    (rows.data, rows.indices - cls._shift(s, w) + offset,
                     indptr), shape=(w, n_cols)))
            if stacked:
                blocks.append(_block(kind, sp.vstack(parts, format="csr"),
                                     dtype, grp.device, 0, lanes) if parts
                              else None)
            else:
                blocks += [_block(kind, M, dtype, grp.device,
                                  s * w - cls._shift(s, w))
                           for s, M in zip(shards, parts)]
        return cls(blocks, mesh, w, n_src, dtype, active, stacked, label)

    @classmethod
    def from_op(cls, op, mesh, label: str = "", active=None):
        """From a device operator whose rows are ``S`` equal blocks (padded
        by ``mesh._pad_op_rows_to``): the same blocks ``from_scipy`` cuts
        from the host matrix, cut from the operator's own tensors on their
        device.  No value is read back: DIA and banded blocks read their
        offsets or bandwidths and the band check back as one small tensor,
        a DELL the band check, and a TELL or ELL checks and shifts its
        host pattern.  ``active`` defaults to every shard."""
        from .mesh import _kind_of

        S = mesh.size
        n_pad, n_cols = op.shape
        if n_pad % S:
            raise ValueError(f"rows {n_pad} must be a multiple of the mesh "
                             f"size {S}")
        w = n_pad // S
        active = S if active is None else int(active)
        kind = _kind_of(op)
        n_src = cls._n_src(w, n_cols)
        if kind in GATHER_KINDS:
            lanes = _stack_lanes(kind, op, active * w) if mesh.split \
                else None
            blocks = [cls._stacked_block(
                kind, op, w, grp.start, min(grp.stop, active), n_src,
                grp.device, lanes) if grp.start < active else None
                for grp in mesh.groups]
        else:
            cut = cls._dia_blocks if kind == "dia" else cls._banded_blocks
            blocks = cut(op, w, active, n_src)
            if mesh.split:
                # each shard's block onto its own device
                blocks = [None if blk is None else
                          blk.to(mesh.devices[s])
                          for s, blk in enumerate(blocks)]
        return cls(blocks, mesh, w, n_src, op.dtype, active,
                   kind in GATHER_KINDS, label)

    @classmethod
    def _read_back(cls, t, far):
        """The ints ``t`` ([active, k]) on the host, read back in one copy
        with a halo's band check: an entry ``far`` from its shard (past
        the neighbouring blocks) raises ValueError."""
        if cls.halo:
            t = torch.cat([t, far.any().long().expand(t.shape[0], 1)], dim=1)
        got = t.cpu().numpy()
        if not cls.halo:
            return got
        if got[0, -1]:
            _not_banded()
        return got[:, :-1]

    @classmethod
    def _dia_blocks(cls, op, w, active, n_src):
        """Shard s keeps the offsets with an entry in its rows; an entry
        of row s w + r on offset ``off`` reads source column
        s w + r + off - shift(s)."""
        K, dev = len(op.offsets), op.data.device
        data = op.data[:, :active * w].reshape(K, active, w).transpose(0, 1)
        live = data != 0                                   # [active, K, w]
        rel = (torch.arange(w, device=dev)[None, :] + op.col_base
               + torch.as_tensor(op.offsets, device=dev)[:, None])
        used = cls._read_back(live.any(-1).long(),
                              live & ((rel >= 2 * w) | (rel < -w)))
        blocks = []
        for s in range(active):
            ks = np.flatnonzero(used[s])
            if not len(ks):
                blocks.append(None)
                continue
            blocks.append(DIA(
                [op.offsets[k] for k in ks],
                data[s, torch.as_tensor(ks, device=dev)].contiguous(),
                (w, n_src), s * w - cls._shift(s, w) + op.col_base))
        return blocks

    @classmethod
    def _banded_blocks(cls, op, w, active, n_src):
        """Shard s keeps the slots up to its last entry and its own
        bandwidth b about row s w + r; each entry's window-local column
        is re-based on the block's window blocks of width W(b)."""
        K, dev = op.data.shape[0], op.data.device
        rows = torch.arange(op.data.shape[1], device=dev)
        # the x index of each slot (sparse/banded.py's window arithmetic)
        col = ((rows // TILE_ROWS * TILE_ROWS) // op.W * op.W - op.w
               + op.col_base)[None, :] + op.lcols.long()
        data = op.data[:, :active * w].reshape(K, active, w).transpose(0, 1)
        rel = (col[:, :active * w].reshape(K, active, w).transpose(0, 1)
               - torch.arange(active, device=dev)[:, None, None] * w)
        live = data != 0                                   # [active, K, w]
        r = torch.arange(w, device=dev)
        band = torch.where(live, (rel - r).abs(), 0).amax(dim=(1, 2))
        got = cls._read_back(
            torch.cat([band[:, None], live.any(-1).long()], dim=1),
            live & ((rel >= 2 * w) | (rel < -w)))
        n_tiles = -(-w // TILE_ROWS) * TILE_ROWS
        blocks = []
        for s in range(active):
            ks = np.flatnonzero(got[s, 1:])
            if not len(ks):
                blocks.append(None)
                continue
            k_s, b = int(ks[-1]) + 1, int(got[s, 0])
            W = -(-(2 * b + TILE_ROWS) // 128) * 128
            base = (r // TILE_ROWS * TILE_ROWS) // W * W
            lcols = torch.where(live[s, :k_s], rel[s, :k_s] + b - base, 0)
            blocks.append(BandedSpMV(
                F.pad(data[s, :k_s], (0, n_tiles - w)).contiguous(),
                F.pad(lcols.to(torch.int32), (0, n_tiles - w)).contiguous(),
                w, n_src, b, W, s * w - cls._shift(s, w)))
        return blocks

    @classmethod
    def _stacked_block(cls, kind, op, w, first, stop, n_src, device,
                       lanes=None):
        """The gather kinds' one container over the rows of shards
        ``[first, stop)`` (the active shards of a device group), each
        column moved to its shard's source: ``- shift(s)``, and for a halo
        ``+ (s - first) n_src`` (the windows laid end to end), built on
        ``device``, packed with ``lanes`` lanes a row where given."""
        r0, m = first * w, (stop - first) * w
        n_stack = (stop - first) * n_src if cls.halo else n_src
        if kind == "dell":
            cols = op.cols[r0:r0 + m].long()
            live = cols < PADCOL
            s = first + torch.arange(m, device=cols.device)[:, None] // w
            if cls.halo and bool((live & ((s - torch.div(
                    cols, w, rounding_mode="floor")).abs() > 1)).any()):
                _not_banded()
            move = -cls._shift(s, w) + ((s - first) * n_src if cls.halo
                                        else 0)
            return _packed_dell(DELL(
                op.data[r0:r0 + m].to(device),
                torch.where(live, cols + move, PADCOL).to(torch.int32)
                .to(device), n_stack, op.nonzero_slots), lanes)
        pat = op.pattern
        indptr = pat.indptr[r0:r0 + m + 1]
        indices = pat.indices[indptr[0]:indptr[-1]]
        indptr = indptr - indptr[0]
        row_len = np.diff(indptr)
        if cls.halo and len(indices):
            # each row's least and greatest column bound its entries
            full = np.flatnonzero(row_len)
            lo = np.minimum.reduceat(indices, indptr[full]) // w
            hi = np.maximum.reduceat(indices, indptr[full]) // w
            own = (r0 + full) // w
            if np.any(lo < own - 1) or np.any(hi > own + 1):
                _not_banded()
        s_row = first + np.arange(m, dtype=np.int64) // w
        move = (np.zeros(m, dtype=np.int64) - cls._shift(s_row, w)
                + ((s_row - first) * n_src if cls.halo else 0))
        pattern = SparsityPattern(indptr, indices + np.repeat(move, row_len),
                                  (m, n_stack))
        # every slot moves with its row; a padding slot (value 0) is kept
        # inside the stacked vector
        move = torch.as_tensor(move, device=op.data.device)
        if kind == "ell":
            return _with_lanes(ELL(
                pattern, op.data[r0:r0 + m].to(device),
                (op.cols[r0:r0 + m] + move[:, None]).clamp(0, n_stack - 1)
                .to(torch.int32).to(device)), lanes)
        return _with_lanes(TELL(
            pattern, op.data[:, r0:r0 + m].contiguous().to(device),
            (op.cols[:, r0:r0 + m] + move[None, :]).clamp(0, n_stack - 1)
            .to(torch.int32).to(device)), lanes)

    def matvec(self, x):
        """y = A x on any mesh.  A ``Rows`` (a split mesh's vector, of
        ``n_in`` entries, as ``shard_vec`` makes it) gives a ``Rows``.  A
        plain tensor on the controller device, fitted with zeros or cut
        to the columns the operator reads (``n_pad`` for a halo, the
        operator's columns otherwise), gives one tensor of ``n_pad``
        entries there, zeros past the operator's rows: on a split mesh it
        is placed on the device groups (``_place``), each group's blocks
        multiply on its device and its rows come back to the controller
        (``gather``)."""
        if isinstance(x, Rows):
            return self._matvec_split(x)
        if self.mesh.split:
            self.mesh._check(x)
            return gather(self._products(self._place(x), x.dtype))
        return self._products([self._sources(x)], x.dtype).parts[0]

    def _matvec_split(self, x: Rows) -> Rows:
        """The product on a split mesh: each device's shards read their
        sources there (``_sources_split``) and write its rows of y."""
        if x.n != self.n_in:
            raise ValueError(f"a Rows of {x.n} entries for an operator "
                             f"that takes {self.n_in}")
        return self._products(self._sources_split(x), x.dtype)

    def _products(self, sources, dtype) -> Rows:
        """Each device group's rows of y, on its device: its blocks read
        ``sources[g]`` there (a group without active shards reads nothing
        and gives zeros).  On a mesh of one device, its one part is y."""
        parts = []
        for (g, first, k), src in zip(self._spans(), sources):
            grp = self.mesh.groups[g]

            def zero(m, dev=grp.device):
                return torch.zeros(m, dtype=dtype, device=dev)

            if self.stacked:
                blk = self.blocks[g]
                ys = [zero(k * self.w) if blk is None else
                      blk.matvec(src.reshape(-1) if self.halo else src)]
            else:
                ys = [zero(self.w) if blk is None else blk.matvec(
                    src[i] if self.halo else src)
                    for i, blk in enumerate(self.blocks[first:first + k])]
            pad = (grp.stop - grp.start - k) * self.w
            if pad:
                ys.append(zero(pad))
            parts.append(torch.cat(ys))
        return Rows(self.mesh, parts, self.n_pad)

    def __matmul__(self, x):
        return self.matvec(x)

    def to_scipy(self) -> sp.csr_matrix:
        """The operator on the padded row space, from its blocks."""
        rows, cols, vals = [], [], []
        for i, blk in enumerate(self.blocks):
            if blk is None:
                continue
            coo = blk.to_scipy().tocoo()
            # a stacked block starts at its group's first shard
            first = self.mesh.groups[i].start if self.stacked else i
            shard = first + coo.row // self.w if self.stacked else i
            local = coo.col - ((shard - first) * self.n_src
                               if self.stacked and self.halo else 0)
            rows.append(coo.row + first * self.w)
            cols.append(local + self._shift(shard, self.w))
            vals.append(coo.data)
        n_cols = self.n_pad if self.halo else self.n_src
        if not rows:
            return sp.csr_matrix((self.n_pad, n_cols))
        M = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                  np.concatenate(cols))),
                          shape=(self.n_pad, n_cols))
        M.sort_indices()
        return M


class HaloELL(_ShardedOp):
    """A square operator on a banded row partition: each shard reads its
    extended window ``[(s-1) w, (s+2) w)``, filled by two neighbour
    exchanges (``Mesh.halo``), as its container's column base ``w``."""

    halo = True

    @staticmethod
    def _check(A, w):
        rows = np.repeat(np.arange(A.shape[0], dtype=np.int64),
                         np.diff(A.indptr))
        if A.nnz and np.any(np.abs(rows // w - A.indices // w) > 1):
            _not_banded()

    @staticmethod
    def _n_src(w, n_cols):
        return 3 * w

    @staticmethod
    def _shift(s, w):
        """The global column of a shard's source entry 0."""
        return (s - 1) * w

    def _sources(self, x):
        S, w = self.mesh.size, self.w
        blocks = _fit(x, self.n_pad).view(S, w)[:self.active]
        return self.mesh.halo(blocks, self.label)

    def _sources_split(self, x: Rows):
        """Each group's windows, neighbour blocks across the group borders
        copied from the neighbouring devices (``Mesh.halo_split``)."""
        return self.mesh.halo_split(
            [p.view(-1, self.w)[:k] for p, (_, _, k) in
             zip(x.parts, self._spans())], self.label)

    @property
    def n_in(self) -> int:
        return self.n_pad

    def _place(self, x):
        """A plain x on the controller as each group's windows: its rows
        split over the groups (``split_rows``), then exchanged as a
        ``Rows`` is."""
        return self._sources_split(split_rows(_fit(x, self.n_pad),
                                              self.mesh, self.label))


class RowShardedOp(_ShardedOp):
    """A row-sharded operator on any partition: each shard reads the
    all-gathered vector, its container's column base its row start."""

    @staticmethod
    def _check(A, w):
        pass

    @staticmethod
    def _n_src(w, n_cols):
        return n_cols

    @staticmethod
    def _shift(s, w):
        return 0

    def _sources(self, x):
        return self.mesh.all_gather(_fit(x, self.n_src), self.label)

    @property
    def n_in(self) -> int:
        """``shard_vec``'s padding of the columns."""
        return padded_rows(self.n_src, self.mesh)

    def _sources_split(self, x: Rows):
        """The whole vector on every group's device, cut to the columns."""
        return [full[:self.n_src] for full in
                self.mesh.all_gather(x.parts, self.label)]

    def _place(self, x):
        """A plain x on the controller, whole on the device of every group
        with active shards (one copy to each other group; the log counts
        the all-gather the one-device mesh counts)."""
        full = self.mesh.all_gather(_fit(x, self.n_src), self.label)
        return [self.mesh._to_group(full, 0, g, self.label) if k else None
                for g, _, k in self._spans()]


class HaloSpMV:
    """Banded-partition SpMV with explicit neighbour exchange, built from a
    scipy matrix; ``matvec`` takes and returns unpadded vectors."""

    def __init__(self, A, mesh=None, n_shards: int | None = None):
        A = sp.csr_matrix(A)
        if mesh is None:
            mesh = make_mesh(n_shards)
        self.mesh = mesh
        self.op = HaloELL.from_scipy(A, mesh)
        self.n = A.shape[0]
        self.w = self.op.w

    def matvec(self, x):
        """x and the result as tensors on the mesh's controller device."""
        x = torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x, dtype=self.op.dtype,
            device=self.mesh.device)
        return self.op.matvec(x)[: self.n]

    def __matmul__(self, x):
        return self.matvec(x)
