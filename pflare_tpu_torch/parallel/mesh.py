"""The row mesh: domain decomposition over matrix rows.

Ported from ``pflare_tpu.parallel.mesh``.  The reference's only
parallelism is row distribution over MPI ranks (SURVEY.md §2.4,
src/PMISR_Module.F90:174-180); the JAX package maps it onto a 1-D device
mesh over ``jax.devices()``.  Here a ``Mesh`` is one controller's list of
shards, each with a ``torch.device``.  Repeats are allowed and form
contiguous runs, the mesh's device *groups* (one card holds several
shards, as on one card every shard sits on ``cuda:0``); the controller
device is the first shard's.

  * a row-sharded vector on a mesh of one group is one tensor of the
    padded length ``S * w`` on its device, shard s owning rows
    ``[s*w, (s+1)*w)``; on a split mesh (several groups) it is a
    ``Rows``: each group's device holds the contiguous rows of its own
    shards.  ``Rows`` has the arithmetic, ``torch.linalg.norm`` and
    ``torch.dot`` of a vector, so the solvers run on it unchanged: a dot
    or norm is a partial on each device, summed on the controller in
    device order;
  * a row-sharded operator holds one local operator per active shard
    (``parallel/halo.py``), built on its shard's device: ``HaloELL`` when
    the partition is banded (each shard reads its extended window,
    filled by two neighbour exchanges), ``RowShardedOp`` otherwise (each
    shard reads the all-gathered vector);
  * an exchange within a device is a copy there; between devices the
    sender's block is copied into a buffer on the receiver's device (a
    peer copy between cards, which PyTorch orders after the sender's
    work and before the receiver's with CUDA events, with no device-wide
    synchronisation; a real copy on the CPU too);
  * every exchange is counted in the mesh's communication log, calls and
    bytes by operator label and kind (``ppermute``, ``all_gather``), where
    the JAX package's tests read the collectives of the compiled HLO; the
    bytes that cross devices are counted again under the kind ``peer``
    (a mesh of one group has none).

Shard agglomeration (src/Repartition.F90) keeps ``active <= S`` shards on
coarse levels: their rows pad to equal blocks, so trailing shards own
only padding and launch nothing.  Whole levels and the coarse solve live
on the controller device.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

ROW_AXIS = "rows"


def tensor_device(device) -> torch.device:
    """The device a tensor made on ``device`` reports (``cpu:1`` is
    ``cpu``, ``cuda`` the current card): what to compare a tensor's device
    with."""
    return torch.empty(0, device=device).device


@dataclass(frozen=True)
class Group:
    """The consecutive shards ``[start, stop)`` of a mesh on one device."""
    device: torch.device
    start: int
    stop: int


class Mesh:
    """A 1-D mesh of ``len(devices)`` row shards, their device groups and
    its communication log (``log[(label, kind)] = [calls, bytes]``)."""

    def __init__(self, devices):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        self.devices = tuple(devs)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        groups = []
        for s, d in enumerate(self.devices):
            if groups and groups[-1].device == d:
                groups[-1] = Group(d, groups[-1].start, s + 1)
            else:
                groups.append(Group(d, s, s + 1))
        if len({g.device for g in groups}) != len(groups):
            raise ValueError("the shards of one device must be consecutive: "
                             f"{[str(d) for d in self.devices]}")
        self.groups = tuple(groups)
        self._group_of = np.repeat(np.arange(len(groups)),
                                   [g.stop - g.start for g in groups])
        self.log = defaultdict(lambda: [0, 0])

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The controller device (the first shard's): whole levels, the
        coarse solve, the sums of the reductions and the callers'
        vectors live there."""
        return self.devices[0]

    @property
    def split(self) -> bool:
        """Whether the shards lie on more than one device."""
        return len(self.groups) > 1

    def group_of(self, shard: int) -> int:
        return int(self._group_of[shard])

    def record(self, label: str, kind: str, nbytes: int):
        entry = self.log[(label, kind)]
        entry[0] += 1
        entry[1] += int(nbytes)

    def reset_log(self):
        self.log.clear()

    def traffic(self, label: str | None = None) -> dict:
        """{kind: (calls, bytes)} summed over every label, or for one."""
        out = {}
        for (lab, kind), (calls, nbytes) in self.log.items():
            if label is None or lab == label:
                c, b = out.get(kind, (0, 0))
                out[kind] = (c + calls, b + nbytes)
        return out

    def send(self, t, device, label: str = ""):
        """``t`` copied onto ``device``, another group's: a peer copy
        between cards (ordered by CUDA events, see the module docstring),
        a real copy on the CPU; counted as kind ``peer``."""
        self.record(label, "peer", t.numel() * t.element_size())
        return t.to(device, copy=True)

    def _to_group(self, t, src: int, dst: int, label: str):
        """``t`` of group ``src`` on group ``dst``'s device."""
        if src == dst:
            return t
        return self.send(t, self.groups[dst].device, label)

    def ppermute(self, blocks, pairs, label: str = ""):
        """``out[dst] = blocks[src]`` for each (src, dst) pair of shards,
        zeros where no shard sends: one copy on the device of the
        row-sharded ``blocks`` (``[S, ...]``)."""
        self._check(blocks)
        out = torch.zeros_like(blocks)
        if not pairs:
            return out
        src = [p[0] for p in pairs]
        step = pairs[0][1] - src[0]
        if (all(d - s == step for s, d in pairs)
                and src == list(range(src[0], src[0] + len(src)))):
            # a shift: one copy of consecutive blocks
            out[src[0] + step:src[-1] + 1 + step] = \
                blocks[src[0]:src[-1] + 1]
        else:
            for s, d in pairs:
                out[d] = blocks[s]
        self.record(label, "ppermute",
                    len(pairs) * blocks[0].numel() * blocks.element_size())
        return out

    def halo(self, blocks, label: str = "", depth: int = 1):
        """Each shard's extended window of the row-sharded ``blocks``
        (``[S, w, ...]``): ``[S, (2 depth + 1) w, ...]``, the ``depth``
        blocks on its left, its own and the ``depth`` on its right (zeros
        past either end of the mesh), filled by ``2 depth`` neighbour
        exchanges (the reference's ``ppermute`` shifts).  On a split mesh
        ``blocks`` is a list, each group's blocks on its device (see
        ``halo_split``)."""
        if isinstance(blocks, (list, tuple)):
            return self.halo_split(blocks, label, depth)
        S = blocks.shape[0]
        fwd = [(i, i + 1) for i in range(S - 1)]    # from the left
        bwd = [(i + 1, i) for i in range(S - 1)]    # from the right
        left, right = [blocks], [blocks]
        for _ in range(depth):
            left.insert(0, self.ppermute(left[0], fwd, label))
            right.append(self.ppermute(right[-1], bwd, label))
        return torch.cat(left[:-1] + [blocks] + right[1:], dim=1)

    def halo_split(self, parts, label: str = "", depth: int = 1):
        """``halo`` over the groups of a split mesh: ``parts[g]`` the
        blocks ``[k_g, w, ...]`` of the first ``k_g`` shards of group g
        (the active ones: a group after the last active shard holds
        none), on its device.  Returns each group's windows
        ``[k_g, (2 depth + 1) w, ...]`` on its device; the blocks a
        window needs from another group come over in one copy from each
        (counted as ``peer``), and the log counts the same ``ppermute``
        calls and bytes as ``halo`` on one device."""
        counts = [int(p.shape[0]) for p in parts]
        active = sum(counts)
        blk = next(p for p in parts if p.shape[0])[0]
        if active > 1:
            for _ in range(2 * depth):
                self.record(label, "ppermute", (active - 1) * blk.numel()
                            * blk.element_size())
        out = []
        for g, grp in enumerate(self.groups):
            k = counts[g]
            if k == 0:
                out.append(parts[g])
                continue
            a = grp.start
            pieces = []
            for lo, hi in ((a - depth, a), (a + k, a + k + depth)):
                side = parts[g].new_zeros((depth, *blk.shape))
                for h, other in enumerate(self.groups):
                    # the active shards of another group in [lo, hi)
                    s0 = max(lo, other.start)
                    s1 = min(hi, other.start + counts[h])
                    if s0 < s1:
                        side[s0 - lo:s1 - lo] = self._to_group(
                            parts[h][s0 - other.start:s1 - other.start],
                            h, g, label)
                pieces.append(side)
            ext = torch.cat([pieces[0], parts[g][:k], pieces[1]])
            out.append(torch.cat([ext[i:i + k] for i in range(2 * depth + 1)],
                                 dim=1))
        return out

    def all_gather(self, x, label: str = ""):
        """A row-sharded tensor, whole on every shard: on one device the
        tensor itself, counted as each shard receiving the others'
        blocks.  On a split mesh ``x`` is a list, each group's rows on its
        device, and each group gets the whole tensor on its own device
        (a list, in group order)."""
        if isinstance(x, (list, tuple)):
            whole = sum(p.numel() for p in x)
            self.record(label, "all_gather",
                        whole * x[0].element_size() * (self.size - 1))
            return [torch.cat([self._to_group(p, h, g, label)
                               for h, p in enumerate(x)])
                    for g in range(len(self.groups))]
        self._check(x)
        self.record(label, "all_gather",
                    x.numel() * x.element_size() * (self.size - 1))
        return x

    def scatter(self, t, label: str = ""):
        """The row blocks ``t`` (``[S, ...]``, on the controller device)
        placed on their shards' devices: each group's contiguous blocks, a
        view on the controller's own group and a copy on the others."""
        return [self._to_group(t[g.start:g.stop], 0, i, label)
                for i, g in enumerate(self.groups)]

    def _check(self, t):
        if tensor_device(t.device) != tensor_device(self.device):
            raise ValueError(f"a tensor on {t.device}, the mesh's "
                             f"controller device {self.device}")


class Rows:
    """A row-sharded vector of ``n`` entries on a split mesh: ``parts[g]``
    holds the rows of group g's shards, ``(stop - start) * n / S`` of
    them, on its device (``n`` a multiple of the mesh's size).  Adds,
    subtracts, multiplies and divides part by part with another ``Rows``
    of the same length, a number, a 0-dim tensor (copied to each device)
    or a ``Replicated``; ``torch.linalg.norm``, ``torch.dot`` and
    ``torch.zeros_like`` take it (the first two as partials on each
    device, summed on the controller in device order), and ``v[:k]`` is
    its first k entries as one tensor on the controller device."""

    __slots__ = ("mesh", "parts", "n")

    def __init__(self, mesh: Mesh, parts, n: int):
        self.mesh = mesh
        self.parts = list(parts)
        self.n = int(n)

    @property
    def shape(self):
        return (self.n,)

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self):
        return self.mesh.device

    def _map(self, fn):
        return Rows(self.mesh, [fn(p) for p in self.parts], self.n)

    def _zip(self, other, fn):
        if isinstance(other, Rows):
            if other.n != self.n:
                raise ValueError(f"Rows of {self.n} and {other.n} entries")
            return Rows(self.mesh, [fn(a, b) for a, b in
                                    zip(self.parts, other.parts)], self.n)
        if isinstance(other, Replicated):
            return Rows(self.mesh, [fn(a, v) for a, v in
                                    zip(self.parts, other.values)], self.n)
        if isinstance(other, torch.Tensor):
            if other.dim():
                raise TypeError("Rows combine with Rows, numbers and 0-dim "
                                "tensors only")
            return Rows(self.mesh, [fn(a, other.to(a.device))
                                    for a in self.parts], self.n)
        return Rows(self.mesh, [fn(a, other) for a in self.parts], self.n)

    def __add__(self, o):
        return self._zip(o, lambda a, b: a + b)

    def __radd__(self, o):
        return self._zip(o, lambda a, b: b + a)

    def __sub__(self, o):
        return self._zip(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._zip(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._zip(o, lambda a, b: a * b)

    def __rmul__(self, o):
        return self._zip(o, lambda a, b: b * a)

    def __truediv__(self, o):
        return self._zip(o, lambda a, b: a / b)

    def __rtruediv__(self, o):
        return self._zip(o, lambda a, b: b / a)

    def __neg__(self):
        return self._map(lambda a: -a)

    def clone(self):
        return self._map(torch.clone)

    def __getitem__(self, key):
        if not (isinstance(key, slice) and key.start in (None, 0)
                and key.step in (None, 1)):
            raise TypeError("Rows take only a leading slice v[:k]")
        return gather(self)[key]

    def index_select(self, dim: int, index):
        """The coarse points of a level (``index`` a ``CoarseMap``)."""
        if dim != 0 or not isinstance(index, CoarseMap):
            raise TypeError("Rows.index_select takes a CoarseMap")
        return index.select(self)

    def fit(self, n: int):
        """The vector zero-padded or cut to ``n`` entries (a multiple of
        the mesh's size), laid out anew: each group's rows of the new
        length, copied from the groups that hold them."""
        if n == self.n:
            return self
        mesh, S = self.mesh, self.mesh.size
        w_old, w_new = self.n // S, n // S
        parts = []
        for g, grp in enumerate(mesh.groups):
            lo, hi = grp.start * w_new, grp.stop * w_new
            out = self.parts[g].new_zeros(hi - lo)
            for h, src in enumerate(mesh.groups):
                s0 = max(lo, src.start * w_old)
                s1 = min(hi, src.stop * w_old, self.n)
                if s0 < s1:
                    out[s0 - lo:s1 - lo] = mesh._to_group(
                        self.parts[h][s0 - src.start * w_old:
                                      s1 - src.start * w_old], h, g, "fit")
            parts.append(out)
        return Rows(mesh, parts, n)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.linalg.norm and len(args) == 1 and not kwargs:
            v = args[0]
            return torch.linalg.norm(torch.stack(v._partials(
                [torch.linalg.norm(p) for p in v.parts])))
        if func is torch.dot and not kwargs:
            a, b = args
            return torch.stack(a._partials(
                [torch.dot(p, q) for p, q in zip(a.parts, b.parts)])).sum()
        if func is torch.zeros_like and len(args) == 1 and not kwargs:
            return args[0]._map(torch.zeros_like)
        return NotImplemented

    def _partials(self, values):
        """Each group's 0-dim partial on the controller device."""
        return [self.mesh._to_group(v, g, 0, "reductions")
                for g, v in enumerate(values)]


class Replicated:
    """A tensor of a split mesh's shards, one copy on each group's device
    (``values[g]``), indexed alike: a sharded inverse's polynomial
    coefficients, so that ``coefficients[k] * v`` copies nothing."""

    def __init__(self, values):
        self.values = list(values)

    @property
    def shape(self):
        return self.values[0].shape

    def __getitem__(self, key):
        return Replicated([v[key] for v in self.values])


def split_rows(v, mesh: Mesh, label: str = ""):
    """A padded vector (length a multiple of the mesh's size) on the
    controller device as the ``Rows`` of a split mesh."""
    w = v.shape[0] // mesh.size
    return Rows(mesh, [p.reshape(-1) for p in mesh.scatter(
        v.view(mesh.size, w), label)], v.shape[0])


def gather(v):
    """A ``Rows`` as one tensor on the controller device (a tensor as it
    is)."""
    if isinstance(v, torch.Tensor):
        return v
    mesh = v.mesh
    return torch.cat([mesh._to_group(p, g, 0, "gather")
                      for g, p in enumerate(v.parts)])


class CoarseMap:
    """The coarse points of a level sharded over a split mesh (the
    ``coarse`` index of its dict): coarse row i sits at row ``coarse[i]``
    of the fine level's ``Rows`` (``n_fine`` entries) and at row i of the
    next level's, a ``Rows`` of ``n_next`` entries, or one tensor on the
    controller device when ``n_next`` is None (a whole next level, or the
    coarse solve).  ``select`` picks them from a fine vector,
    ``place`` writes them into a fine vector of zeros: per pair of
    groups, one ``index_select`` and one ``index_copy_``, with a copy
    between them when the pair lies on two devices."""

    def __init__(self, mesh: Mesh, coarse, n_fine: int, n_next=None,
                 label: str = ""):
        coarse = np.asarray(coarse, dtype=np.int64)
        S = mesh.size
        self.mesh, self.label = mesh, label
        self.n_fine, self.n_next = int(n_fine), n_next
        self.shape = (len(coarse),)
        w_f = self.n_fine // S
        f_grp = mesh._group_of[coarse // w_f]
        f_loc = coarse - np.array([g.start for g in mesh.groups])[f_grp] * w_f
        pos = np.arange(len(coarse), dtype=np.int64)
        if n_next is None:
            c_grp, c_loc = np.zeros_like(pos), pos
            self._sizes = [len(coarse)]
        else:
            w_c = int(n_next) // S
            c_grp = mesh._group_of[pos // w_c]
            c_loc = pos - np.array([g.start for g in mesh.groups])[c_grp] * w_c
            self._sizes = [(g.stop - g.start) * w_c for g in mesh.groups]
        self.pairs = []
        for hf in range(len(mesh.groups)):
            for gc in range(len(self._sizes)):
                at = np.flatnonzero((f_grp == hf) & (c_grp == gc))
                if len(at):
                    self.pairs.append((
                        hf, gc,
                        torch.as_tensor(f_loc[at],
                                        device=mesh.groups[hf].device),
                        torch.as_tensor(c_loc[at],
                                        device=mesh.groups[gc].device)))

    def select(self, v: Rows):
        mesh = self.mesh
        outs = [v.parts[g].new_zeros(n) for g, n in enumerate(self._sizes)]
        for hf, gc, fi, ci in self.pairs:
            outs[gc].index_copy_(0, ci, mesh._to_group(
                v.parts[hf].index_select(0, fi), hf, gc, self.label))
        if self.n_next is None:
            return outs[0]
        return Rows(mesh, outs, self.n_next)

    def place(self, x) -> Rows:
        mesh, S = self.mesh, self.mesh.size
        w_f = self.n_fine // S
        src = x.parts if isinstance(x, Rows) else [x]
        outs = [torch.zeros((g.stop - g.start) * w_f, dtype=src[0].dtype,
                            device=g.device) for g in mesh.groups]
        for hf, gc, fi, ci in self.pairs:
            outs[hf].index_copy_(0, fi, mesh._to_group(
                src[gc].index_select(0, ci), gc, hf, self.label))
        return Rows(mesh, outs, self.n_fine)


def _spread(n: int, cards: list) -> list:
    """n shards over the given devices in contiguous runs, the first
    ``n % len(cards)`` of them one shard more."""
    per, extra = divmod(n, len(cards))
    out = []
    for i, d in enumerate(cards):
        out += [d] * (per + (i < extra))
    return out


def make_mesh(n_devices: int | None = None, devices=None,
              device="cuda") -> Mesh:
    """A row mesh.  With ``devices``, ``n_devices`` shards (default one
    each) spread over those devices in contiguous runs, the first ones a
    shard more where they do not divide: ``make_mesh(8,
    devices=["cuda:0", ..., "cuda:3"])`` puts two on each card (repeats
    in ``devices`` form the device groups as they stand).  Otherwise
    ``n_devices`` shards all sit on ``device`` ("cuda" the current card),
    as the CPU tests put 8 shards on "cpu" and the card 4 on "cuda:0";
    with no ``n_devices`` and ``device="cuda"``, one shard a visible card,
    as the reference's ``jax.devices()`` (one shard on any other device).
    A mesh over several cards solves eagerly (``PCAIR(jit=False)``).
    Without a card ``device="cuda"`` raises."""
    if devices is not None:
        devices = list(devices)
        return Mesh(devices if n_devices is None
                    else _spread(int(n_devices), devices))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device='cuda'): no CUDA device; "
                               "pass device='cpu' for a CPU mesh")
        if dev.index is None:
            if n_devices is None:
                return Mesh([torch.device("cuda", i)
                             for i in range(torch.cuda.device_count())])
            dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh([dev] * (1 if n_devices is None else int(n_devices)))


@dataclass(frozen=True)
class Placement:
    """Where a tensor lives on a mesh: row-sharded (``rows``) or
    replicated (the reference's NamedSharding(mesh, P(ROW_AXIS)) and
    NamedSharding(mesh, P()))."""
    mesh: Mesh
    rows: bool


def row_sharding(mesh: Mesh) -> Placement:
    return Placement(mesh, True)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, False)


def padded_rows(n: int, mesh: Mesh) -> int:
    """The row count padded to a multiple of the mesh's size."""
    return -(-n // mesh.size) * mesh.size


def _fit(v, n: int):
    """v zero-padded or cut to length n (pads hold zeros throughout)."""
    if v.shape[0] < n:
        return torch.cat([v, v.new_zeros(n - v.shape[0])])
    return v[:n]


def shard_vec(x, mesh: Mesh, pad: bool = True):
    """x on the mesh's device, zero-padded to a multiple of its size; on
    a split mesh a ``Rows``, each group's rows on its device."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    if n % mesh.size and not pad:
        raise ValueError("length not divisible by mesh size")
    v = _fit(x.to(mesh.device), padded_rows(n, mesh))
    return split_rows(v, mesh, "shard_vec") if mesh.split else v


def replicate(tree, mesh: Mesh):
    """Every tensor and sparse container (anything with ``.to(device)``)
    of a nested dict/list on the mesh's device; on a split mesh a
    ``Replicated`` of one copy on each group's device."""
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    if hasattr(tree, "to"):
        if mesh.split:
            return Replicated([tree.to(g.device) for g in mesh.groups])
        return tree.to(mesh.device)
    return tree


def shard_ell(A, mesh: Mesh, pad: bool = True):
    """A device operator of any shape (an ``ELL`` as the JAX package's
    takes, or any of the port's containers) row-sharded over the mesh: a
    ``RowShardedOp`` whose shards read the all-gathered vector (the
    gather kinds one stacked block a device group); rows that do not
    divide the mesh pad with empty rows, which give 0.  Its product
    takes a plain tensor on any mesh, or on a split mesh the ``Rows``
    that ``shard_vec`` makes of one (``_ShardedOp.matvec``)."""
    from .halo import RowShardedOp

    if A.shape[0] % mesh.size and not pad:
        raise ValueError("rows not divisible by mesh size")
    n_pad = padded_rows(A.shape[0], mesh)
    return RowShardedOp.from_op(_pad_op_rows_to(A, n_pad), mesh,
                                active=_active(A.shape[0], n_pad, mesh))


def _active(n: int, n_pad: int, mesh: Mesh) -> int:
    """The shards that own any of n rows in blocks of n_pad / S."""
    return min(mesh.size, -(-n // (n_pad // mesh.size)))


def _pad_op_rows_to(op, n_pad: int):
    """A device operator with empty rows appended up to ``n_pad``, on its
    own device (its columns widen to ``n_pad`` when it is square, since
    the padded vector space is then both sides): DIA and banded values
    pad with zeros, DELL rows with (0, PADCOL) slots, and a TELL or ELL
    extends its host pattern with empty rows.  No value is read back, and
    a padded DELL is not packed: the shard blocks cut from it
    (``halo.py::_ShardedOp.from_op``) run the products and pack there."""
    from ..sparse import ELL, TELL
    from ..sparse.banded import TILE_ROWS, BandedSpMV
    from ..sparse.dell import DELL, PADCOL
    from ..sparse.dia import DIA
    from ..sparse.pattern import SparsityPattern

    n, n_cols = op.shape
    if n_pad < n:
        raise ValueError(f"n_pad {n_pad} < rows {n}")
    if n_pad == n:
        return op
    cols = n_pad if n_cols == n else n_cols
    extra = n_pad - n
    if isinstance(op, DIA):
        return DIA(op.offsets, F.pad(op.data, (0, extra)), (n_pad, cols),
                   op.col_base)
    if isinstance(op, BandedSpMV):
        tail = -(-n_pad // TILE_ROWS) * TILE_ROWS - op.data.shape[1]
        return BandedSpMV(F.pad(op.data, (0, tail)),
                          F.pad(op.lcols, (0, tail)), n_pad, cols, op.w,
                          op.W, op.col_base)
    if isinstance(op, DELL):
        return DELL(F.pad(op.data, (0, 0, 0, extra)),
                    F.pad(op.cols, (0, 0, 0, extra), value=PADCOL), cols,
                    op.nonzero_slots)
    if isinstance(op, (TELL, ELL)):
        pat = op.pattern
        pattern = SparsityPattern(
            np.concatenate([pat.indptr, np.full(extra, pat.indptr[-1])]),
            pat.indices, (n_pad, cols))
        if isinstance(op, TELL):
            return TELL(pattern, F.pad(op.data, (0, extra)),
                        F.pad(op.cols, (0, extra)))
        return ELL(pattern, F.pad(op.data, (0, 0, 0, extra)),
                   F.pad(op.cols, (0, 0, 0, extra)))
    raise TypeError(f"no sharded form of {type(op).__name__}")


def _pad_inverse_rows_to(inv, n_pad: int):
    """A full-space device ``Inverse`` with its diagonal padded to the
    padded row space: matrix-free diagonals with ones (harmless divisions
    of zero inputs), a diagonal inverse's values with zeros.  Its operator
    is sharded by ``_shard_inverse``."""
    from ..inverse.build import Inverse

    diag = inv.diag
    if diag is not None and diag.shape[0] < n_pad:
        fill = 0.0 if inv.kind == "diagonal" else 1.0
        diag = torch.cat([diag, diag.new_full((n_pad - diag.shape[0],),
                                              fill)])
    return Inverse(inv.kind, mat=inv.mat, coefficients=inv.coefficients,
                   steps=inv.steps, diag=diag, scaled=inv.scaled)


def _shard_op(op, mesh: Mesh, n_pad: int, label: str = "",
              active: int | None = None):
    """A device operator on the padded row space, cut into shard blocks on
    its device: ``HaloELL`` (neighbour exchanges) where the partition is
    banded, else row-sharded against the all-gathered vector."""
    from .halo import HaloELL, RowShardedOp

    if active is None:
        active = _active(op.shape[0], n_pad, mesh)
    M = _pad_op_rows_to(op, n_pad)
    try:
        return HaloELL.from_op(M, mesh, label, active)
    except ValueError:
        return RowShardedOp.from_op(M, mesh, label, active)


def _kind_of(op) -> str:
    from ..sparse import ELL, TELL
    from ..sparse.banded import BandedSpMV
    from ..sparse.dell import DELL
    from ..sparse.dia import DIA

    for cls, kind in ((DIA, "dia"), (BandedSpMV, "banded"), (TELL, "tell"),
                      (ELL, "ell"), (DELL, "dell")):
        if isinstance(op, cls):
            return kind
    raise TypeError(f"no sharded form of {type(op).__name__}")


def _shard_inverse(inv, shard, label: str = ""):
    """A padded full-space ``Inverse`` with its operator sharded by
    ``shard`` (the level's memo of sharded operators: a matrix-free
    inverse shares the level's A_ff)."""
    from ..inverse.build import Inverse

    mat = inv.mat
    if inv.kind != "dense" and mat is not None:
        mat = shard(mat, label)
    return Inverse(inv.kind, mat=mat, coefficients=inv.coefficients,
                   steps=inv.steps, diag=inv.diag, scaled=inv.scaled)


def agglomeration_schedule(hierarchy, sizes, n_dev: int, opts) -> list:
    """The active shards of each level (reference:
    src/AIR_MG_Setup.F90:645-907, Repartition.F90): the rows-per-shard
    limit first, then the local/non-local nnz ratio of each host level
    matrix still held, then made non-increasing toward coarse levels."""
    from .repartition import (active_shards_schedule,
                              local_nonlocal_nnz_ratio, should_agglomerate)

    if opts is None or not opts.processor_agglom:
        return [n_dev] * len(sizes)
    factor = opts.processor_agglom_factor
    schedule = active_shards_schedule(sizes, n_dev, opts.process_eq_limit,
                                      factor)
    for i, lvl in enumerate(hierarchy.levels):
        A_host = getattr(lvl, "A", None)    # None on a device-built level
        if not sp.issparse(A_host) or schedule[i] <= 1:
            continue
        r = local_nonlocal_nnz_ratio(A_host, schedule[i])
        if should_agglomerate(sizes[i], schedule[i], r,
                              opts.process_eq_limit,
                              opts.processor_agglom_ratio):
            schedule[i] = max(1, schedule[i] // factor)
    for i in range(1, len(schedule)):
        schedule[i] = min(schedule[i], schedule[i - 1])
    return schedule


def shard_hierarchy(hierarchy, mesh: Mesh, options=None, device_form=None,
                    dtype=torch.float64):
    """Shard each level of a hierarchy over the mesh following the
    processor-agglomeration schedule (reference:
    src/AIR_MG_Setup.F90:645-907, Repartition.F90).  A level keeps
    ``active <= S`` shards; its rows pad to ``S`` blocks of
    ``ceil(n / active)``, so only the active shards own data, and every
    operator takes ``HaloELL`` where its partition is banded (each shard
    on the container the serial level uses: DIA, banded or TELL).  A
    one-shard level, and every level of the full-smoothing form, stays
    whole (the subcomm analogue).  ``device_form``: the hierarchy's
    ``DeviceHierarchy`` on the mesh's device (default: built here in
    ``dtype``).  Returns (levels, coarse inverse, schedule)."""
    opts = options if options is not None else getattr(hierarchy, "options",
                                                       None)
    if device_form is None:
        device_form = hierarchy.to(mesh.device, dtype)
    elif device_form.coarse_inv.coefficients is not None and (
            tensor_device(device_form.coarse_inv.coefficients.device)
            != tensor_device(mesh.device)):
        raise ValueError("the device form lies on another device than the "
                         "mesh's controller")
    n_dev = mesh.size
    dev_levels = device_form.levels
    sizes = [int(lvl["mask_f"].shape[0]) if "mask_f" in lvl
             else int(lvl["A"].shape[0]) for lvl in dev_levels]
    schedule = agglomeration_schedule(hierarchy, sizes, n_dev, opts)
    # each level's padded row space, None where the level stays whole
    pads = [-(-n // active) * n_dev if active > 1 and "mask_f" in lvl
            else None for lvl, n, active in zip(dev_levels, sizes, schedule)]
    out_levels = []
    for i, (lvl, n, active) in enumerate(zip(dev_levels, sizes, schedule)):
        if pads[i] is None:
            out_levels.append(lvl)      # whole, on the controller device
            continue
        n_pad = pads[i]
        memo = {}

        def shard(op, label, n_pad=n_pad, memo=memo, active=active):
            if id(op) not in memo:
                memo[id(op)] = _shard_op(op, mesh, n_pad, label, active)
            return memo[id(op)]

        new = {}
        for key, val in lvl.items():
            label = f"level {i} {key}"
            if key in ("mask_f", "mask_c"):
                new[key] = _fit(val.to(mesh.device), n_pad)
                if mesh.split:
                    new[key] = split_rows(new[key], mesh, label)
            elif key == "coarse" and mesh.split:
                new[key] = CoarseMap(mesh, val.cpu().numpy(), n_pad,
                                     pads[i + 1] if i + 1 < len(pads)
                                     else None, label)
            elif key == "coarse":
                new[key] = val.to(mesh.device)
            elif key.startswith("inv_"):
                new[key] = _shard_inverse(_pad_inverse_rows_to(val, n_pad),
                                          shard, label)
                if mesh.split:
                    new[key] = _split_inverse(new[key], mesh, label)
            else:
                new[key] = shard(val, label)
        out_levels.append(new)
    return out_levels, device_form.coarse_inv, schedule


def _split_inverse(inv, mesh: Mesh, label: str = ""):
    """A sharded ``Inverse`` on a split mesh: its padded diagonal as
    ``Rows`` and its coefficients replicated on every device."""
    from ..inverse.build import Inverse

    coeffs = inv.coefficients
    if coeffs is not None:
        coeffs = Replicated([coeffs.to(g.device) for g in mesh.groups])
    diag = inv.diag
    if diag is not None:
        diag = split_rows(diag, mesh, label)
    return Inverse(inv.kind, mat=inv.mat, coefficients=coeffs,
                   steps=inv.steps, diag=diag, scaled=inv.scaled)
