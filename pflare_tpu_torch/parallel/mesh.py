"""The row mesh: domain decomposition over matrix rows.

Ported from ``pflare_tpu.parallel.mesh``.  The reference's only
parallelism is row distribution over MPI ranks (SURVEY.md §2.4,
src/PMISR_Module.F90:174-180); the JAX package maps it onto a 1-D device
mesh.  Here a ``Mesh`` is one controller's list of shards, each with a
``torch.device`` (repeats allowed: on one card every shard sits on
``cuda:0``):

  * a row-sharded vector is one tensor of the padded length ``S * w`` on
    the mesh's device, shard s owning rows ``[s*w, (s+1)*w)``;
  * a row-sharded operator holds one local operator per active shard
    (``parallel/halo.py``): ``HaloELL`` when the partition is banded (each
    shard reads its extended window, filled by two neighbour exchanges),
    ``RowShardedOp`` otherwise (each shard reads the all-gathered vector);
  * every exchange is counted in the mesh's communication log, calls and
    bytes by operator label and kind (``ppermute``, ``all_gather``), where
    the JAX package's tests read the collectives of the compiled HLO.

Shards on different devices are not implemented: the exchanges would copy
between devices, and this code raises ``NotImplementedError`` instead of
copying through the host.  Shard agglomeration (src/Repartition.F90)
keeps ``active <= S`` shards on coarse levels: their rows pad to equal
blocks, so trailing shards own only padding and launch nothing.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

ROW_AXIS = "rows"


class Mesh:
    """A 1-D mesh of ``len(devices)`` row shards and its communication
    log (``log[(label, kind)] = [calls, bytes]``)."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.log = defaultdict(lambda: [0, 0])

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every shard sits on."""
        if len(set(self.devices)) > 1:
            raise NotImplementedError(
                "shards on more than one device: the exchanges would copy "
                "between devices, which this mesh does not implement")
        return self.devices[0]

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
        exchanges (the reference's ``ppermute`` shifts)."""
        S = blocks.shape[0]
        fwd = [(i, i + 1) for i in range(S - 1)]    # from the left
        bwd = [(i + 1, i) for i in range(S - 1)]    # from the right
        left, right = [blocks], [blocks]
        for _ in range(depth):
            left.insert(0, self.ppermute(left[0], fwd, label))
            right.append(self.ppermute(right[-1], bwd, label))
        return torch.cat(left[:-1] + [blocks] + right[1:], dim=1)

    def all_gather(self, x, label: str = ""):
        """A row-sharded tensor, whole on every shard: on one device the
        tensor itself, counted as each shard receiving the others'
        blocks."""
        self._check(x)
        self.record(label, "all_gather",
                    x.numel() * x.element_size() * (self.size - 1))
        return x

    def _check(self, t):
        if t.device != self.device:
            raise NotImplementedError(
                f"a tensor on {t.device}, the mesh's shards on "
                f"{self.device}: placing shards across devices is not "
                "implemented")


def make_mesh(n_devices: int | None = None, devices=None,
              device="cuda") -> Mesh:
    """A row mesh.  With ``devices`` the shards sit on those; otherwise
    ``n_devices`` shards (default: the number of visible devices of the
    type of ``device``) all sit on ``device``, as the CPU tests put 8
    shards on "cpu" and the card 4 on "cuda:0".  Without a card
    ``device="cuda"`` raises."""
    if devices is not None:
        return Mesh(devices)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device='cuda'): no CUDA device; "
                               "pass device='cpu' for a CPU mesh")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        visible = torch.cuda.device_count()
    else:
        visible = 1
    return Mesh([dev] * (visible if n_devices is None else int(n_devices)))


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
    """x on the mesh's device, zero-padded to a multiple of its size."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    if n % mesh.size and not pad:
        raise ValueError("length not divisible by mesh size")
    return _fit(x.to(mesh.device), padded_rows(n, mesh))


def replicate(tree, mesh: Mesh):
    """Every tensor and sparse container (anything with ``.to(device)``)
    of a nested dict/list on the mesh's device."""
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    if hasattr(tree, "to"):
        return tree.to(mesh.device)
    return tree


def shard_ell(A, mesh: Mesh, pad: bool = True):
    """An ``ELL`` row-sharded over the mesh (one ELL block per shard, read
    against the all-gathered vector); rows that do not divide the mesh
    pad with empty rows, which give 0."""
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
            device_form.coarse_inv.coefficients.device != mesh.device):
        raise NotImplementedError("the device form lies on another device "
                                  "than the mesh's shards")
    n_dev = mesh.size
    dev_levels = device_form.levels
    sizes = [int(lvl["mask_f"].shape[0]) if "mask_f" in lvl
             else int(lvl["A"].shape[0]) for lvl in dev_levels]
    schedule = agglomeration_schedule(hierarchy, sizes, n_dev, opts)
    out_levels = []
    for i, (lvl, n, active) in enumerate(zip(dev_levels, sizes, schedule)):
        if active <= 1 or "mask_f" not in lvl:
            out_levels.append(lvl)      # whole, on the mesh's device
            continue
        w = -(-n // active)
        n_pad = w * n_dev
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
            elif key == "coarse":
                new[key] = val.to(mesh.device)
            elif key.startswith("inv_"):
                new[key] = _shard_inverse(_pad_inverse_rows_to(val, n_pad),
                                          shard, label)
            else:
                new[key] = shard(val, label)
        out_levels.append(new)
    return out_levels, device_form.coarse_inv, schedule
