"""Shard agglomeration and graph-aware coarse-level repartition, on the
host.

Reference: src/Repartition.F90 and src/C_PETSc_Routines.c:17-175, ported
from ``pflare_tpu.parallel.repartition``.  On coarse levels the
communication to computation ratio degrades, so the reference reduces the
active ranks by ``processor_agglom_factor`` whenever the rows per rank
fall below ``process_eq_limit`` or the local/non-local nnz ratio below
``processor_agglom_ratio``, and repartitions.  On a row mesh that is the
number of shards that stay active on each level, which own contiguous
row blocks (the reference's partitioner-free 'simple' interleaving).

A row partition needs only neighbour exchanges when the operator is
banded for the block width, so partition quality reduces to bandwidth,
and reverse Cuthill-McKee is the partitioner.  The hierarchy applies it
under ``reorder="rcm"``/``"auto"``, on one device too, so that the port
builds the reference's hierarchies.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def local_nonlocal_nnz_ratio(A: sp.csr_matrix, n_shards: int) -> float:
    """The mean over shards of (nnz inside the shard's diagonal block) /
    (nnz outside it), rows split into ``n_shards`` contiguous blocks
    (reference: src/Repartition.F90:24-60)."""
    A = sp.csr_matrix(A)
    n = A.shape[0]
    bounds = np.linspace(0, n, n_shards + 1).astype(np.int64)
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    shard_of_row = np.searchsorted(bounds, rows, side="right") - 1
    shard_of_col = np.searchsorted(bounds, A.indices, side="right") - 1
    local = shard_of_row == shard_of_col
    ratios = []
    for s in range(n_shards):
        mask = shard_of_row == s
        nl = int((mask & local).sum())
        nn = int((mask & ~local).sum())
        ratios.append(nl / max(nn, 1))
    return float(np.mean(ratios))


def should_agglomerate(n_rows: int, n_shards: int, nnz_ratio: float,
                       process_eq_limit: int,
                       processor_agglom_ratio: float) -> bool:
    """The agglomeration trigger (reference:
    src/AIR_MG_Setup.F90:645-700)."""
    if n_shards <= 1:
        return False
    return (n_rows / n_shards < process_eq_limit
            or nnz_ratio < processor_agglom_ratio)


def active_shards_schedule(level_sizes, n_shards: int,
                           process_eq_limit: int = 50,
                           processor_agglom_factor: int = 2):
    """The shards that stay active on each level (non-increasing): divided
    by the agglomeration factor while the rows per shard fall below
    ``process_eq_limit``."""
    schedule = []
    active = n_shards
    for n in level_sizes:
        while active > 1 and n / active < process_eq_limit:
            active = max(1, active // processor_agglom_factor)
        schedule.append(active)
    return schedule


def interleaved_partition(n_rows: int, active: int) -> np.ndarray:
    """Row -> shard map: contiguous blocks over the ``active`` shards (the
    reference's 'simple' repartition, src/Repartition.F90:69-110)."""
    bounds = np.linspace(0, n_rows, active + 1).astype(np.int64)
    out = np.zeros(n_rows, dtype=np.int32)
    for s in range(active):
        out[bounds[s]: bounds[s + 1]] = s
    return out


def coarse_repartition_perm(A_c: sp.csr_matrix, min_rows: int = 256,
                            check_shards: int = 8) -> np.ndarray | None:
    """An RCM permutation of the coarse operator when (a) its natural order
    is not banded for ``check_shards`` equal row blocks and (b) RCM makes
    it so, or at least halves its bandwidth; None otherwise (structured
    levels keep their order)."""
    A_c = sp.csr_matrix(A_c)
    n = A_c.shape[0]
    if n < min_rows or A_c.nnz == 0:
        return None
    rows = np.repeat(np.arange(n), np.diff(A_c.indptr))
    bw_nat = int(np.abs(A_c.indices - rows).max())
    w = -(-n // check_shards)
    if bw_nat <= w:
        return None
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    pat = sp.csr_matrix((np.ones(A_c.nnz), A_c.indices, A_c.indptr),
                        shape=A_c.shape)
    pat = sp.csr_matrix(pat + pat.T)
    perm = np.asarray(reverse_cuthill_mckee(pat, symmetric_mode=True),
                      dtype=np.int64)
    ip = np.empty_like(perm)
    ip[perm] = np.arange(n)
    bw_rcm = int(np.abs(ip[A_c.indices] - ip[rows]).max())
    if not (bw_rcm <= w or bw_rcm * 2 <= bw_nat):
        return None
    return perm
