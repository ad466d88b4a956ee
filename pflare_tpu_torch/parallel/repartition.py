"""Graph-aware coarse-level repartition, on the host.

Reference: src/C_PETSc_Routines.c:17-175 and src/Repartition.F90:69-110
(ParMETIS partitions each coarse grid onto the surviving ranks), ported
from ``pflare_tpu.parallel.repartition.coarse_repartition_perm``.  A row
partition needs only neighbour exchanges when the operator is banded for
the block width, so partition quality reduces to bandwidth, and reverse
Cuthill-McKee is the partitioner.  The hierarchy applies it under
``reorder="rcm"``/``"auto"``, on one device too, so that the port builds
the reference's hierarchies.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


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
