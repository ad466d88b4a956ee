"""Root-node aggregation CF splitting, on one shard.

Reference: src/Aggregation.F90 (PyAMG-style three-step aggregation),
ported from ``pflare_tpu.cf.aggregation``: roots become C and their strong
neighbours F; unassigned nodes join a neighbouring aggregate; remnants
seed new aggregates.  The sweeps are sequential and order-dependent; they
run in the native host kernel, or in the numpy loop below, which gives the
same markers.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..params import C_POINT, F_POINT


def serial_aggregation(strength_mat, cf_markers: np.ndarray | None = None):
    """Returns (cf_markers, aggregates)."""
    S = sp.csr_matrix(strength_mat)
    S.sort_indices()
    n = S.shape[0]
    if cf_markers is None:
        cf = np.zeros(n, dtype=np.int64)
        aggregates = np.zeros(n, dtype=np.int64)
    else:
        cf = np.asarray(cf_markers, dtype=np.int64).copy()
        aggregates = np.where(cf != 0, -1, 0).astype(np.int64)
    indptr, indices = S.indptr, S.indices

    from ..native import aggregation_native

    cf = np.ascontiguousarray(cf)
    aggregates = np.ascontiguousarray(aggregates)
    if aggregation_native(indptr, indices, cf, aggregates) is not None:
        return cf, aggregates

    aggregate = 1
    # step 1: initial covering
    for i in range(n):
        nbrs = indices[indptr[i]: indptr[i + 1]]
        if len(nbrs) == 0:
            cf[i] = F_POINT
            continue
        if cf[i] != 0 or np.any(cf[nbrs] != 0):
            continue
        cf[i] = C_POINT
        aggregates[i] = aggregate
        cf[nbrs] = F_POINT
        aggregates[nbrs] = aggregate
        aggregate += 1

    # step 2: enlarge, joining the first strongly connected aggregate
    for i in range(n):
        if cf[i] != 0:
            continue
        nbrs = indices[indptr[i]: indptr[i + 1]]
        joined = nbrs[aggregates[nbrs] > 0]
        if len(joined) > 0:
            cf[i] = F_POINT
            aggregates[i] = -aggregates[joined[0]]
            aggregate += 1

    aggregates = np.abs(aggregates)

    # step 3: remnants become new roots
    for i in range(n):
        if cf[i] != 0:
            continue
        nbrs = indices[indptr[i]: indptr[i + 1]]
        cf[i] = C_POINT
        aggregates[i] = aggregate
        un = nbrs[cf[nbrs] == 0]
        cf[un] = F_POINT
        aggregates[un] = aggregate
        aggregate += 1

    return cf, aggregates
