"""Distributed tall-skinny QR over the row mesh.

Ported from ``pflare_tpu.parallel.tsqr`` (reference: src/TSQR.F90, whose
custom non-commutative MPI reduction combines the per-rank R factors in a
log-depth tree, src/TSQR.F90:40-63, so the power-basis GMRES
coefficients cost one reduction).  Each shard QRs its own rows in f64 on
its device; the m x m factors then combine through a log-depth butterfly
-- at round d shard i takes shard i^d's factor and QRs the [2m, m] stack,
the lower-index factor always on top -- so every shard holds the same R,
deterministically.  A mesh whose size is not a power of two restacks the
index-ordered all-gathered factors instead.  ``make_qr_reduce`` is the
``qr_reduce`` hook of ``coefficients_power``.
"""

from __future__ import annotations

import torch

from .mesh import padded_rows


def _r(M):
    return torch.linalg.qr(M, mode="r")[1]


def tsqr_r(K, mesh, label: str = "tsqr"):
    """R of the QR of K [n, m] row-sharded over the mesh (n a multiple of
    its size): local QRs, then the butterfly (or the all-gather restack),
    each exchange in the mesh's log under ``label``."""
    S = mesh.size
    K = torch.as_tensor(K, dtype=torch.float64, device=mesh.device)
    n, m = K.shape
    if n % S:
        raise ValueError("rows not divisible by mesh size")
    blocks = K.view(S, n // S, m)
    group = [mesh.group_of(s) for s in range(S)]
    parts = mesh.scatter(blocks, label)
    rs = [_r(parts[group[s]][s - mesh.groups[group[s]].start])[:m]
          for s in range(S)]               # min(n / S, m) rows each
    if S & (S - 1):
        nbytes = sum(r.numel() for r in rs) * rs[0].element_size()
        mesh.record(label, "all_gather", nbytes * (S - 1))
        return _r(torch.cat([mesh._to_group(r, group[s], 0, label)
                             for s, r in enumerate(rs)]))
    d = 1
    while d < S:
        mesh.record(label, "ppermute", S * rs[0].numel()
                    * rs[0].element_size())
        other = [mesh._to_group(rs[i ^ d], group[i ^ d], group[i], label)
                 for i in range(S)]
        rs = [_r(torch.cat([rs[i], other[i]] if i & d == 0
                           else [other[i], rs[i]]))[:m] for i in range(S)]
        d *= 2
    return rs[0]


def make_qr_reduce(mesh):
    """A ``qr_reduce`` for ``coefficients_power`` over the mesh: the basis
    columns (a list, or K itself) stacked, zero rows padding them to a
    multiple of the mesh's size (zero rows leave R unchanged), R read back
    as float64."""

    def qr_reduce(cols):
        if isinstance(cols, (list, tuple)):
            K = torch.stack([torch.as_tensor(c, dtype=torch.float64).to(
                mesh.device) for c in cols], dim=1)
        else:
            K = torch.as_tensor(cols, dtype=torch.float64).to(mesh.device)
        K = torch.cat([K, K.new_zeros((padded_rows(K.shape[0], mesh)
                                       - K.shape[0], K.shape[1]))])
        return tsqr_r(K, mesh).cpu().numpy()

    return qr_reduce
