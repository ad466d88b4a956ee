"""Device CF splitting: PMISR Luby rounds over a padded neighbour array.

Ported from ``pflare_tpu.cf.device`` (the parity item for the reference's
Kokkos splitting, src/PMISR_Modulek.kokkos.cxx): the symmetric strength
graph lives on the device as padded ``[n, K]`` arrays and each Luby round
is a few gathers and row reductions.  Returns the markers the host
``pmisr`` gives for the same measure.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..params import C_POINT, F_POINT
from ..sparse.dell import PADCOL


def graph_to_device(S_sym: sp.csr_matrix, device="cuda"):
    """Symmetric strength graph -> (cols [n, K] int32, mask [n, K] bool)
    on ``device``."""
    S = sp.csr_matrix(S_sym)
    S.sort_indices()
    n = S.shape[0]
    row_len = np.diff(S.indptr)
    K = max(int(row_len.max()) if S.nnz else 1, 1)
    cols = np.zeros((n, K), dtype=np.int32)
    mask = np.zeros((n, K), dtype=bool)
    rows = np.repeat(np.arange(n), row_len)
    offs = np.arange(S.nnz) - np.repeat(S.indptr[:-1], row_len)
    cols[rows, offs] = S.indices.astype(np.int32)
    mask[rows, offs] = True
    return (torch.from_numpy(cols).to(device),
            torch.from_numpy(mask).to(device))


def luby_rounds(gcols, measure, cf0, n_rounds: int, pmis: bool = False,
                zero_measure_c_point: bool = False, mesh=None):
    """PMISR/PMIS Luby rounds over a padded symmetric graph (dead slots
    ``PADCOL``), a fixed number of them with no host read: a round that
    adds no node changes nothing, so the reference's early stop gives the
    same markers.  PMIS passes a negated measure and the caller flips the
    markers; the zero-measure value follows the host's pre-flip
    convention (reference: src/PMISR_Module.F90:398-437).  Nodes left
    undecided become C.  With a row ``mesh`` each device decides the rows
    of its own shards (``ceil(n / S)`` a shard) from its copy of the
    whole graph's state, one all-gather of the new set and one of the
    decided nodes a round onto every device, as the reference compiles
    the rounds SPMD over its mesh (pflare_tpu/cf/splitting.py:114-152);
    every decision reads only its row, so the markers are the same.  The
    markers are kept on the controller device."""
    n = measure.shape[0]
    if mesh is None:
        spans = [slice(0, n)]

        def gathered(parts):
            return parts

        def put(t, g):
            return t
    else:
        w = -(-n // mesh.size)
        spans = [slice(min(g.start * w, n), min(g.stop * w, n))
                 for g in mesh.groups]

        def gathered(parts):
            return mesh.all_gather(parts, "luby")

        def put(t, g):
            return mesh._to_group(t, 0, g, "luby")

    cf, assigned = _start(measure, cf0, pmis, zero_measure_c_point)
    assigned = [put(assigned, g) for g in range(len(spans))]
    # each device's rows of the graph and its copy of the measure
    mask, safe, beats = [], [], []
    for g, r in enumerate(spans):
        g_r = put(gcols[r], g)
        s_r = torch.clamp(g_r, max=n - 1).long()
        mask.append(g_r < PADCOL)
        safe.append(s_r)
        beats.append(_beats(put(measure, g), r, s_r))
    for _ in range(n_rounds):
        in_set = gathered([
            ~a[r] & ~(mk & ~a[sf] & b).any(dim=1)
            for r, a, mk, sf, b in zip(spans, assigned, mask, safe, beats)])
        cf = torch.where(in_set[0], F_POINT, cf)
        # neighbours of the new set are decided (C at the end); the
        # graph is symmetric, so a gather doubles as the scatter
        assigned = gathered([
            a[r] | s[r] | (mk & s[sf]).any(dim=1)
            for r, a, s, mk, sf in zip(spans, assigned, in_set, mask, safe)])
    return torch.where(cf == 0, C_POINT, cf)


def _start(measure, cf0, pmis: bool, zero_measure_c_point: bool):
    """The markers and decided nodes before the first round: the nodes
    of zero measure take their value at once."""
    cf = cf0.to(torch.int32)
    assigned = cf != 0
    zero_nodes = ~assigned & (measure.abs() < 1)
    if zero_measure_c_point:
        zero_val = F_POINT if pmis else C_POINT
    else:
        zero_val = C_POINT if pmis else F_POINT
    return torch.where(zero_nodes, zero_val, cf), assigned | zero_nodes


def _beats(measure, rows: slice, safe):
    """Whether each node of ``rows`` beats each of its neighbours
    (``safe``, their indices): a larger measure, ties to the larger
    index."""
    mine = measure[rows, None]
    idx = torch.arange(rows.start, rows.stop, device=measure.device)
    return (mine > measure[safe]) | ((mine == measure[safe])
                                     & (idx[:, None] > safe))


def pmisr_device(cols, mask, measure, cf0, max_luby_steps: int = 3,
                 zero_measure_c_point: bool = False, pmis: bool = False):
    """PMISR Luby rounds on the device.

    cols/mask: padded neighbour arrays of the symmetric strength graph;
    measure: [n] float (random + degree, negated for PMIS by the caller);
    cf0: [n] initial markers (0 = undecided).  ``max_luby_steps`` <= 0
    means "until every node is decided", capped at 64 rounds (Luby ends
    in O(log n) rounds with high probability); nodes left undecided
    become C, as in the fixed-step reference mode."""
    gcols = torch.where(mask, cols, PADCOL)
    return luby_rounds(gcols, measure, cf0,
                       max_luby_steps if max_luby_steps > 0 else 64,
                       pmis=pmis, zero_measure_c_point=zero_measure_c_point)


def pmisr_on_device(S: sp.csr_matrix, max_luby_steps: int = 3,
                    pmis: bool = False, seed: int = 5,
                    device="cuda") -> np.ndarray:
    """Device PMISR from a host strength matrix, whose pattern it
    symmetrises as the host path does."""
    G = sp.csr_matrix(S + S.T)
    G.sort_indices()
    cols, mask = graph_to_device(G, device)
    rng = np.random.default_rng(seed)
    measure = rng.random(S.shape[0]) + np.diff(S.indptr)
    if pmis:
        measure = -measure
    cf = pmisr_device(cols, mask,
                      torch.as_tensor(measure, dtype=torch.float64,
                                      device=device),
                      torch.zeros(S.shape[0], dtype=torch.int32,
                                  device=device),
                      max_luby_steps=max_luby_steps, pmis=pmis)
    cf = cf.cpu().numpy().astype(np.int64)
    return -cf if pmis else cf
