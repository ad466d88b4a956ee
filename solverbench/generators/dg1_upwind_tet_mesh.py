"""DG(1) upwind advection on unstructured tetrahedra: a frozen plain copy.

The operator of the configuration ``dg1_upwind_tet``, made here and not by
the program, so that a later change to the program's generators cannot
move the yardstick.  Each function keeps the arithmetic of the function
it was copied from, in the same order, and gives the same matrix bit for
bit (``solverbench/tests/test_bench_tet.py`` holds it to the program's at
small sizes):

* ``mesh_tet``: ``tests/torch_cases.py::tet_mesh`` (Delaunay tetrahedra
  of a jittered grid on the unit cube, the flat boundary tets dropped),
  then the cells in a seeded scrambled order, as ``problems.py::mesh_tri``
  orders the triangles;
* ``dg1_upwind_tet``: the tetrahedral branch of
  ``pflare_tpu_torch/problems/fem_dg.py::dg1_upwind_advection`` with the
  default unit velocity (1, 1, 1)/sqrt(3): the reference's
  ``adv_dg_upwind`` (PFLARE tests/adv_dg_upwind.c) at degree 1 in 3-D.

Imports numpy and scipy only.  Returns a scipy CSR matrix in float64.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

# the tetrahedron's facets, each a triangle of local vertices
_TET_FACETS = ((1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1))
# degree-2 exact volume quadrature on the reference tetrahedron
_TET_Q_A = (5 - np.sqrt(5.0)) / 20
_TET_Q_B = (5 + 3 * np.sqrt(5.0)) / 20
_TET_Q = (np.array([[_TET_Q_A] * 3,
                    [_TET_Q_B, _TET_Q_A, _TET_Q_A],
                    [_TET_Q_A, _TET_Q_B, _TET_Q_A],
                    [_TET_Q_A, _TET_Q_A, _TET_Q_B]]),
          np.full(4, 1 / 24))
# facet quadrature on the reference triangle (weights sum to 1/2)
_FTRI_Q = (np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]]),
           np.full(3, 1 / 6))


def mesh_tet(m: int, seed: int = 0, jitter: float = 0.2):
    """Delaunay tetrahedra of an (m+1)^3 grid on the unit cube whose
    interior points are jittered by up to ``jitter`` of a spacing, without
    the flat tets that coplanar boundary points give, in a seeded
    scrambled cell order: about 6.9 m^3 cells.  Returns (points [n, 3],
    cells [c, 4])."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    g = np.linspace(0.0, 1.0, m + 1)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    inner = np.all((pts > 0) & (pts < 1), axis=1)
    pts[inner] += rng.uniform(-jitter, jitter, (inner.sum(), 3)) / m
    cells = Delaunay(pts).simplices.astype(np.int64)
    e = pts[cells[:, 1:]] - pts[cells[:, :1]]
    vol = np.abs(np.linalg.det(e)) / 6
    cells = cells[vol > 1e-6 / m ** 3]
    return pts, cells[rng.permutation(len(cells))]


def _rowdot(a, b):
    """Row-wise dot products of two [m, d] arrays by BLAS's ddot."""
    a = np.ascontiguousarray(a, dtype=np.float64)
    b = np.ascontiguousarray(b, dtype=np.float64)
    return np.matmul(a[:, None, :], b[:, :, None])[:, 0, 0]


def _match_facets(cells, local_facets):
    """Pair the cells' facets by their sorted vertex keys: (cell and local
    facet of each facet's first sighting, the neighbour or -1); interior
    facets in the order of their second sighting, then boundary facets in
    the order they were last seen."""
    loc = np.asarray(local_facets, dtype=np.int64)
    n_cells, nf = len(cells), len(loc)
    keys = np.sort(cells[:, loc].reshape(n_cells * nf, -1), axis=1)
    order = np.lexsort(keys.T[::-1])
    sk = keys[order]
    new = np.ones(len(order), dtype=bool)
    new[1:] = np.any(sk[1:] != sk[:-1], axis=1)
    start = np.flatnonzero(new)
    size = np.diff(np.append(start, len(order)))
    rank = np.arange(len(order)) - np.repeat(start, size)
    last = rank == np.repeat(size, size) - 1
    second = (rank % 2 == 1)
    lone = (rank % 2 == 0) & last
    first_of = order[np.flatnonzero(second) - 1]
    second_of = order[second]
    pairs = np.argsort(second_of, kind="stable")
    first_of, second_of = first_of[pairs], second_of[pairs]
    lone_of = np.sort(order[lone])
    owner = np.concatenate([first_of, lone_of])
    cp = np.concatenate([second_of // nf,
                         np.full(len(lone_of), -1, dtype=np.int64)])
    return owner // nf, owner % nf, cp


def _velocity(m):
    """The default unit velocity (1, 1, 1)/sqrt(3) at m points, [m, 3]."""
    v = np.ones(3)
    v = v / np.linalg.norm(v)
    return np.ascontiguousarray(np.broadcast_to(v, (m, 3)))


def dg1_upwind_tet(points, cells) -> sp.csr_matrix:
    """DG(1) upwind advection on tetrahedra: four nodal DoFs a cell, the
    volume term -int_K u (v . grad w), the upwind flux on interior and
    outflow facets, inflow facets weak Dirichlet (right-hand side only)."""
    points = np.asarray(points, dtype=np.float64)
    cells = np.asarray(cells, dtype=np.int64)
    nb = 4
    dim = 3
    qp, qw = _TET_Q
    n_cells = len(cells)
    ndof = n_cells * nb

    # volume terms
    x, y, z = qp[:, 0], qp[:, 1], qp[:, 2]
    N = np.stack([1 - x - y - z, x, y, z], axis=1)
    dN = np.broadcast_to(
        np.array([[-1.0, -1.0, -1.0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
                 dtype=np.float64), (len(qp), 4, 3))
    Xc = points[cells][:, :, :dim]
    Ke = np.zeros((n_cells, nb, nb))
    for q in range(len(qw)):
        if q == 0:
            J = np.matmul(dN[q].T, Xc)
            detJ = np.abs(np.linalg.det(J))
            gradN = np.matmul(dN[q], np.linalg.inv(J.transpose(0, 2, 1)))
        v = _velocity(len(Xc))
        gv = np.matmul(gradN, np.ascontiguousarray(v)[:, :, None])[:, :, 0]
        Ke -= (qw[q] * detJ)[:, None, None] * (
            gv[:, :, None] * N[q][None, None, :])
    c, i, j = np.nonzero(Ke)
    rows, cols, vals = [c * nb + i], [c * nb + j], [Ke[c, i, j]]
    del Ke

    # facet terms
    loc = np.asarray(_TET_FACETS, dtype=np.int64)
    cm, lfm, cp = _match_facets(cells, loc)
    fverts = cells[cm[:, None], loc[lfm]]
    n_f, k = fverts.shape
    fq, fw = _FTRI_Q
    Nf = np.stack([1 - fq[:, 0] - fq[:, 1], fq[:, 0], fq[:, 1]], axis=1)
    xf = points[fverts][:, :, :dim]
    X = np.matmul(Nf, xf)
    # the cross product of the parametrisation's tangents carries the
    # facet's area
    dNf = np.broadcast_to(np.array([[-1.0, -1.0], [1, 0], [0, 1]]),
                          (len(fq), 3, 2))
    nds = np.empty((n_f, len(fq), 3))
    for iq in range(len(fq)):
        T = np.matmul(dNf[iq].T, xf)
        nds[:, iq] = fw[iq] * np.cross(T[:, 0], T[:, 1])
    interior = cp >= 0
    cpi = np.where(interior, cp, cm)
    loc_m = loc[lfm]
    loc_p = np.argmax(cells[cpi][:, None, :] == fverts[:, :, None], axis=2)
    cent = points[cells[cm]][:, :, :dim].mean(axis=1)

    bn = np.empty((n_f, len(fq)))
    for iq in range(len(fq)):
        nrm = np.ascontiguousarray(nds[:, iq])
        flip = _rowdot(nrm, X[:, iq] - cent) < 0
        nrm[flip] = -nrm[flip]
        bn[:, iq] = _rowdot(_velocity(n_f), nrm)
    minus = (bn >= 0) | ~interior[:, None]
    keep = interior[:, None] | (bn >= 0)
    up_cell = np.where(minus, cm[:, None], cpi[:, None])
    up_loc = np.where(minus[:, :, None], loc_m[:, None, :],
                      loc_p[:, None, :])
    col = (up_cell[:, :, None] * nb + up_loc)[:, :, :, None, None]
    side_cell = np.stack([cm, cpi], axis=1)
    side_loc = np.stack([loc_m, loc_p], axis=1)
    row = (side_cell[:, :, None] * nb + side_loc)[:, None, None, :, :]
    sbn = np.stack([bn, -bn], axis=2)
    phi = Nf[None, :, :]
    val = ((sbn[:, :, None, :] * phi[:, :, :, None])[:, :, :, :, None]
           * phi[:, :, None, None, :])
    ok = (keep[:, :, None, None, None]
          & np.stack([np.ones(n_f, bool), interior], axis=1)
          [:, None, None, :, None])
    shape = (n_f, len(fq), k, 2, k)
    ok = np.broadcast_to(ok, shape)
    rows.append(np.broadcast_to(row, shape)[ok])
    cols.append(np.broadcast_to(col, shape)[ok])
    vals.append(val[ok])

    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(ndof, ndof))
    A.sum_duplicates()
    A.eliminate_zeros()
    A.sort_indices()
    return A


def generate(m: int, mesh_seed: int = 0,
             jitter: float = 0.2) -> sp.csr_matrix:
    """``dg1_upwind_tet`` on ``mesh_tet(m, mesh_seed, jitter)``."""
    pts, cells = mesh_tet(m, mesh_seed, jitter)
    return dg1_upwind_tet(pts, cells)
