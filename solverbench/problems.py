"""The benchmark's own problem generators: frozen plain copies.

The operators every cell solves come from here and not from the program,
so that a later change to the program's generators cannot move the
yardstick.  Each function keeps the arithmetic of the function it was
copied from, in the same order, and gives the same matrix bit for bit
(``solverbench/tests/test_bench_problems.py`` holds them to the program's
at small sizes):

* ``adv_diff_2d``: ``pflare_tpu_torch/problems/generators.py::adv_diff_2d``
  at its defaults, the reference's ``adv_diff_fd`` (PFLARE
  tests/adv_diff_fd.c:366-494): 2D upwind advection, pure advection at
  theta = pi/4, non-dimensional, Dirichlet left and bottom, outflow top
  and right.
* ``mesh_tri``: ``chip_smoke.py::mesh_tri``, Delaunay triangles of a
  jittered grid in a seeded cell order.
* ``dg1_upwind_tri``: ``pflare_tpu_torch/problems/fem_dg.py::
  dg1_upwind_advection`` on triangles with the default unit velocity
  (1, 1)/sqrt(2): the reference's ``adv_dg_upwind`` at degree 1.

All return scipy CSR matrices in float64.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def adv_diff_2d(n: int) -> sp.csr_matrix:
    """The n x n grid's upwind advection operator (x fastest)."""
    nx = ny = n
    theta = np.pi / 4.0
    uc, vc = np.cos(theta), np.sin(theta)
    Hx = 1.0 / (nx - 1)
    Hy = 1.0 / (ny - 1)
    adv_x_scale, adv_y_scale = 1.0, Hy / Hx

    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny))
    ii = ii.ravel()
    jj = jj.ravel()
    row = jj * nx + ii
    u_loc = np.full(row.shape, float(uc))
    v_loc = np.full(row.shape, float(vc))
    mag = np.sqrt(u_loc**2 + v_loc**2)
    safe = mag > 1e-12
    u_loc = np.where(safe, u_loc / np.where(safe, mag, 1.0), u_loc)
    v_loc = np.where(safe, v_loc / np.where(safe, mag, 1.0), v_loc)

    dirichlet = (ii == 0) | (jj == 0)
    outflow = (~dirichlet) & ((ii == nx - 1) | (jj == ny - 1))
    interior = ~dirichlet & ~outflow

    rows_l, cols_l, vals_l = [], [], []

    def add(mask, dcol, val):
        rows_l.append(row[mask])
        cols_l.append(row[mask] + dcol)
        vals_l.append(np.broadcast_to(val, row[mask].shape))

    add(dirichlet, 0, 1.0)
    adv = interior | outflow
    add(adv, -nx, (-v_loc * adv_x_scale)[adv])
    add(adv, -1, (-u_loc * adv_y_scale)[adv])
    add(adv, 0, (u_loc * adv_y_scale + v_loc * adv_x_scale)[adv])

    A = sp.csr_matrix((np.concatenate(vals_l),
                       (np.concatenate(rows_l), np.concatenate(cols_l))),
                      shape=(nx * ny, nx * ny))
    A.sum_duplicates()
    A.eliminate_zeros()
    A.sort_indices()
    return A


def mesh_tri(m: int, seed: int = 0, jitter: float = 0.3):
    """Delaunay triangles of an (m+1)^2 grid on the unit square whose
    interior points are jittered by up to ``jitter`` of a spacing, in a
    seeded scrambled cell order: about 2 m^2 cells.  Returns (points
    [n, 2], cells [c, 3])."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    g = np.linspace(0.0, 1.0, m + 1)
    pts = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    inner = np.all((pts > 0) & (pts < 1), axis=1)
    pts[inner] += rng.uniform(-jitter, jitter, (inner.sum(), 2)) / m
    cells = Delaunay(pts).simplices.astype(np.int64)
    return pts, cells[rng.permutation(len(cells))]


_TRI_FACETS = ((0, 1), (1, 2), (2, 0))
_TRI_Q = (np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]]),
          np.full(3, 1 / 6))
_SEG_P = 0.5 + np.array([-1, 1]) * (0.5 / np.sqrt(3.0))
_SEG_Q = (_SEG_P.reshape(-1, 1), np.array([0.5, 0.5]) * 1.0)


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
    """The default unit velocity (1, 1)/sqrt(2) at m points, [m, 2]."""
    v = np.array([1.0, 1.0, 0.0])
    v = v / np.linalg.norm(v[:2])
    return np.ascontiguousarray(np.broadcast_to(v, (m, 3)))[:, :2]


def dg1_upwind_tri(points, cells) -> sp.csr_matrix:
    """DG(1) upwind advection on triangles: three nodal DoFs a cell, the
    volume term -int_K u (v . grad w), the upwind flux on interior and
    outflow facets, inflow facets weak Dirichlet (right-hand side only)."""
    points = np.asarray(points, dtype=np.float64)
    if points.shape[1] == 2:
        points = np.hstack([points, np.zeros((len(points), 1))])
    cells = np.asarray(cells, dtype=np.int64)
    nb = 3
    dim = 2
    qp, qw = _TRI_Q
    n_cells = len(cells)
    ndof = n_cells * nb

    # volume terms
    x, y = qp[:, 0], qp[:, 1]
    N = np.stack([1 - x - y, x, y], axis=1)
    dN = np.broadcast_to(
        np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]]), (len(qp), 3, 2))
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
    loc = np.asarray(_TRI_FACETS, dtype=np.int64)
    cm, lfm, cp = _match_facets(cells, loc)
    fverts = cells[cm[:, None], loc[lfm]]
    n_f, k = fverts.shape
    fq, fw = _SEG_Q
    Nf = np.stack([1 - fq[:, 0], fq[:, 0]], axis=1)
    xf = points[fverts][:, :, :dim]
    X = np.matmul(Nf, xf)
    e = xf[:, 1] - xf[:, 0]
    nrm = np.stack([e[:, 1], -e[:, 0]], axis=1)
    nds = fw[None, :, None] * nrm[:, None, :]
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


def dg1_upwind_tri_mesh(m: int, mesh_seed: int = 0,
                        jitter: float = 0.3) -> sp.csr_matrix:
    """``dg1_upwind_tri`` on ``mesh_tri(m, mesh_seed, jitter)``."""
    pts, cells = mesh_tri(m, mesh_seed, jitter)
    return dg1_upwind_tri(pts, cells)


# a configuration's "problem": {"generator": <name>, "args": {...}}
GENERATORS = {"adv_diff_2d": adv_diff_2d,
              "dg1_upwind_tri_mesh": dg1_upwind_tri_mesh}
