"""SUPG-stabilised continuous-Galerkin advection-diffusion FEM.

The counterpart of ``pflare_tpu.problems.fem_supg``, the second of the
reference's unstructured FEM families (reference:
tests/adv_diff_cg_supg.c): steady  -alpha Lap(u) + v . grad(u) = f  with
linear CG elements on triangles/tets and streamline-upwind stabilisation

    tau_K = (h / 2|v|) (coth(Pe) - 1/Pe),   Pe = |v| h / (2 alpha),
    h = V_K^(1/d)

(reference: tests/adv_diff_cg_supg.c:89-119).  For P1 the SUPG residual
term reduces to tau (v.grad u)(v.grad w).  Dirichlet rows are eliminated
the way DMPlex essential BCs are: the assembled operator lives on the
free vertices only.  Boundary sides follow the reference's face-set
convention on the unit square/cube: pure advection constrains the inflow
sides (bottom+left in 2D; bottom+front+left in 3D), diffusive problems
constrain every side.

Batched over cells a quadrature point at a time, with the reference's
per-cell operations (see ``fem_dg``), so the matrices agree with it.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .fem_dg import (_TET_Q, _TRI_Q, _jacobians, _make_vel, _matvec,
                     _tet_shape, _tri_shape)
from .gmsh import as_points3, read_gmsh, rowdot


def _libm_pow(x, e):
    """x ** e elementwise by the C library's pow, as the reference's
    scalar ``**`` computes it (numpy's vectorised power rounds otherwise
    in the last place)."""
    return np.power(np.asarray(x, dtype=object), e).astype(np.float64)


def _tau(dim, h, alpha, v):
    """The SUPG parameter of each row: ``h`` [m], ``v`` [m, dim]."""
    vmag = np.sqrt(rowdot(v, v))
    moving = vmag >= 1e-12
    if alpha < 1e-12:
        xi = np.ones_like(vmag)
    else:
        pe = vmag * h / (2.0 * alpha)
        xi = np.ones_like(pe)
        small = pe < 1e-6
        mid = ~small & (pe <= 1e8)
        xi[small] = pe[small] / 3.0 - _libm_pow(pe[small], 3) / 45.0
        xi[mid] = 1.0 / np.tanh(pe[mid]) - 1.0 / pe[mid]
    tau = np.zeros_like(vmag)
    tau[moving] = (h[moving] / (2.0 * vmag[moving])) * xi[moving]
    return tau


def supg_advection_diffusion(points: np.ndarray, cells: np.ndarray,
                             alpha: float = 0.0, velocity=None,
                             unit_velocity: bool = True,
                             curved: bool = False,
                             return_free: bool = False):
    """Assembled SUPG CG operator on the free (non-Dirichlet) vertices.

    Returns the csr matrix (and the free-vertex index array when
    ``return_free``)."""
    points = as_points3(points)
    cells = np.asarray(cells, dtype=np.int64)
    nn = cells.shape[1]
    if nn == 3:
        dim, shape, (qp, qw) = 2, _tri_shape, _TRI_Q
    elif nn == 4:
        dim, shape, (qp, qw) = 3, _tet_shape, _TET_Q
    else:
        raise ValueError("SUPG assembly supports P1 triangles/tets")
    vel = _make_vel(dim, velocity, unit_velocity, curved)

    n_pts = len(points)
    lo = points[:, :dim].min(axis=0)
    hi = points[:, :dim].max(axis=0)
    tol = 1e-8 * np.max(hi - lo)
    # Dirichlet sides (reference face-set convention on the unit box):
    # pure advection -> inflow sides only; with diffusion -> all sides
    x, y = points[:, 0], points[:, 1]
    if alpha < 1e-12:
        dir_mask = (np.abs(y - lo[1]) < tol) | (np.abs(x - lo[0]) < tol)
        if dim == 3:
            dir_mask |= np.abs(points[:, 2] - lo[2]) < tol
    else:
        dir_mask = np.zeros(n_pts, dtype=bool)
        for d in range(dim):
            dir_mask |= (np.abs(points[:, d] - lo[d]) < tol)
            dir_mask |= (np.abs(points[:, d] - hi[d]) < tol)

    N, dN = shape(qp)
    Xc = points[cells][:, :, :dim]
    detJ, gradN = _jacobians(dN[0], Xc)      # affine: constant Jacobian
    vol = detJ * (0.5 if dim == 2 else 1.0 / 6.0)
    h = _libm_pow(vol, 1.0 / dim)
    stiff = alpha * np.matmul(gradN, gradN.transpose(0, 2, 1))
    Ke = np.zeros((len(cells), nn, nn))
    for q in range(len(qw)):
        v = vel(np.matmul(N[q], Xc))
        t = _tau(dim, h, alpha, v)
        gv = _matvec(gradN, v)               # v . grad(phi)
        w = qw[q] * detJ
        Ke += w[:, None, None] * (
            (stiff + N[q][None, :, None] * gv[:, None, :])
            + t[:, None, None] * (gv[:, :, None] * gv[:, None, :]))

    rows = np.broadcast_to(cells[:, :, None], Ke.shape).ravel()
    cols = np.broadcast_to(cells[:, None, :], Ke.shape).ravel()
    A = sp.csr_matrix((Ke.ravel(), (rows, cols)), shape=(n_pts, n_pts))
    A.sum_duplicates()
    free = np.nonzero(~dir_mask)[0]
    A = sp.csr_matrix(A[free][:, free])
    A.eliminate_zeros()
    A.sort_indices()
    return (A, free) if return_free else A


def supg_from_gmsh(path: str, alpha: float = 0.0, velocity=None,
                   unit_velocity: bool = True, curved: bool = False
                   ) -> sp.csr_matrix:
    """SUPG CG operator on a Gmsh mesh (the reference's
    adv_diff_cg_supg -dm_plex_filename family)."""
    points, cells = read_gmsh(path)
    name = "tet" if "tet" in cells else "tri"
    if name not in cells:
        raise ValueError("SUPG assembly needs a triangle or tet mesh")
    return supg_advection_diffusion(points, cells[name], alpha=alpha,
                                    velocity=velocity,
                                    unit_velocity=unit_velocity,
                                    curved=curved)
