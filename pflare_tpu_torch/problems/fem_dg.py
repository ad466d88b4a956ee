"""DG(1) upwind advection FEM assembly on unstructured meshes.

The counterpart of ``pflare_tpu.problems.fem_dg``: the reference's
unstructured test family discretises scalar advection with an upwinded
discontinuous-Galerkin space of default degree 1 on meshes read through
DMPlex (reference: tests/adv_dg_upwind.c:1721-1745,
-adv_dg_petscspace_degree default 1).  Each cell owns its nodal P1/Q1
DoFs (broken space), the volume term is -int_K u (v . grad w), interior
and outflow facets carry the upwind flux, inflow facets are weak
Dirichlet (RHS only).

Nodal bases make facet traces the facet's own nodal functions, so each
side's basis values follow from matching facet vertices to cell-local
vertices.  Simplices use affine Jacobians; quads and hexes the full
isoparametric map at each quadrature point.

The assembly is batched: the volume terms over cells a quadrature point
at a time, the facet terms over facets and their quadrature points.
Every small product goes through the numpy routine the reference calls
per cell (batched ``matmul`` runs the same BLAS call per matrix,
``linalg.det``/``inv`` the same LAPACK one), the upwind choice keeps the
reference's rule, and the entries come in its order, so the matrices
agree with it.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .gmsh import (_HEX, _QUAD, _TET, _TRI, as_points3, is_tet,
                   match_facets, mesh_cells, read_gmsh, rowdot,
                   velocity_field)

# ~~~~~~~~~~~~~~~ reference elements (nodal, degree 1) ~~~~~~~~~~~~~~~


def _tri_shape(q):
    x, y = q[:, 0], q[:, 1]
    N = np.stack([1 - x - y, x, y], axis=1)
    dN = np.broadcast_to(
        np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]]), (len(q), 3, 2))
    return N, dN


def _tet_shape(q):
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    N = np.stack([1 - x - y - z, x, y, z], axis=1)
    dN = np.broadcast_to(
        np.array([[-1.0, -1.0, -1.0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
                 dtype=np.float64), (len(q), 4, 3))
    return N, dN


def _quad_shape(q):
    x, y = q[:, 0], q[:, 1]
    N = np.stack([(1 - x) * (1 - y), x * (1 - y), x * y, (1 - x) * y],
                 axis=1)
    dN = np.stack([
        np.stack([-(1 - y), -(1 - x)], axis=1),
        np.stack([(1 - y), -x], axis=1),
        np.stack([y, x], axis=1),
        np.stack([-y, (1 - x)], axis=1),
    ], axis=1)
    return N, dN


def _hex_shape(q):
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    xm, ym, zm = 1 - x, 1 - y, 1 - z
    corners = [(xm, ym, zm), (x, ym, zm), (x, y, zm), (xm, y, zm),
               (xm, ym, z), (x, ym, z), (x, y, z), (xm, y, z)]
    N = np.stack([a * b * c for a, b, c in corners], axis=1)
    sx = [-1, 1, 1, -1, -1, 1, 1, -1]
    sy = [-1, -1, 1, 1, -1, -1, 1, 1]
    sz = [-1, -1, -1, -1, 1, 1, 1, 1]
    xs = [xm, x, x, xm, xm, x, x, xm]
    ys = [ym, ym, y, y, ym, ym, y, y]
    zs = [zm, zm, zm, zm, z, z, z, z]
    dN = np.stack([
        np.stack([sx[i] * ys[i] * zs[i], sy[i] * xs[i] * zs[i],
                  sz[i] * xs[i] * ys[i]], axis=1)
        for i in range(8)
    ], axis=1)
    return N, dN


def _gauss1d(n=2):
    p = 0.5 + np.array([-1, 1]) * (0.5 / np.sqrt(3.0))
    w = np.array([0.5, 0.5])
    return p, w


# volume quadrature (degree-2 exact on simplices; 2^d Gauss on tensor cells)
_TRI_Q = (np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]]),
          np.full(3, 1 / 6))
_TET_Q_A = (5 - np.sqrt(5.0)) / 20
_TET_Q_B = (5 + 3 * np.sqrt(5.0)) / 20
_TET_Q = (np.array([[_TET_Q_A] * 3,
                    [_TET_Q_B, _TET_Q_A, _TET_Q_A],
                    [_TET_Q_A, _TET_Q_B, _TET_Q_A],
                    [_TET_Q_A, _TET_Q_A, _TET_Q_B]]),
          np.full(4, 1 / 24))
_P1, _W1 = _gauss1d()
_QUAD_Q = (np.array([[a, b] for a in _P1 for b in _P1]),
           np.array([wa * wb for wa in _W1 for wb in _W1]))
_HEX_Q = (np.array([[a, b, c] for a in _P1 for b in _P1 for c in _P1]),
          np.array([wa * wb * wc for wa in _W1 for wb in _W1 for wc in _W1]))

# facet quadrature: segments (2D facets) and tri/quad (3D facets)
_SEG_Q = (_P1.reshape(-1, 1), _W1 * 1.0)
_FTRI_Q = (np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]]),
           np.full(3, 1 / 6))   # sums to 1/2; |cross(T0,T1)| = 2*Area
_FQUAD_Q = _QUAD_Q

_CELLS = {
    3: dict(shape=_tri_shape, quad=_TRI_Q, facets=_TRI[1], dim=2),
    4: None,    # tet vs quad decided by geometry
    8: dict(shape=_hex_shape, quad=_HEX_Q, facets=_HEX[1], dim=3),
}
_TET_DEF = dict(shape=_tet_shape, quad=_TET_Q, facets=_TET[1], dim=3)
_QUAD_DEF = dict(shape=_quad_shape, quad=_QUAD_Q, facets=_QUAD[1], dim=2)


def _facet_basis(fverts_local_count, q):
    """Nodal shape functions of a facet (segment / tri / quad) at its own
    reference points."""
    if fverts_local_count == 2:
        x = q[:, 0]
        return np.stack([1 - x, x], axis=1)
    if fverts_local_count == 3:
        return _tri_shape(q)[0]
    return _quad_shape(q)[0]


def _make_vel(dim, velocity, unit, curved):
    """The velocity at the rows of X as [m, dim] vectors (the reference's
    per-point ``vel``, batched)."""
    def vel(X):
        return velocity_field(X, dim, velocity, unit, curved)[:, :dim]
    return vel


def _jacobians(dNq, Xc):
    """|det J| and the physical gradients [c, nb, dim] of the basis at one
    reference point, for every cell: J = dN^T X, grad = dN inv(J^T)."""
    J = np.matmul(dNq.T, Xc)
    detJ = np.abs(np.linalg.det(J))
    gradN = np.matmul(dNq, np.linalg.inv(J.transpose(0, 2, 1)))
    return detJ, gradN


def _matvec(M, v):
    """Per-row matrix-vector products [m, r, d] x [m, d] -> [m, r] by the
    BLAS gemv of the reference's ``M @ v``."""
    return np.matmul(M, np.ascontiguousarray(v)[:, :, None])[:, :, 0]


def dg1_upwind_advection(points: np.ndarray, cells: np.ndarray,
                         velocity=None, unit_velocity: bool = True,
                         curved: bool = False) -> sp.csr_matrix:
    """Assembled DG(1) upwind advection operator (one nodal DoF block per
    cell; broken space)."""
    points = as_points3(points)
    cells = np.asarray(cells, dtype=np.int64)
    nn = cells.shape[1]
    if nn in (3, 8):
        ref = _CELLS[nn]
    elif nn == 4:
        ref = _TET_DEF if is_tet(points, cells) else _QUAD_DEF
    else:
        raise ValueError(f"unsupported cell arity {nn}")
    dim = ref["dim"]
    qp, qw = ref["quad"]
    vel = _make_vel(dim, velocity, unit_velocity, curved)
    n_cells, nb = len(cells), nn
    ndof = n_cells * nb

    # ~~~~~~~~~~ volume terms ~~~~~~~~~~
    N, dN = ref["shape"](qp)                 # [q,nb], [q,nb,dim]
    Xc = points[cells][:, :, :dim]           # [c,nn,dim]
    affine = ref["shape"] in (_tri_shape, _tet_shape)
    Ke = np.zeros((n_cells, nb, nb))
    for q in range(len(qw)):
        if q == 0 or not affine:
            detJ, gradN = _jacobians(dN[q], Xc)
        v = vel(np.matmul(N[q], Xc))
        # -u (v . grad w): A[i,j] -= w detJ * N_j * (v . gradN_i)
        Ke -= (qw[q] * detJ)[:, None, None] * (
            _matvec(gradN, v)[:, :, None] * N[q][None, None, :])
    c, i, j = np.nonzero(Ke)
    rows, cols, vals = [c * nb + i], [c * nb + j], [Ke[c, i, j]]
    del Ke

    # ~~~~~~~~~~ facet terms ~~~~~~~~~~
    loc = np.asarray(ref["facets"], dtype=np.int64)
    cm, lfm, cp = match_facets(cells, loc)
    fverts = cells[cm[:, None], loc[lfm]]    # [F,k], the owner's order
    n_f, k = fverts.shape
    fq, fw = _SEG_Q if k == 2 else _FTRI_Q if k == 3 else _FQUAD_Q
    Nf = _facet_basis(k, fq)                 # [qf,k]
    xf = points[fverts][:, :, :dim]          # [F,k,dim]
    X = np.matmul(Nf, xf)                    # [F,qf,dim]
    if k == 2:
        e = xf[:, 1] - xf[:, 0]
        nrm = np.stack([e[:, 1], -e[:, 0]], axis=1)
        nds = fw[None, :, None] * nrm[:, None, :]   # |e| folded into nrm
    else:
        # tangents of the parametrisation; the cross product carries the
        # area scaling
        dNf = (np.broadcast_to(np.array([[-1.0, -1.0], [1, 0], [0, 1]]),
                               (len(fq), 3, 2)) if k == 3
               else _quad_shape(fq)[1])
        nds = np.empty((n_f, len(fq), 3))
        for iq in range(len(fq)):
            T = np.matmul(dNf[iq].T, xf)     # [F,2,3]
            nds[:, iq] = fw[iq] * np.cross(T[:, 0], T[:, 1])
    interior = cp >= 0
    cpi = np.where(interior, cp, cm)
    # cell-local index of each facet vertex on either side
    loc_m = loc[lfm]
    loc_p = np.argmax(cells[cpi][:, None, :] == fverts[:, :, None], axis=2)
    cent = points[cells[cm]][:, :, :dim].mean(axis=1)

    bn = np.empty((n_f, len(fq)))
    for iq in range(len(fq)):
        # orient outward from cm
        nrm = np.ascontiguousarray(nds[:, iq])
        flip = rowdot(nrm, X[:, iq] - cent) < 0
        nrm[flip] = -nrm[flip]
        bn[:, iq] = rowdot(vel(X[:, iq]), nrm)
    # upwind = minus side where bn >= 0 or on the boundary (where inflow,
    # bn < 0, is Dirichlet data: RHS only), else the plus side
    minus = (bn >= 0) | ~interior[:, None]                      # [F,qf]
    keep = interior[:, None] | (bn >= 0)
    # entries in the reference's order: facet, point, trial a, then the
    # test functions of the minus side and (interior) of the plus side
    up_cell = np.where(minus, cm[:, None], cpi[:, None])        # [F,qf]
    up_loc = np.where(minus[:, :, None], loc_m[:, None, :],
                      loc_p[:, None, :])                        # [F,qf,k]
    col = (up_cell[:, :, None] * nb + up_loc)[:, :, :, None, None]
    side_cell = np.stack([cm, cpi], axis=1)                     # [F,2]
    side_loc = np.stack([loc_m, loc_p], axis=1)                 # [F,2,k]
    row = (side_cell[:, :, None] * nb + side_loc)[:, None, None, :, :]
    sbn = np.stack([bn, -bn], axis=2)                           # [F,qf,2]
    phi = Nf[None, :, :]                                        # [1,qf,k]
    val = ((sbn[:, :, None, :] * phi[:, :, :, None])[:, :, :, :, None]
           * phi[:, :, None, None, :])                          # [F,qf,k,2,k]
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


def dg1_advection_from_gmsh(path: str, velocity=None,
                            unit_velocity: bool = True,
                            curved: bool = False) -> sp.csr_matrix:
    """DG(1) upwind advection on a Gmsh mesh -- the discretisation of the
    reference's adv_dg_upwind tests (degree 1 default)."""
    points, cells = read_gmsh(path)
    return dg1_upwind_advection(points, mesh_cells(cells), velocity=velocity,
                                unit_velocity=unit_velocity, curved=curved)
