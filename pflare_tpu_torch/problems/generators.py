"""Test-problem matrix generators.

The reference's driver problems, copied from ``pflare_tpu.problems`` so
both packages build identical matrices (reference: tests/adv_1d.c, tests/adv_diff_fd.c,
tests/matrandom.F90, tests/adv_dg_upwind.c).  All return scipy CSR in
float64.  ``adv_diff_3d`` and ``anisotropic_diffusion_2d`` are vectorised
over the grid where the reference loops over it; every entry comes from
the same floating-point operations, so the matrices agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def adv_1d(n: int) -> sp.csr_matrix:
    """1D steady upwind advection (reference: tests/adv_1d.c:79-105):
    Dirichlet on the left boundary, row i > 0 holds -1 at i-1 and +1 at
    i."""
    rows, cols, vals = [0], [0], [1.0]
    i = np.arange(1, n)
    rows += list(i) + list(i)
    cols += list(i - 1) + list(i)
    vals += [-1.0] * (n - 1) + [1.0] * (n - 1)
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    A.sort_indices()
    return A


def adv_diff_2d(
    nx: int,
    ny: int | None = None,
    theta: float | None = None,
    u: float | None = None,
    v: float | None = None,
    alpha: float = 0.0,
    adv_nondim: bool | None = None,
    curved_velocity: bool = False,
    unit_velocity: bool = True,
    L_x: float = 1.0,
    L_y: float = 1.0,
) -> sp.csr_matrix:
    """2D structured advection-diffusion FD, upwinded advection
    (reference: tests/adv_diff_fd.c:366-494).

    Node ordering x-fastest (index = j*nx + i).  Defaults replicate
    ``./adv_diff_fd``: pure advection at theta=pi/4, dimensionless,
    Dirichlet left/bottom, outflow top/right.
    """
    ny = ny or nx
    if adv_nondim is None:
        adv_nondim = alpha == 0.0
    if adv_nondim and alpha != 0.0:
        raise ValueError("non-dimensional advection only applies without diffusion")

    # velocity defaults (reference: tests/adv_diff_fd.c:189-231)
    uc, vc = 1.0, 1.0
    if theta is None and u is None and v is None:
        theta = np.pi / 4.0
    if theta is not None:
        uc, vc = np.cos(theta), np.sin(theta)
    explicit = u is not None or v is not None
    if u is not None:
        uc = u
    if v is not None:
        vc = v
    if explicit:
        unit_velocity = False

    Hx = L_x / (nx - 1)
    Hy = L_y / (ny - 1)
    HxdHy = Hx / Hy
    HydHx = Hy / Hx
    if adv_nondim:
        adv_x_scale, adv_y_scale = 1.0, HydHx
    else:
        adv_x_scale, adv_y_scale = Hx, Hy

    # vectorised over the grid
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny))  # [ny, nx]
    ii = ii.ravel()
    jj = jj.ravel()
    row = jj * nx + ii

    if curved_velocity:
        u_loc = jj * Hy
        v_loc = 1.0 - ii * Hx
    else:
        u_loc = np.full(row.shape, float(uc))
        v_loc = np.full(row.shape, float(vc))
    if unit_velocity:
        mag = np.sqrt(u_loc**2 + v_loc**2)
        safe = mag > 1e-12
        u_loc = np.where(safe, u_loc / np.where(safe, mag, 1.0), u_loc)
        v_loc = np.where(safe, v_loc / np.where(safe, mag, 1.0), v_loc)

    dirichlet = (ii == 0) | (jj == 0)
    outflow = (~dirichlet) & ((ii == nx - 1) | (jj == ny - 1))
    if alpha != 0.0:
        dirichlet = dirichlet | outflow
        outflow = np.zeros_like(dirichlet)
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
    if alpha != 0.0:
        add(interior, -nx, -alpha * HxdHy)
        add(interior, -1, -alpha * HydHx)
        add(interior, 0, alpha * 2.0 * (HxdHy + HydHx))
        add(interior, 1, -alpha * HydHx)
        add(interior, nx, -alpha * HxdHy)

    n = nx * ny
    A = sp.csr_matrix(
        (np.concatenate(vals_l), (np.concatenate(rows_l), np.concatenate(cols_l))),
        shape=(n, n),
    )
    A.sum_duplicates()
    # drop exact zeros like MAT_IGNORE_ZERO_ENTRIES
    A.eliminate_zeros()
    A.sort_indices()
    return A


def random_diag_dominant(n: int, density: float = 0.05, seed: int = 7) -> sp.csr_matrix:
    """Random sparse matrix made diagonally dominant by adding the row sums
    onto the diagonal (reference: tests/matrandom.F90:43-46)."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=density, random_state=np.random.RandomState(seed),
                  format="csr")
    A = A + sp.diags(np.abs(A).sum(axis=1).A1 + rng.uniform(1.0, 2.0, n))
    A = sp.csr_matrix(A)
    A.sort_indices()
    return A


def _unit_velocity_3d(x, y, z, curved: bool, unit: bool):
    """Per-node velocity of the 3D problem (reference:
    tests/adv_diff_fd.c:189-231): constant (1, 1, 1) or the curved field,
    scaled to unit length where it is not tiny."""
    if curved:
        vel = [z, z, 2.0 - x - y]
    else:
        vel = [np.full(x.shape, 1.0)] * 3
    u, v, w = (np.asarray(c, dtype=np.float64) for c in vel)
    if unit:
        mag = np.sqrt((u ** 2 + v ** 2) + w ** 2)
        ok = mag > 1e-12
        safe = np.where(ok, mag, 1.0)
        u, v, w = (np.where(ok, c / safe, c) for c in (u, v, w))
    return u, v, w


def adv_diff_3d(
    nx: int,
    ny: int | None = None,
    nz: int | None = None,
    alpha: float = 0.0,
    curved_velocity: bool = False,
    unit_velocity: bool = True,
    L=(1.0, 1.0, 1.0),
) -> sp.csr_matrix:
    """3D upwinded advection(-diffusion) FD (reference:
    tests/adv_diff_fd.c:495-580).  Node ordering x-fastest."""
    ny = ny or nx
    nz = nz or nx
    adv_nondim = alpha == 0.0
    Hx, Hy, Hz = L[0] / (nx - 1), L[1] / (ny - 1), L[2] / (nz - 1)
    HyHz_Hx, HxHz_Hy, HxHy_Hz = Hy * Hz / Hx, Hx * Hz / Hy, Hx * Hy / Hz
    if adv_nondim:
        adv_yz, adv_xz, adv_xy = HyHz_Hx / Hx, Hz / Hx, Hy / Hx
    else:
        adv_yz, adv_xz, adv_xy = Hy * Hz, Hx * Hz, Hx * Hy

    kk, jj, ii = (a.ravel() for a in np.meshgrid(
        np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij"))
    row = (kk * ny + jj) * nx + ii
    u, v, w = _unit_velocity_3d(ii * Hx, jj * Hy, kk * Hz, curved_velocity,
                                unit_velocity)
    low = (ii == 0) | (jj == 0) | (kk == 0)
    high = (ii == nx - 1) | (jj == ny - 1) | (kk == nz - 1)
    interior = ~low & ~high
    moving = (u != 0.0) | (v != 0.0) | (w != 0.0)

    rows_l, cols_l, vals_l = [], [], []

    def add(mask, dcol, val):
        rows_l.append(row[mask])
        cols_l.append(row[mask] + dcol)
        vals_l.append(np.broadcast_to(val, row[mask].shape))

    def advect(mask):
        add(mask, -nx * ny, (-w * adv_xy)[mask])
        add(mask, -nx, (-v * adv_xz)[mask])
        add(mask, -1, (-u * adv_yz)[mask])
        add(mask, 0, (u * adv_yz + v * adv_xz + w * adv_xy)[mask])

    # boundary: Dirichlet on the low faces (and on every face with
    # diffusion); pure advection's high faces are upwind outflow rows
    add(low | (high & (alpha != 0.0)), 0, 1.0)
    if alpha == 0.0:
        advect(high & ~low)
    else:
        add(interior, -nx * ny, -alpha * HxHy_Hz)
        add(interior, -nx, -alpha * HxHz_Hy)
        add(interior, -1, -alpha * HyHz_Hx)
        add(interior, 0, alpha * 2.0 * (HyHz_Hx + HxHz_Hy + HxHy_Hz))
        add(interior, 1, -alpha * HyHz_Hx)
        add(interior, nx, -alpha * HxHz_Hy)
        add(interior, nx * ny, -alpha * HxHy_Hz)
    advect(interior & moving)

    n = nx * ny * nz
    A = sp.csr_matrix(
        (np.concatenate(vals_l),
         (np.concatenate(rows_l), np.concatenate(cols_l))), shape=(n, n))
    A.sum_duplicates()
    A.eliminate_zeros()
    A.sort_indices()
    return A


def anisotropic_diffusion_2d(nx: int, epsilon: float = 1e-3,
                             theta: float = 0.0) -> sp.csr_matrix:
    """Rotated anisotropic diffusion, 9-point FD stencil: -div(K grad u)
    with K = R(theta) diag(1, epsilon) R(theta)^T, Dirichlet boundary by
    the eliminated stencil (the reference's BASELINE.json problem)."""
    c, s = np.cos(theta), np.sin(theta)
    kxx = c * c + epsilon * s * s
    kyy = s * s + epsilon * c * c
    kxy = (1.0 - epsilon) * c * s
    st = np.array([[-0.5 * kxy, -kyy, 0.5 * kxy],
                   [-kxx, 2.0 * (kxx + kyy), -kxx],
                   [0.5 * kxy, -kyy, -0.5 * kxy]])
    jj, ii = (a.ravel() for a in np.meshgrid(np.arange(nx), np.arange(nx),
                                             indexing="ij"))
    row = jj * nx + ii
    rows_l, cols_l, vals_l = [], [], []
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            val = st[dj + 1, di + 1]
            if val == 0.0:
                continue
            ok = ((ii + di >= 0) & (ii + di < nx)
                  & (jj + dj >= 0) & (jj + dj < nx))
            rows_l.append(row[ok])
            cols_l.append(((jj + dj) * nx + ii + di)[ok])
            vals_l.append(np.full(int(ok.sum()), val))
    n = nx * nx
    A = sp.csr_matrix(
        (np.concatenate(vals_l),
         (np.concatenate(rows_l), np.concatenate(cols_l))), shape=(n, n))
    A.sum_duplicates()
    A.sort_indices()
    return A


def dg_upwind_advection_unstructured(n_side: int = 20,
                                     theta: float | None = None,
                                     curved_velocity: bool = False,
                                     seed: int = 11) -> sp.csr_matrix:
    """First-order upwind finite-volume advection on an unstructured
    triangular mesh (the reference's unstructured DG upwind test family,
    reference: tests/adv_dg_upwind.c).

    Cells are the Delaunay triangles of a jittered grid on [0,1]^2; each
    interior edge contributes an upwinded flux v.n |e|, outflow boundary
    edges add to the diagonal, and inflow boundary edges add their flux
    to the diagonal (weak Dirichlet).  Strongly nonsymmetric with
    unstructured connectivity: the lAIR regime.
    """
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    xs = np.linspace(0.0, 1.0, n_side)
    X, Y = np.meshgrid(xs, xs)
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    h = 1.0 / (n_side - 1)
    interior = ((pts[:, 0] > 0) & (pts[:, 0] < 1) & (pts[:, 1] > 0)
                & (pts[:, 1] < 1))
    pts[interior] += rng.uniform(-0.3 * h, 0.3 * h,
                                 size=(interior.sum(), 2))
    tri = Delaunay(pts)
    simplices = tri.simplices
    n_cells = len(simplices)
    centroids = pts[simplices].mean(axis=1)

    if theta is None:
        theta = np.pi / 4.0

    def vel(p):
        if curved_velocity:
            v = np.array([p[1], 1.0 - p[0]])
        else:
            v = np.array([np.cos(theta), np.sin(theta)])
        nv = np.linalg.norm(v)
        return v / nv if nv > 1e-12 else v

    rows, cols, vals = [], [], []
    diag = np.zeros(n_cells)
    # tri.neighbors[i][k] is the cell across the edge opposite vertex k
    for i in range(n_cells):
        verts = simplices[i]
        for k in range(3):
            j = tri.neighbors[i][k]
            a, b = pts[verts[(k + 1) % 3]], pts[verts[(k + 2) % 3]]
            edge = b - a
            length = np.linalg.norm(edge)
            nrm = np.array([edge[1], -edge[0]]) / length
            mid = 0.5 * (a + b)
            if np.dot(nrm, mid - centroids[i]) < 0:   # outward from cell i
                nrm = -nrm
            flux = np.dot(vel(mid), nrm) * length
            if j >= 0:
                if flux > 0:          # outflow across this edge
                    diag[i] += flux
                else:                 # inflow from neighbour j
                    rows.append(i)
                    cols.append(int(j))
                    vals.append(flux)
            else:                     # boundary: outflow, or weak inflow
                diag[i] += flux if flux > 0 else -flux
    rows += list(range(n_cells))
    cols += list(range(n_cells))
    vals += list(diag)
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n_cells, n_cells))
    A.sum_duplicates()
    A.eliminate_zeros()
    A.sort_indices()
    return A
