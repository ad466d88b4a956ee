"""Operators shared by the port's CPU and card tests.  Imports neither jax
nor pflare_tpu, so the card tests can use it where only PyTorch runs."""

import functools

import numpy as np
import scipy.sparse as sp
import torch

import pflare_tpu_torch as tpf
from pflare_tpu_torch.air.fullspace import (_map_both, _map_cols, _map_rows,
                                            make_op)
from pflare_tpu_torch.sparse import DIA, BandedSpMV

LEVEL0_OPERATORS = ("A_ff", "A_fc", "R", "P")


def _main_path_pc(n):
    """A CPU PCAIR of the main path's options, set up at n^2 (f64)."""
    opts = tpf.AIROptions(a_lump=True, a_drop=1e-5, strong_threshold=0.99,
                          max_levels=6,
                          coarsest_inverse_type=tpf.InverseType.NEWTON,
                          coarsest_poly_order=24,
                          coarsest_matrix_free_polys=True)
    pc = tpf.PCAIR(opts, dtype=torch.float64, device="cpu")
    return pc.setup(tpf.adv_diff_2d(n))


@functools.cache
def _levels128():
    """The host levels of the 128^2 main-path hierarchy (f64)."""
    return _main_path_pc(128).hierarchy.levels


@functools.cache
def _gather_operators64():
    """The 64^2 main path's level-1 full-space R and its coarse inverse's
    operator (the ELL of the matrix-free Newton solve), as host CSR."""
    pc = _main_path_pc(64)
    lvl = pc.hierarchy.levels[1]
    R = _map_rows(lvl.R, np.asarray(lvl.coarse), lvl.n)
    return R, pc.upload().coarse_inv.mat.to_scipy()


def fullspace_R64():
    """The full-space level-1 R of the 64^2 main path, as make_op
    receives it: every F row empty.  A fresh copy on every call."""
    return _gather_operators64()[0].copy()


def coarse_ell64():
    """The 64^2 main path's coarsest operator, which its matrix-free
    Newton coarse solve multiplies by as an ELL.  A fresh copy."""
    return _gather_operators64()[1].copy()


@functools.cache
def _masked_level1():
    lvl = _levels128()[1]
    fine = np.asarray(lvl.fine)
    A = _map_both(lvl.A_ff, fine, fine, lvl.n)
    assert isinstance(make_op(A), BandedSpMV)
    return A


def masked_level1():
    """The full-space level-1 A_ff of the 128^2 main-path hierarchy, as
    make_op receives it: 10,281 rows (not a multiple of 4), K = 2, w = 203,
    W = 640, and most slots pads (the rows of C points are empty).  A fresh
    copy on every call."""
    return _masked_level1().copy()


@functools.cache
def _masked_level0(name):
    lvl = _levels128()[0]
    fine, coarse, n = np.asarray(lvl.fine), np.asarray(lvl.coarse), lvl.n
    A = {"A_ff": lambda: _map_both(lvl.A_ff, fine, fine, n),
         "A_fc": lambda: _map_both(lvl.A_fc, fine, coarse, n),
         "R": lambda: _map_rows(lvl.R, coarse, n),
         "P": lambda: _map_cols(lvl.P, coarse, n)}[name]()
    assert isinstance(make_op(A), DIA)
    return A


def masked_level0(name):
    """One of the full-space level-0 operators ``LEVEL0_OPERATORS`` of the
    128^2 main-path hierarchy, as make_op receives it: 16,384 rows, DIA
    with 1-3 offsets, half or more of the slots zero (the rows or columns
    of the other point set).  A fresh copy on every call."""
    return _masked_level0(name).copy()


def dia_odd_rows(n, seed=0):
    """A square 5-offset DIA of n rows with n not a multiple of 4, so the
    DIA kernel takes its scalar instantiation, and offsets that reach past
    both ends."""
    rng = np.random.default_rng(seed)
    offs = [-37, -1, 0, 2, 37]
    A = sp.diags([rng.standard_normal(n - abs(o)) for o in offs], offs,
                 format="csr")
    A.sort_indices()
    return A


# ~~~~~~ generated meshes (the reference's mesh files are not here) ~~~~~~

def tri_mesh(m, seed=0, jitter=0.3, scramble=True):
    """Delaunay triangles of an (m+1)^2 grid on the unit square whose
    interior points are jittered by up to ``jitter`` of a spacing: about
    2 m^2 cells, their order scrambled by a seeded permutation.
    Returns (points [n,2], cells [c,3])."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    g = np.linspace(0.0, 1.0, m + 1)
    pts = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    inner = np.all((pts > 0) & (pts < 1), axis=1)
    pts[inner] += rng.uniform(-jitter, jitter, (inner.sum(), 2)) / m
    cells = Delaunay(pts).simplices.astype(np.int64)
    if scramble:
        cells = cells[rng.permutation(len(cells))]
    return pts, cells


def tet_mesh(m, seed=0, jitter=0.2):
    """Delaunay tets of a jittered (m+1)^3 grid on the unit cube, without
    the flat tets that coplanar boundary points give."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    g = np.linspace(0.0, 1.0, m + 1)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    inner = np.all((pts > 0) & (pts < 1), axis=1)
    pts[inner] += rng.uniform(-jitter, jitter, (inner.sum(), 3)) / m
    cells = Delaunay(pts).simplices.astype(np.int64)
    e = pts[cells[:, 1:]] - pts[cells[:, :1]]
    vol = np.abs(np.linalg.det(e)) / 6
    return pts, cells[vol > 1e-6 / m ** 3]


def structured_tri_mesh(m):
    """Each square of an m x m grid split by its (0,0)-(1,1) diagonal, so
    the diagonal facets are tangent to the default velocity (1,1)."""
    g = np.linspace(0.0, 1.0, m + 1)
    pts = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    i, j = (a.ravel() for a in np.meshgrid(np.arange(m), np.arange(m),
                                           indexing="ij"))
    v00, v10 = i * (m + 1) + j, (i + 1) * (m + 1) + j
    v01, v11 = v00 + 1, v10 + 1
    cells = np.concatenate([np.stack([v00, v10, v11], 1),
                            np.stack([v00, v11, v01], 1)])
    return pts, cells.astype(np.int64)


def quad_mesh(m):
    """Counter-clockwise unit quads of an m x m grid."""
    g = np.linspace(0.0, 1.0, m + 1)
    pts = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    i, j = (a.ravel() for a in np.meshgrid(np.arange(m), np.arange(m),
                                           indexing="ij"))
    v00 = i * (m + 1) + j
    cells = np.stack([v00, v00 + m + 1, v00 + m + 2, v00 + 1], 1)
    return pts, cells.astype(np.int64)


def annulus_hex_mesh(nr, nt, nz, twist=0.5, r0=0.5, r1=1.0):
    """Hexes on an annulus r0 <= r <= r1, 0 <= z <= 1, periodic in the
    angle, twisted by ``twist`` radians over the height (the reference's
    annulus_twisted family)."""
    r = np.linspace(r0, r1, nr + 1)
    t = np.arange(nt) * (2 * np.pi / nt)
    z = np.linspace(0.0, 1.0, nz + 1)
    R, T, Z = np.meshgrid(r, t, z, indexing="ij")
    T = T + twist * Z
    pts = np.stack([R * np.cos(T), R * np.sin(T), Z], -1).reshape(-1, 3)

    def vid(a, b, c):
        return (a * nt + b % nt) * (nz + 1) + c

    a, b, c = (x.ravel() for x in np.meshgrid(
        np.arange(nr), np.arange(nt), np.arange(nz), indexing="ij"))
    cells = np.stack([vid(a, b, c), vid(a + 1, b, c), vid(a + 1, b + 1, c),
                      vid(a, b + 1, c), vid(a, b, c + 1),
                      vid(a + 1, b, c + 1), vid(a + 1, b + 1, c + 1),
                      vid(a, b + 1, c + 1)], 1)
    return pts, cells.astype(np.int64)


GMSH_TYPE = {2: 1, 3: 2, 4: 3, 8: 5}     # arity -> type of a surface mesh
_GMSH_TET = 4


def write_gmsh(path, points, blocks, node_blocks=2, seed=0):
    """Write a Gmsh 4.1 ASCII file: ``points`` [n,2|3] in ``node_blocks``
    blocks (node tags 1..n in a seeded shuffled order, so the listing
    order is not the tag order) and ``blocks`` a list of (gmsh element
    type, [m,k] 0-based connectivity)."""
    pts = np.zeros((len(points), 3))
    pts[:, :points.shape[1]] = points
    n = len(pts)
    tag = np.random.default_rng(seed).permutation(n) + 1   # listing -> tag
    out = ["$MeshFormat", "4.1 0 8", "$EndMeshFormat", "$Nodes",
           f"{node_blocks} {n} 1 {n}"]
    for k, part in enumerate(np.array_split(np.arange(n), node_blocks)):
        out.append(f"2 {k + 1} 0 {len(part)}")
        out += [str(t) for t in tag[part]]
        out += [" ".join(repr(float(c)) for c in pts[p]) for p in part]
    out.append("$EndNodes")
    n_el = sum(len(c) for _, c in blocks)
    out += ["$Elements", f"{len(blocks)} {n_el} 1 {n_el}"]
    e = 1
    for k, (etype, conn) in enumerate(blocks):
        out.append(f"2 {k + 1} {etype} {len(conn)}")
        for row in tag[conn]:
            out.append(f"{e} " + " ".join(map(str, row)) + " ")
            e += 1
    out.append("$EndElements")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    return path
