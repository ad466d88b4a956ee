"""Gmsh mesh import and unstructured upwind advection assembly.

The counterpart of ``pflare_tpu.problems.gmsh``: the reference drives its
unstructured tests through DMPlex reading Gmsh files (reference:
tests/adv_dg_upwind.c -dm_plex_filename, meshes in tests/data/*.msh: 2D
triangles, 3D tets, 3D hexes on a twisted annulus).  The discretisation is
the first-order upwind cell-centred scheme: one DoF per cell, the upwinded
flux v.n |f| on every facet, outflow on the diagonal, inflow boundary
facets as weak Dirichlet.

Both the reader and the assembly work on whole arrays: one numpy parse a
Gmsh block, facet matching by sorted vertex keys, and every normal, dot
and flux batched over the facets.  The assembly keeps the reference's
arithmetic, so the matrices agree with it: each dot product goes through
the same BLAS routine (``rowdot``), and the facets, fluxes and diagonal
sums come in the reference's order.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

# element type -> (n_nodes, local facets as vertex index tuples)
_TRI = (3, ((0, 1), (1, 2), (2, 0)))
_QUAD = (4, ((0, 1), (1, 2), (2, 3), (3, 0)))
_TET = (4, ((1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1)))
_HEX = (8, ((0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4),
            (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7)))
_ELEMENTS = {2: ("tri", _TRI), 3: ("quad", _QUAD),
             4: ("tet", _TET), 5: ("hex", _HEX)}


def read_gmsh(path: str):
    """Read a Gmsh 4.1 ASCII mesh.

    Returns (points [n,3] float64, cells: dict name -> [m,k] int vertex
    connectivity, 0-based).  Lower-dimensional elements (points, lines,
    and 2D facets of 3D meshes) are skipped; the highest-dimensional cell
    family present defines the mesh.  Each node and element block is
    parsed by one numpy call.
    """
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = 0

    def seek(tag):
        nonlocal i
        while i < len(lines) and lines[i].strip() != tag:
            i += 1
        if i == len(lines):
            raise ValueError(f"gmsh: missing {tag} in {path}")
        i += 1

    def numbers(first, count, dtype):
        """The ``count`` lines from ``first`` as a [count, width] array."""
        if count == 0:
            return np.zeros((0, 9), dtype=dtype)
        return np.fromstring(" ".join(lines[first:first + count]),
                             dtype=dtype, sep=" ").reshape(count, -1)

    seek("$MeshFormat")
    version = lines[i].split()[0]
    if not version.startswith("4"):
        raise ValueError(f"gmsh: only format 4.x supported, got {version}")

    seek("$Nodes")
    n_blocks, n_nodes = (int(x) for x in lines[i].split()[:2])
    i += 1
    tags, coords = [], []
    for _ in range(n_blocks):
        nb = int(lines[i].split()[3])
        i += 1
        tags.append(numbers(i, nb, np.int64)[:, 0])
        i += nb
        coords.append(numbers(i, nb, np.float64)[:, :3])
        i += nb
    tags = np.concatenate(tags) if tags else np.zeros(0, np.int64)
    # gmsh tags are 1-based; points come in the order the file lists them
    tag_of = np.zeros(max(n_nodes, int(tags.max(initial=0))) + 1,
                      dtype=np.int64)
    tag_of[tags] = np.arange(len(tags))
    points = np.zeros((n_nodes, 3))
    if coords:
        points[:len(tags)] = np.concatenate(coords)

    seek("$Elements")
    n_blocks, _ = (int(x) for x in lines[i].split()[:2])
    i += 1
    cells: dict[str, list] = {}
    for _ in range(n_blocks):
        _, _, etype, nb = (int(x) for x in lines[i].split()[:4])
        i += 1
        if etype in _ELEMENTS:
            name, (nn, _f) = _ELEMENTS[etype]
            cells.setdefault(name, []).append(
                numbers(i, nb, np.int64)[:, 1:1 + nn])
        i += nb
    out = {name: tag_of[np.concatenate(blocks, axis=0)]
           for name, blocks in cells.items()}
    # keep only the top-dimensional family
    if ("tet" in out or "hex" in out) and ("tri" in out or "quad" in out):
        out.pop("tri", None)
        out.pop("quad", None)
    return points, out


def rowdot(a, b):
    """Row-wise dot products of two [m, d] arrays, each row by numpy's
    1-D ``dot`` (the BLAS ddot that the reference's per-facet ``np.dot``
    and ``np.linalg.norm`` call), so every product rounds as there."""
    a = np.ascontiguousarray(a, dtype=np.float64)
    b = np.ascontiguousarray(b, dtype=np.float64)
    return np.matmul(a[:, None, :], b[:, :, None])[:, 0, 0]


def as_points3(points) -> np.ndarray:
    points = np.asarray(points, dtype=np.float64)
    if points.shape[1] == 2:
        points = np.hstack([points, np.zeros((len(points), 1))])
    return points


def is_tet(points, cells) -> bool:
    """Four-vertex cells: tets have volume, quads do not (the median
    volume decides, as in the reference)."""
    vol = np.abs(np.einsum(
        "ij,ij->i",
        np.cross(points[cells[:, 1]] - points[cells[:, 0]],
                 points[cells[:, 2]] - points[cells[:, 0]]),
        points[cells[:, 3]] - points[cells[:, 0]]))
    return bool(np.median(vol) > 1e-14)


def match_facets(cells: np.ndarray, local_facets):
    """Pair the cells' facets by their sorted vertex keys, in the
    reference's order.  The reference walks cells and local facets in
    order with a dict: a key's first sighting waits, its second pairs with
    it, a third waits again.  Returns (cm, lfm, cp): the cell and local
    facet of each facet's first sighting and the neighbour (-1 on the
    boundary); interior facets come in the order of their second
    sighting, then boundary facets in the order they were last seen."""
    loc = np.asarray(local_facets, dtype=np.int64)       # [nf, k]
    n_cells, nf = len(cells), len(loc)
    keys = np.sort(cells[:, loc].reshape(n_cells * nf, -1), axis=1)
    order = np.lexsort(keys.T[::-1])        # stable: ties by sighting
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


def velocity_field(X, dim, velocity, unit_velocity, curved) -> np.ndarray:
    """The advection velocity at the rows of ``X`` as [m, 3] vectors: the
    reference's ``vel`` (gmsh.py, fem_dg.py::_make_vel) batched.  A
    callable ``velocity`` is called once a point, with the point as the
    reference passes it."""
    m = len(X)
    if curved:
        V = np.zeros((m, 3))
        if dim == 2:
            V[:, 0] = X[:, 1]
            V[:, 1] = 1.0 - X[:, 0]
        else:
            V[:, 0] = X[:, 2]
            V[:, 1] = X[:, 2]
            V[:, 2] = 2.0 - X[:, 0] - X[:, 1]
    elif callable(velocity):
        V = np.zeros((m, 3))
        for p in range(m):
            v = np.asarray(velocity(X[p]), dtype=np.float64)
            V[p, :len(v)] = v[:3]
    else:
        if velocity is None:
            v = np.ones(3) if dim == 3 else np.array([1.0, 1.0, 0.0])
        else:
            v = np.asarray(velocity, dtype=np.float64)
            if len(v) == 2:
                v = np.array([v[0], v[1], 0.0])
        if unit_velocity:
            n = np.linalg.norm(v[:dim])
            if n > 1e-300:
                v = v / n
        return np.ascontiguousarray(np.broadcast_to(v, (m, 3)))
    if unit_velocity:
        n = np.sqrt(rowdot(V[:, :dim], V[:, :dim]))
        big = n > 1e-300
        V[big] = V[big] / n[big, None]
    return V


def _facet_normals(P):
    """(normal * area, unoriented) of facets given their vertex
    coordinates [F, k, 3]: segments in 2D (z ignored), triangles, and
    (possibly non-planar) quads split into two triangles."""
    k = P.shape[1]
    if k == 2:
        e = P[:, 1] - P[:, 0]
        nrm = np.zeros((len(P), 3))
        nrm[:, 0] = e[:, 1]
        nrm[:, 1] = -e[:, 0]
        return nrm
    nrm = 0.5 * np.cross(P[:, 1] - P[:, 0], P[:, 2] - P[:, 0])
    if k == 3:
        return nrm
    return nrm + 0.5 * np.cross(P[:, 2] - P[:, 0], P[:, 3] - P[:, 0])


def fv_upwind_advection(points: np.ndarray, cells: np.ndarray,
                        velocity=None, unit_velocity: bool = True,
                        curved: bool = False) -> sp.csr_matrix:
    """First-order upwind advection operator, one DoF per cell.

    ``velocity``: constant vector, or callable(midpoint)->vector; default
    (1,..,1) normalised like the reference driver
    (reference: tests/adv_dg_upwind.c GetVelocity).  ``curved`` selects the
    reference's curved field ((y, 1-x) in 2D; (z, z, 2-x-y) in 3D).
    """
    points = as_points3(points)
    cells = np.asarray(cells, dtype=np.int64)
    nn = cells.shape[1]
    if nn == 3:
        loc, dim = _TRI[1], 2
    elif nn == 4:
        loc, dim = (_TET[1], 3) if is_tet(points, cells) else (_QUAD[1], 2)
    elif nn == 8:
        loc, dim = _HEX[1], 3
    else:
        raise ValueError(f"unsupported cell arity {nn}")

    n_cells = len(cells)
    centroids = points[cells].mean(axis=1)
    ci, lf, cj = match_facets(cells, loc)
    fverts = cells[ci[:, None], np.asarray(loc)[lf]]
    P = points[fverts]
    mid = P.mean(axis=1)
    nrm = _facet_normals(P)
    # orient outward from ci
    flip = rowdot(nrm, mid - centroids[ci]) < 0
    nrm[flip] = -nrm[flip]
    flux = rowdot(velocity_field(mid, dim, velocity, unit_velocity, curved),
                  nrm)

    # the reference's flux events in its order: each interior facet gives
    # (ci, cj, flux) then (cj, ci, -flux), each boundary facet (ci, -1,
    # flux); an outflow (f > 0) or boundary event adds to the diagonal
    n_int = int(np.sum(cj >= 0))
    a = np.concatenate([np.stack([ci[:n_int], cj[:n_int]], 1).ravel(),
                        ci[n_int:]])
    b = np.concatenate([np.stack([cj[:n_int], ci[:n_int]], 1).ravel(),
                        cj[n_int:]])
    f = np.concatenate([np.stack([flux[:n_int], -flux[:n_int]], 1).ravel(),
                        flux[n_int:]])
    on_diag = (b < 0) | (f > 0)
    # bincount sums in event order, as the reference's diag[a] += f
    diag = np.bincount(a[on_diag], weights=np.where(b < 0, np.abs(f), f)
                       [on_diag], minlength=n_cells)
    off = ~on_diag
    idx = np.arange(n_cells)
    A = sp.csr_matrix((np.concatenate([f[off], diag]),
                       (np.concatenate([a[off], idx]),
                        np.concatenate([b[off], idx]))),
                      shape=(n_cells, n_cells))
    A.sum_duplicates()
    A.eliminate_zeros()
    A.sort_indices()
    return A


def mesh_cells(cells: dict) -> np.ndarray:
    """The top-dimensional cell block of ``read_gmsh``'s dict."""
    name = ("hex" if "hex" in cells else "tet" if "tet" in cells
            else "quad" if "quad" in cells else "tri")
    return cells[name]


def advection_from_gmsh(path: str, velocity=None, unit_velocity: bool = True,
                        curved: bool = False) -> sp.csr_matrix:
    """Upwind advection operator on a Gmsh mesh (the reference's
    `-dm_plex_filename data/*.msh` test family in one call)."""
    points, cells = read_gmsh(path)
    return fv_upwind_advection(points, mesh_cells(cells), velocity=velocity,
                               unit_velocity=unit_velocity, curved=curved)
