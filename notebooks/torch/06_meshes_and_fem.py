# %% [markdown]
# # Unstructured meshes: Gmsh import, DG upwind and SUPG CG FEM, on a GPU
#
# The reference's hardest test operators come from FEM discretisations on
# unstructured Gmsh meshes read through DMPlex (reference:
# tests/adv_dg_upwind.c, tests/adv_diff_cg_supg.c).  The same pipeline
# here: a numpy Gmsh 4.1 reader, an upwinded DG(1) assembly (broken nodal
# spaces, isoparametric hexes), and SUPG-stabilised continuous Galerkin
# advection-diffusion; the assemblies run on the host, the solves on the
# device.
#
# The PyTorch twin of notebooks/06_meshes_and_fem.py.  The reference's
# mesh files (`square_unstruc.msh`, `annulus_twisted.msh`) are not in this
# repository, so this notebook generates its meshes -- jittered Delaunay
# triangles on the unit square and a twisted hex annulus -- writes them as
# Gmsh 4.1 ASCII into a temporary directory with the small writer below,
# and reads them back.  Set `device = "cpu"` in the parameters cell to run
# it without a card.

# %%
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch
from scipy.spatial import Delaunay

import pflare_tpu_torch as pt

# %% tags=["parameters"]
device = "cuda"          # "cpu" runs each kernel's plain PyTorch version
dtype = torch.float64
m = 32                   # square: 2 m^2 triangles
annulus = (2, 16, 4)     # twisted annulus: radial, around, axial hexes

# %%
if torch.device(device).type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device: set device = 'cpu'")
results = {}

# %% [markdown]
# ## Making and writing the meshes
#
# The square: an (m+1)^2 grid whose interior points are jittered by up to
# 0.3 of a spacing, triangulated by Delaunay.  The annulus: hexes on
# 0.5 <= r <= 1, 0 <= z <= 1, twisted by half a radian over the height.
# `write_gmsh` writes one cell block with node tags 1..n and coordinates
# to 17 digits, so they read back exactly.

# %%
def square_mesh(m, seed=0, jitter=0.3):
    rng = np.random.default_rng(seed)
    g = np.linspace(0.0, 1.0, m + 1)
    pts = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    inner = np.all((pts > 0) & (pts < 1), axis=1)
    pts[inner] += rng.uniform(-jitter, jitter, (inner.sum(), 2)) / m
    return pts, Delaunay(pts).simplices.astype(np.int64)


def twisted_annulus(nr, nt, nz, twist=0.5, r0=0.5, r1=1.0):
    r, z = np.linspace(r0, r1, nr + 1), np.linspace(0.0, 1.0, nz + 1)
    R, T, Z = np.meshgrid(r, np.arange(nt) * (2 * np.pi / nt), z,
                          indexing="ij")
    T = T + twist * Z
    pts = np.stack([R * np.cos(T), R * np.sin(T), Z], -1).reshape(-1, 3)
    a, b, c = (x.ravel() for x in np.meshgrid(
        np.arange(nr), np.arange(nt), np.arange(nz), indexing="ij"))

    def vid(i, j, k):
        return (i * nt + j % nt) * (nz + 1) + k

    return pts, np.stack([
        vid(a, b, c), vid(a + 1, b, c), vid(a + 1, b + 1, c),
        vid(a, b + 1, c), vid(a, b, c + 1), vid(a + 1, b, c + 1),
        vid(a + 1, b + 1, c + 1), vid(a, b + 1, c + 1)], 1)


def write_gmsh(path, points, cells):
    """Gmsh 4.1 ASCII: triangles (type 2) in 2D or hexes (type 5) in 3D."""
    dim, etype = (2, 2) if cells.shape[1] == 3 else (3, 5)
    pts = np.zeros((len(points), 3))
    pts[:, :points.shape[1]] = points
    n, k = len(pts), len(cells)
    row = " ".join(["%d"] * (cells.shape[1] + 1))
    tagged = np.hstack([np.arange(1, k + 1)[:, None], cells + 1])
    with open(path, "w") as f:
        f.write(f"$MeshFormat\n4.1 0 8\n$EndMeshFormat\n$Nodes\n1 {n} 1 {n}"
                f"\n{dim} 1 0 {n}\n")
        f.write("\n".join(map(str, range(1, n + 1))) + "\n")
        f.write("\n".join("%.17g %.17g %.17g" % tuple(p)
                          for p in pts.tolist()) + "\n")
        f.write(f"$EndNodes\n$Elements\n1 {k} 1 {k}\n{dim} 1 {etype} {k}\n")
        f.write("\n".join(row % tuple(c) for c in tagged.tolist()) + "\n")
        f.write("$EndElements\n")


# the files live as long as this notebook's namespace holds TMP
TMP = tempfile.TemporaryDirectory()
DATA = TMP.name
SQUARE = os.path.join(DATA, "square_unstruc.msh")
ANNULUS = os.path.join(DATA, "annulus_twisted.msh")
write_gmsh(SQUARE, *square_mesh(m))
write_gmsh(ANNULUS, *twisted_annulus(*annulus))

# %% [markdown]
# ## Reading a mesh

# %%
pts, cells = pt.read_gmsh(SQUARE)
print("square_unstruc:", len(pts), "points,",
      {k: v.shape for k, v in cells.items()})
results["square"] = (len(pts), {k: v.shape for k, v in cells.items()})

# %% [markdown]
# ## DG(1) upwind advection
#
# Each cell owns its nodal DoFs; the upwind numerical flux couples cells
# across facets.  The operator is strongly asymmetric -- AIR's target
# regime.  Consistency check: A @ 1 is supported only on inflow-boundary
# DoFs and sums to the total inflow flux.

# %%
A = pt.dg1_advection_from_gmsh(SQUARE)
r = np.asarray(A @ np.ones(A.shape[0]))
print(f"DG(1): {A.shape[0]} DoFs, inflow flux sum = {r.sum():.12f} "
      f"(exact sqrt(2) = {np.sqrt(2):.12f})")

pc = pt.PCAIR(pt.AIROptions(), dtype=dtype, device=device)
pc.setup(A)
b = np.random.default_rng(0).standard_normal(A.shape[0])
res = pc.solve(b, ksp="richardson", rtol=1e-5, max_it=4)
print("AIRG Richardson:", res.iterations, "iterations (reference cap 4)")
results["dg1"] = (A.shape[0], float(r.sum()), res.iterations)

# %% [markdown]
# ## A genuinely hard mesh: the twisted annulus
#
# 3D hexahedra twisted along the axis with axial flow -- the advection
# characteristics wrap around the annulus, producing cycles in the
# connectivity graph (the reference's "hexs and cycles" case).

# %%
A_ann = pt.dg1_advection_from_gmsh(ANNULUS, velocity=(0.0, 0.0, 1.0))
pc = pt.PCAIR(pt.AIROptions(a_lump=True, smooth_order=(1, -1, 1)),
              dtype=dtype, device=device)
pc.setup(A_ann)
b = np.random.default_rng(1).standard_normal(A_ann.shape[0])
res = pc.solve(b, ksp="richardson", rtol=1e-5, max_it=4)
print(f"annulus: {A_ann.shape[0]} DoFs, {pc.n_levels} levels, "
      f"{res.iterations} iterations")
results["annulus"] = (A_ann.shape[0], pc.n_levels, res.iterations)

# %% [markdown]
# ## SUPG CG advection-diffusion and diagonal scaling
#
# The curved, unnormalised velocity field produces a badly row-scaled
# operator (the reference's "poorly scaled" test): GMRES polynomials
# degrade unless they are computed on the diagonally scaled operator
# (`diag_scale_polys`, the `-pc_air_diag_scale_polys` flag).

# %%
A_s = pt.supg_from_gmsh(SQUARE, curved=True, unit_velocity=False)
d = np.abs(A_s.diagonal())
print(f"SUPG operator: diag ratio {d.max()/d.min():.0f}x")
results["supg"] = {"diag_ratio": float(d.max() / d.min())}
for ds in (False, True):
    pc = pt.PCAIR(pt.AIROptions(a_lump=True, diag_scale_polys=ds),
                  dtype=dtype, device=device)
    pc.setup(A_s)
    b = np.random.default_rng(2).standard_normal(A_s.shape[0])
    res = pc.solve(b, ksp="richardson", rtol=1e-5, max_it=20)
    print(f"diag_scale_polys={ds}: {res.iterations} iterations")
    results["supg"][ds] = res.iterations
