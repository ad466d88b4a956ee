"""The port's problem readers and unstructured assemblies against the JAX
reference, on the CPU, and ``Hierarchy.compact_host``.

The reference's own mesh files are not in the repository, so the meshes
are generated from seeds (tests/torch_cases.py: jittered Delaunay
triangles and tets, structured triangles and quads, a twisted-annulus
hex mesh) and written as Gmsh 4.1 ASCII into ``tmp_path``.  The readers
agree bit for bit; every assembly has the reference's pattern and values
within 1e-14 of its largest entry; PCAIR on an assembled matrix has the
reference's CF markers, nnz, ``apply`` (1e-10) and Richardson
iterations.  Sizes stay at about 1,500 cells or fewer, so the reference's
per-cell loops take well under a second.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

import pflare_tpu as jpf
import pflare_tpu.problems as jprob
import pflare_tpu_torch as tpf
import pflare_tpu_torch.problems as tprob
from pflare_tpu_torch.air.hierarchy import HostShim
from pflare_tpu_torch.sparse import BandedSpMV
from torch_cases import (GMSH_TYPE, annulus_hex_mesh, quad_mesh,
                         structured_tri_mesh, tet_mesh, tri_mesh, write_gmsh)
from torch_reference import host_kernels  # noqa: F401

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
ASSEMBLY_RTOL = 1e-14


def _meshes():
    return {"tri": tri_mesh(20), "stri": structured_tri_mesh(14),
            "quad": quad_mesh(14), "tet": tet_mesh(5),
            "hex": annulus_hex_mesh(4, 16, 6)}


MESHES = _meshes()


def _same(A, B, rtol=ASSEMBLY_RTOL):
    """Equal shape and pattern, values within ``rtol`` of A's largest."""
    A, B = sp.csr_matrix(A), sp.csr_matrix(B)
    assert A.shape == B.shape
    assert np.array_equal(A.indptr, B.indptr)
    assert np.array_equal(A.indices, B.indices)
    scale = np.abs(A.data).max(initial=0.0)
    assert np.abs(A.data - B.data).max(initial=0.0) <= rtol * scale


def _boundary_edges(cells, loc):
    """The facets that only one cell has (lower-dimensional elements to
    mix into a file)."""
    f = cells[:, np.asarray(loc)].reshape(-1, len(loc[0]))
    key, inv, cnt = np.unique(np.sort(f, axis=1), axis=0,
                              return_inverse=True, return_counts=True)
    return f[cnt[inv.ravel()] == 1]


def _mesh_file(tmp_path, name):
    """A Gmsh file of one mesh with mixed blocks: the cells split in two
    blocks, plus boundary segments (2-D) or boundary faces (3-D), an empty
    block and a point element, which the readers drop."""
    from pflare_tpu_torch.problems.gmsh import _HEX, _QUAD, _TET, _TRI

    pts, cells = MESHES[name]
    half = len(cells) // 2
    if name in ("tri", "stri", "quad"):
        loc = (_QUAD if name == "quad" else _TRI)[1]
        etype = GMSH_TYPE[cells.shape[1]]
        lower = [(1, _boundary_edges(cells, loc))]
    else:
        etype = 4 if name == "tet" else 5
        loc = (_TET if name == "tet" else _HEX)[1]
        faces = _boundary_edges(cells, loc)
        lower = [(GMSH_TYPE[faces.shape[1]], faces)]
    blocks = ([(15, np.zeros((1, 1), np.int64)),
               (1, np.zeros((0, 2), np.int64))] + lower
              + [(etype, cells[:half]), (etype, cells[half:])])
    return write_gmsh(str(tmp_path / f"{name}.msh"), pts, blocks), pts, cells


@pytest.mark.parametrize("name", ["tri", "quad", "tet", "hex"])
def test_read_gmsh_matches_reference(tmp_path, name):
    """Points and cells bit for bit with the reference's reader (shuffled
    node tags in two blocks, two cell blocks, lower-dimensional elements
    dropped), both equal to the mesh written; the ``*_from_gmsh``
    wrappers take the top-dimensional block as the reference's do."""
    path, pts, cells = _mesh_file(tmp_path, name)
    jp, jc = jprob.read_gmsh(path)
    tp, tc = tprob.read_gmsh(path)
    assert np.array_equal(jp, tp) and tp.dtype == np.float64
    assert sorted(jc) == sorted(tc) == [{"tri": "tri", "quad": "quad",
                                        "tet": "tet", "hex": "hex"}[name]]
    for key in jc:
        assert np.array_equal(jc[key], tc[key])
        assert np.array_equal(tc[key], cells)
    assert np.array_equal(tp[:, :pts.shape[1]], pts)
    kw = dict(velocity=(0.0, 0.0, 1.0)) if name == "hex" else {}
    _same(jprob.advection_from_gmsh(path, **kw),
          tpf.advection_from_gmsh(path, **kw))
    if name in ("tri", "tet"):
        _same(jprob.supg_from_gmsh(path), tpf.supg_from_gmsh(path))
    if name == "quad":
        _same(jprob.dg1_advection_from_gmsh(path),
              tpf.dg1_advection_from_gmsh(path))


def _write_petsc(path, A, vecs=()):
    A = sp.csr_matrix(A)
    with open(path, "wb") as f:
        np.array([1211216, A.shape[0], A.shape[1], A.nnz], ">i4").tofile(f)
        np.diff(A.indptr).astype(">i4").tofile(f)
        A.indices.astype(">i4").tofile(f)
        A.data.astype(">f8").tofile(f)
        for v in vecs:
            np.array([1211214, len(v)], ">i4").tofile(f)
            np.asarray(v, ">f8").tofile(f)
    return path


def test_read_petsc_matrix_matches_reference(tmp_path):
    """Matrix and appended vectors bit for bit, ``return_vecs`` with and
    without; a vector file is refused as a matrix by both."""
    rng = np.random.default_rng(4)
    A = sp.random(57, 43, density=0.1, random_state=5, format="csr")
    vecs = [rng.standard_normal(57), rng.standard_normal(43)]
    path = _write_petsc(str(tmp_path / "mat"), A, vecs)
    for ret in (False, True):
        J, T = (pkg.read_petsc_matrix(path, return_vecs=ret)
                for pkg in (jprob, tprob))
        if ret:
            (J, jv), (T, tv) = J, T
            assert len(jv) == len(tv) == 2
            for a, b, v in zip(jv, tv, vecs):
                assert np.array_equal(a, b) and np.array_equal(b, v)
        for attr in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(J, attr), getattr(T, attr))
        assert T.shape == (57, 43) and abs(T - A).max() == 0
    vec = str(tmp_path / "vec")
    with open(vec, "wb") as f:
        np.array([1211214, 3], ">i4").tofile(f)
        np.arange(3.0).astype(">f8").tofile(f)
    for pkg in (jprob, tprob):
        with pytest.raises(ValueError, match="not a PETSc binary matrix"):
            pkg.read_petsc_matrix(vec)


def test_read_petsc_vec_matches_reference(tmp_path):
    """A vector bit for bit; a matrix file is refused as a vector by
    both."""
    v = np.random.default_rng(6).standard_normal(31)
    path = str(tmp_path / "vec")
    with open(path, "wb") as f:
        np.array([1211214, len(v)], ">i4").tofile(f)
        v.astype(">f8").tofile(f)
    a, b = jprob.read_petsc_vec(path), tprob.read_petsc_vec(path)
    assert np.array_equal(a, b) and np.array_equal(b, v)
    mat = _write_petsc(str(tmp_path / "mat"), sp.eye(4, format="csr"))
    for pkg in (jprob, tprob):
        with pytest.raises(ValueError, match="not a PETSc binary vector"):
            pkg.read_petsc_vec(mat)


def _swirl(x):
    """A callable velocity (x is the point as each assembly passes it)."""
    return (1.0 + x[1], 0.5 - x[0] * x[0])


# (mesh, keywords): every cell type each assembly supports, curved and
# constant 2-vector velocities, a callable, unit_velocity=False, and the
# structured triangles whose diagonal facets are tangent to (1,1)
ADVECTION_CASES = {
    "tri": ("tri", {}),
    "tri-tangent": ("stri", {}),
    "quad": ("quad", {}),
    "quad-x": ("quad", dict(velocity=(1.0, 0.0))),
    "tet": ("tet", {}),
    "hex-axial": ("hex", dict(velocity=(0.0, 0.0, 1.0))),
    "tri-curved": ("tri", dict(curved=True)),
    "tet-curved": ("tet", dict(curved=True)),
    "hex-curved": ("hex", dict(curved=True)),
    "tri-constant": ("tri", dict(velocity=(0.3, -1.0))),
    "tri-callable": ("tri", dict(velocity=_swirl)),
    "tri-curved-not-unit": ("tri", dict(curved=True, unit_velocity=False)),
}


@pytest.mark.parametrize("case", list(ADVECTION_CASES))
def test_fv_matches_reference(case):
    name, kw = ADVECTION_CASES[case]
    pts, cells = MESHES[name]
    _same(jprob.fv_upwind_advection(pts, cells, **kw),
          tprob.fv_upwind_advection(pts, cells, **kw))


@pytest.mark.parametrize("case", list(ADVECTION_CASES))
def test_dg1_matches_reference(case):
    name, kw = ADVECTION_CASES[case]
    pts, cells = MESHES[name]
    _same(jprob.dg1_upwind_advection(pts, cells, **kw),
          tprob.dg1_upwind_advection(pts, cells, **kw))


SUPG_CASES = {
    "tri": ("tri", {}),
    "tet": ("tet", {}),
    "tri-curved-not-unit": ("tri", dict(curved=True, unit_velocity=False)),
    "tri-diffusion": ("tri", dict(alpha=1.0, velocity=(0.0, 0.0),
                                  unit_velocity=False)),
    "stri-diffusion": ("stri", dict(alpha=1.0, velocity=(0.0, 0.0),
                                    unit_velocity=False)),
    "tri-advection-diffusion": ("tri", dict(alpha=0.01)),
    "tet-curved-diffusion": ("tet", dict(alpha=1e-3, curved=True)),
    "tri-callable": ("tri", dict(alpha=0.05, velocity=_swirl)),
}


@pytest.mark.parametrize("case", list(SUPG_CASES))
def test_supg_matches_reference(case):
    """The operator and ``return_free``'s free vertices."""
    name, kw = SUPG_CASES[case]
    pts, cells = MESHES[name]
    A, free_a = jprob.supg_advection_diffusion(pts, cells, return_free=True,
                                               **kw)
    B, free_b = tprob.supg_advection_diffusion(pts, cells, return_free=True,
                                               **kw)
    assert np.array_equal(free_a, free_b)
    _same(A, B)
    _same(A, tprob.supg_advection_diffusion(pts, cells, **kw))


def test_tangent_facets_take_the_references_branch():
    """On the structured triangles the diagonal facets are tangent to the
    default velocity: v.n is zero up to the rounding of the dot product,
    and which side of zero it falls decides the pattern.  The port's
    batched dots round as the reference's, so the operators are equal
    bit for bit, and the diagonal couplings are absent or negligible."""
    pts, cells = MESHES["stri"]
    for fn in ("fv_upwind_advection", "dg1_upwind_advection"):
        A = getattr(jprob, fn)(pts, cells)
        B = getattr(tprob, fn)(pts, cells)
        assert (A != B).nnz == 0
    A = tprob.fv_upwind_advection(pts, cells)
    off = A - sp.diags(A.diagonal())
    # each cell couples to its two axis-aligned upwind neighbours at most
    big = np.abs(off).max(axis=1).toarray().ravel()
    assert np.all(np.abs(off).multiply(abs(off) > 1e-12 * big.max())
                  .getnnz(axis=1) <= 2)


# ~~~~~~~~~~ the whole slice: PCAIR on an assembled mesh operator ~~~~~~~~~~

SLICE_CASES = {
    # the FV operator of chip_smoke phase 14 (a): a_lump, RCM reorder of
    # the scrambled cells (the top level becomes banded)
    "fv": ("fv_upwind_advection", 24, dict(a_lump=True, reorder="auto"), 6),
    # the DG(1) operator of phase 14 (b)
    "dg1": ("dg1_upwind_advection", 12, dict(reorder="auto"), 8),
}


@pytest.mark.parametrize("case", list(SLICE_CASES))
def test_pcair_on_mesh_matches_reference(case, host_kernels):
    """Mesh -> assembly -> PCAIR in both packages: CF markers and nnz by
    level equal, ``apply`` within 1e-10, and the Richardson iterations
    (rtol 1e-5) and norms of the reference's solve."""
    fn, m, kw, cap = SLICE_CASES[case]
    pts, cells = tri_mesh(m, seed=3)
    A = getattr(tprob, fn)(pts, cells)
    _same(getattr(jprob, fn)(pts, cells), A)
    jpc = jpf.PCAIR(jpf.AIROptions(**kw), jit=False).setup(A)
    tpc = tpf.PCAIR(tpf.AIROptions(**kw), **F64).setup(A)
    assert tpc._perm is not None
    assert np.array_equal(np.asarray(jpc._perm), tpc._perm.numpy())
    if case == "fv":
        assert isinstance(tpc.upload().top, BandedSpMV)
    assert len(jpc.hierarchy.levels) == len(tpc.hierarchy.levels) > 1
    for a, b in zip(jpc.hierarchy.levels, tpc.hierarchy.levels):
        assert np.array_equal(a.fine, b.fine)
        assert np.array_equal(a.coarse, b.coarse)
        for name in ("A", "A_ff", "A_fc", "R", "P"):
            assert getattr(a, name).nnz == getattr(b, name).nnz, name
    r = np.random.default_rng(1).standard_normal(A.shape[0])
    y_ref = np.asarray(jpc.apply(jnp.asarray(r)))
    y = tpc.apply(r).numpy()
    assert np.linalg.norm(y - y_ref) <= 1e-10 * np.linalg.norm(y_ref)
    jres = jpc.solve(jnp.asarray(r), ksp="richardson", rtol=1e-5,
                     max_it=cap)
    tres = tpc.solve(r, ksp="richardson", rtol=1e-5, max_it=cap)
    assert tres.converged and jres.converged
    assert tres.iterations == jres.iterations
    np.testing.assert_allclose(tres.history, np.asarray(jres.history),
                               rtol=1e-8, atol=0)
    x = tres.x.numpy()
    assert np.linalg.norm(A @ x - r) <= 1e-4 * np.linalg.norm(r)


# ~~~~~~~~~~ Hierarchy.compact_host ~~~~~~~~~~

def _fv_operator():
    pts, cells = tri_mesh(24, seed=3)
    return tprob.fv_upwind_advection(pts, cells)


def test_compact_host_after_upload():
    """Without sparsity reuse the upload compacts the host hierarchy:
    level matrices become nnz/shape shims, the top A stays a matrix, and
    ``stats()`` is unchanged (the counterpart of the reference's
    tests/test_air.py::test_host_memory_economy)."""
    A = _fv_operator()
    pc = tpf.PCAIR(tpf.AIROptions(a_lump=True), **F64).setup(A)
    s0 = pc.stats()
    assert not pc.hierarchy.compacted
    res = pc.solve(np.ones(A.shape[0]), ksp="richardson", rtol=1e-5,
                   max_it=6)
    assert res.converged
    h = pc.hierarchy
    assert h.compacted and h.pending_uploads == 0
    assert pc.host_bytes_released > 0
    assert isinstance(h.levels[1].A, HostShim)
    assert isinstance(h.levels[0].A_ff, HostShim)
    assert isinstance(h.levels[0].R, HostShim)
    assert h.levels[0].inv_Aff_host is None
    assert isinstance(h.levels[0].patterns["coarse_A"], HostShim)
    assert sp.issparse(h.levels[0].A)       # the top is kept
    assert pc.stats() == s0
    again = pc.solve(np.ones(A.shape[0]), ksp="richardson", rtol=1e-5,
                     max_it=6)
    assert again.iterations == res.iterations


def test_twin_made_before_upload_still_solves():
    """A twin registered by ``on`` before the upload still uploads after
    it and solves as the first PCAIR does; the hierarchy is compacted at
    the twin's upload, the last pending one."""
    A = _fv_operator()
    pc = tpf.PCAIR(tpf.AIROptions(a_lump=True), **F64).setup(A)
    twin = pc.on("cpu")
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    res = pc.solve(b, ksp="richardson", rtol=1e-5, max_it=6)
    assert not pc.hierarchy.compacted and pc.hierarchy.pending_uploads == 1
    assert sp.issparse(pc.hierarchy.levels[1].A)
    tres = twin.solve(b, ksp="richardson", rtol=1e-5, max_it=6)
    assert pc.hierarchy.compacted and twin.host_bytes_released > 0
    assert tres.iterations == res.iterations
    np.testing.assert_allclose(tres.history, res.history, rtol=1e-12)


def test_on_after_compaction_raises():
    A = _fv_operator()
    pc = tpf.PCAIR(tpf.AIROptions(a_lump=True), **F64).setup(A)
    pc.upload()
    with pytest.raises(ValueError, match="compacted"):
        pc.on("cpu")
    # a new setup starts a new host hierarchy
    pc.setup(A)
    assert pc.on("cpu").hierarchy is pc.hierarchy


def test_no_compaction_under_reuse():
    """With ``reuse_sparsity`` the host hierarchy survives the upload, and
    the same-pattern re-setup consumes it."""
    A = _fv_operator()
    pc = tpf.PCAIR(tpf.AIROptions(a_lump=True, reuse_sparsity=True,
                                  reuse_amount=2), **F64).setup(A)
    pc.upload()
    assert not pc.hierarchy.compacted
    assert sp.issparse(pc.hierarchy.levels[1].A)
    assert pc.host_bytes_released == 0
    pc.setup(A * 1.05, "same")
    res = pc.solve(np.ones(A.shape[0]), ksp="richardson", rtol=1e-5,
                   max_it=6)
    assert res.converged
