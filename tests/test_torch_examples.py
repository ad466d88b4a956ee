"""The example and notebook twins (examples/torch/, notebooks/torch/) on
the CPU against the JAX package's examples and notebooks.

Each twin runs with ``device="cpu"`` at a small size (at most 64^2, or
the example's own size where it takes none).  An example twin's returned
numbers are held to what the JAX example prints at the same size (loaded
from examples/ and run in this process); where the print rounds a
number the test compares (complexities, ratios), or where the JAX
notebook cannot run here (its import-time ``jax.config`` calls, the
reference's mesh files), the test calls the JAX functions the example or
notebook calls, on the same inputs.  Iterations, level counts and CF
counts must be equal, complexities within 1e-5.
"""

import contextlib
import importlib.util
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pflare_tpu as jpf
from chip_smoke import run_notebook
from torch_reference import host_kernels  # noqa: F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = dict(a_lump=True, a_drop=1e-5, strong_threshold=0.99)
COMPLEXITIES = ("grid_complexity", "operator_complexity",
                "cycle_complexity", "storage_complexity")


def _load(path):
    name = "_ex_" + os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _quiet(fn, *args, **kw):
    """(fn's result, what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _jax_example(name, *args):
    """What examples/<name>.py prints from ``main(*args)``."""
    return _quiet(_load(os.path.join(REPO, "examples", name + ".py")).main,
                  *args)[1]


def _twin(name, *args, **kw):
    path = os.path.join(REPO, "examples", "torch", name + ".py")
    return _quiet(_load(path).main, *args, device="cpu", **kw)[0]


def _notebook(name, **params):
    path = os.path.join(REPO, "notebooks", "torch", name + ".py")
    return _quiet(run_notebook, path, device="cpu", **params)[0]


def _jax_stats(A, **opts):
    return jpf.PCAIR(jpf.AIROptions(**opts), jit=False).setup(A).stats()


def _same_stats(got, want):
    assert got["levels"] == want["levels"]
    for key in COMPLEXITIES:
        assert abs(got[key] - want[key]) < 1e-5, key


def _b(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


# ~~~~~~~~~~ the example twins ~~~~~~~~~~

def ex_airg_advection():
    n = 24
    text = _jax_example("ex_airg_advection", n)
    got = _twin("ex_airg_advection", n)
    m = re.search(r"converged=(\w+) in (\d+) iterations", text)
    assert (str(got["converged"]), got["iterations"]) == (
        m.group(1), int(m.group(2)))
    assert got["levels"] == int(
        re.search(r"levels requested/built: \d+/(\d+)", text).group(1))
    printed = [float(v) for v in re.findall(r"'([0-9.e+-]+)'", text)]
    np.testing.assert_allclose(got["history"], printed, rtol=5e-3)
    A = jpf.adv_diff_2d(n)
    _same_stats(got["pc"].stats(), _jax_stats(A, **BENCH))
    assert np.linalg.norm(A @ got["x"] - _b(A.shape[0])) <= 1e-9 * \
        np.linalg.norm(_b(A.shape[0]))


def ex_cf_splitting():
    text = _jax_example("ex_cf_splitting")
    got = _twin("ex_cf_splitting")
    want = {name: (int(f), int(c)) for name, f, c in re.findall(
        r"(\w+)\s*: (\d+) F / (\d+) C", text)}
    assert got["splittings"] == want
    rows = int(re.search(r"submatrix: (\d+) rows", text).group(1))
    assert got["diag_dom_rows"] == rows
    sub, _ = jpf.compute_diag_dom_submatrix(
        jpf.adv_diff_2d(50, curved_velocity=True), max_dd_ratio=0.5)
    from pflare_tpu.sparse.ops import diag_dominance_ratio

    want_ratio = diag_dominance_ratio(sub, np.ones(rows, dtype=bool)).max()
    assert abs(got["diag_dom_max_ratio"] - want_ratio) < 1e-12


def ex_complexities():
    text = _jax_example("ex_complexities")
    got = _twin("ex_complexities")
    opts = {"defaults": {}, "lump + drop": dict(a_lump=True, a_drop=1e-4),
            "matrix-free smoothing": dict(matrix_free_polys=True)}
    A = jpf.adv_diff_2d(64)
    for label, kw in opts.items():
        levels = int(re.search(rf"{re.escape(label)}: levels=(\d+)",
                               text).group(1))
        assert got["sets"][label]["levels"] == levels
        _same_stats(got["sets"][label], _jax_stats(A, **kw))
    want = _jax_stats(jpf.adv_diff_2d(8))["grid_complexity"]
    assert abs(got["ci_grid_complexity"] - want) < 1e-5
    assert f"grid complexity {want:.3f}" in text


def ex_device_setup():
    n = 16
    text = _jax_example("ex_device_setup", n)
    got = _twin("ex_device_setup", n)
    table = [tuple(int(v) for v in row) for row in re.findall(
        r"n=\s*(\d+)\s+F=\s*(\d+)\s+C=\s*(\d+)\s+nnz\(A\)=(\d+)", text)]
    assert got["device_levels"] == table
    sizes, sched = re.search(r"level sizes \[([\d, ]+)\]; active shards per "
                             r"level \[([\d, ]+)\]", text).groups()
    assert got["level_sizes"] == [int(v) for v in sizes.split(",")]
    assert got["schedule"] == [int(v) for v in sched.split(",")]
    want_diff = float(re.search(r"max abs diff: ([0-9.e+-]+)",
                                text).group(1))
    assert want_diff <= 1e-5 and got["sharded_max_abs_diff"] <= 1e-5
    want_res = float(re.search(r"true rel residual ([0-9.e+-]+)",
                               text).group(1))
    assert want_res <= 1e-5 and got["device_true_residual"] <= 1e-5


def ex_getcoeffs():
    text = _jax_example("ex_getcoeffs")
    got = _twin("ex_getcoeffs")
    n_coeffs = int(re.search(r"extracted (\d+) coefficients", text).group(1))
    assert len(got["coefficients"]) == n_coeffs
    A = jpf.adv_1d(400)
    pc = jpf.PCPFLAREINV(matrix_free=True, poly_order=10).setup(A)
    want = np.asarray(pc.get_poly_coeffs())
    np.testing.assert_allclose(got["coefficients"], want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max())
    # the checkpoint/restore difference, the JAX package's and the twin's
    pc2 = jpf.PCPFLAREINV(matrix_free=True, poly_order=10)
    pc2.set_poly_coeffs(want)
    pc2.setup(A)
    b = jnp.asarray(_b(400))
    want_diff = float(np.abs(np.asarray(pc.apply(b))
                             - np.asarray(pc2.apply(b))).max())
    assert "restored preconditioner identical: True" in text
    assert got["restored_identical"]
    assert got["restore_max_abs_diff"] <= 1e-14 and want_diff <= 1e-14
    orders = {}
    for lvl, order in re.findall(r"level (\d+): (order-\d+|diagonal)", text):
        orders[int(lvl)] = None if order == "diagonal" else int(order[6:])
    assert got["level_orders"] == orders


def ex_pflareinv_options():
    text = _jax_example("ex_pflareinv_options")
    got = _twin("ex_pflareinv_options")
    want = {(name, tag): (conv == "True", int(its))
            for name, tag, conv, its in re.findall(
                r"(\w+)\s+(assembled|mf)\s+converged=(\w+) its=(\d+)", text)}
    assert len(want) == 16 and got == want


def ex_reuse():
    text = _jax_example("ex_reuse")
    got = _twin("ex_reuse")
    its0 = int(re.search(r"full setup .* solve (\d+) its", text).group(1))
    its1 = int(re.search(r"reuse setup .* solve (\d+) its", text).group(1))
    assert (got["iterations"], got["iterations_reuse"]) == (its0, its1)
    assert got["frozen_setup_s"] < got["full_setup_s"]


def ex_scaling():
    sizes = (12, 16, 20)
    text = _jax_example("ex_scaling", sizes)
    got = _twin("ex_scaling", sizes)
    printed = re.findall(r"(\d+)\^2\s+(\d+)\s+(\d+)\s+([0-9.]+)", text)
    assert len(printed) == len(sizes) and "NOT CONVERGED" not in text
    for row, (n, dofs, its, _) in zip(got["rows"], printed):
        assert (row["n"], row["dofs"], row["iterations"]) == (
            int(n), int(dofs), int(its))
        assert row["converged"]
        want = _jax_stats(jpf.adv_diff_2d(row["n"]), **BENCH)
        assert abs(row["grid_complexity"] - want["grid_complexity"]) < 1e-5


# ~~~~~~~~~~ the notebook twins ~~~~~~~~~~

def nb01_intro_pcair():
    sizes = (16, 24, 32)
    got = _notebook("01_intro_pcair", n_grid=32, sizes=sizes)["results"]
    A = jpf.adv_diff_2d(32)
    res = jpf.gmres(jpf.ELL.from_scipy(A), jnp.asarray(_b(A.shape[0])),
                    rtol=1e-8, max_it=60)
    assert got["no_pc"] == (res.converged, res.iterations)
    for n in sizes:
        An = jpf.adv_diff_2d(n)
        pc = jpf.PCAIR(jpf.AIROptions(**BENCH), jit=False).setup(An)
        r = pc.solve(jnp.asarray(_b(An.shape[0])), rtol=1e-10, atol=1e-50,
                     side="right")
        its, gc, levels = got["airg"][n]
        assert (its, levels) == (r.iterations, pc.n_levels)
        assert abs(gc - pc.stats()["grid_complexity"]) < 1e-5


def nb02_polynomial_inverses():
    got = _notebook("02_polynomial_inverses")["results"]
    A = jpf.random_diag_dominant(500, 0.02, seed=1)
    E = jpf.ELL.from_scipy(A)
    b = jnp.asarray(_b(500))
    for t in ("POWER", "ARNOLDI", "NEWTON"):
        for order in (2, 6, 12):
            inv = jpf.build_inverse(E, jpf.InverseType[t], poly_order=order,
                                    matrix_free=True, A_scipy=A)
            r = jpf.gmres(E, b, M=inv.apply, rtol=1e-8, max_it=100)
            assert got["mf"][(t, order)] == r.iterations, (t, order)
    inv = jpf.build_inverse(E, jpf.InverseType.ARNOLDI, poly_order=6,
                            sparsity_order=1, A_scipy=A)
    r = jpf.gmres(E, b, M=inv.apply, rtol=1e-8, max_it=100)
    assert got["assembled"] == (inv.mat.nnz, r.iterations)
    want = np.asarray(jpf.PCPFLAREINV(matrix_free=True).setup(A)
                      .get_poly_coeffs())
    np.testing.assert_allclose(got["coefficients"], want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max())


def nb03_cf_splittings():
    from pflare_tpu.cf import ddc, pmisr, strength_matrix
    from pflare_tpu.sparse.ops import diag_dominance_ratio

    got = _notebook("03_cf_splittings", n_grid=20)["results"]
    A = jpf.adv_diff_2d(20, curved_velocity=True)
    cf = pmisr(strength_matrix(A, theta=0.5, symmetrize=True),
               max_luby_steps=-1)
    cf2, _ = ddc(A, cf.copy(), fraction_swap=0.1)
    for key, markers in (("pmisr", cf), ("ddc", cf2)):
        f_mask = markers == jpf.F_POINT
        r = diag_dominance_ratio(A, f_mask)
        n_f, r_max, r_mean = got[key]
        assert n_f == int(f_mask.sum())
        assert abs(r_max - r.max()) < 1e-12 and abs(r_mean - r.mean()) < 1e-12
    b = jnp.asarray(_b(A.shape[0]))
    for name, (its, gc) in got["solves"].items():
        pc = jpf.PCAIR(jpf.AIROptions(
            cf_splitting_type=jpf.CFSplittingType[name]), jit=False).setup(A)
        assert its == pc.solve(b, rtol=1e-8, max_it=40).iterations, name
        assert abs(gc - pc.stats()["grid_complexity"]) < 1e-5, name
    sub, _ = jpf.compute_diag_dom_submatrix(A, max_dd_ratio=0.6)
    rs = diag_dominance_ratio(sub, np.ones(sub.shape[0], dtype=bool))
    assert got["diag_dom"][0] == sub.shape[0]
    assert abs(got["diag_dom"][1] - rs.max()) < 1e-12


def nb04_parallel_mesh():
    from pflare_tpu import parallel as jpar
    from pflare_tpu.air.smooth import vcycle_kaskade

    got = _notebook("04_parallel_mesh", n_grid=32)["results"]
    assert got["sharded_spmv_matches"] and got["tsqr_matches"]
    mesh = jpar.make_mesh(8)
    A = jpf.adv_diff_2d(32)
    xr = _b(A.shape[0])
    want_err = float(np.abs(np.asarray(jpar.HaloSpMV(A, mesh) @ xr)
                            - A @ xr).max())
    assert got["halo_max_err"] <= max(want_err, 1e-13)
    pc = jpf.PCAIR(jpf.AIROptions(max_levels=4), jit=False).setup(A)
    levels, coarse_inv = jpar.shard_hierarchy(pc.hierarchy, mesh)
    b = jpar.shard_vec(jnp.ones(A.shape[0]), mesh)
    z = jax.jit(lambda lv, ci, b: vcycle_kaskade(lv, ci, b, (2,)))(
        levels, coarse_inv, b)
    want = float(jnp.linalg.norm(z))
    assert abs(got["vcycle_norm"] - want) <= 1e-10 * want


def nb05_reuse_device_resetup():
    got = _notebook("05_reuse_device_resetup", n_grid=20)["results"]
    A = jpf.adv_diff_2d(20)
    pc = jpf.PCAIR(jpf.AIROptions(reuse_sparsity=True, reuse_amount=3,
                                  reuse_poly_coeffs=True), jit=False)
    pc.setup(A)
    assert got["levels"] == pc.n_levels
    rng = np.random.default_rng(0)
    A2 = A.copy()
    A2.data = A2.data * (1 + 1e-3 * rng.standard_normal(A2.nnz))
    pc.setup(A2, structure="same")
    b = jnp.ones(A.shape[0])
    assert got["host_resetup_iterations"] == pc.solve(
        b, rtol=1e-8, max_it=20).iterations
    # the twin's device re-setups against the reference's host re-setup
    # on the same matrices (its device re-setup is known fault 1)
    assert len(got["steps"]) == 3
    for A_t, its in got["steps"]:
        pc.setup(A_t, structure="same")
        assert its == pc.solve(b, rtol=1e-8, max_it=20).iterations


def nb06_meshes_and_fem():
    ns = _notebook("06_meshes_and_fem", m=10, annulus=(2, 8, 2))
    got = ns["results"]
    pts, cells = jpf.read_gmsh(ns["SQUARE"])
    assert got["square"] == (len(pts), {k: v.shape for k, v in cells.items()})
    A = jpf.dg1_advection_from_gmsh(ns["SQUARE"])
    assert (A != ns["A"]).nnz == 0
    flux = float(np.asarray(A @ np.ones(A.shape[0])).sum())
    assert abs(got["dg1"][1] - flux) < 1e-12 and got["dg1"][0] == A.shape[0]

    def richardson_its(M, opts, seed, max_it):
        pc = jpf.PCAIR(jpf.AIROptions(**opts), jit=False).setup(M)
        res = pc.solve(jnp.asarray(_b(M.shape[0], seed)), ksp="richardson",
                       rtol=1e-5, max_it=max_it)
        return pc.n_levels, res.iterations

    assert got["dg1"][2] == richardson_its(A, {}, 0, 4)[1]
    A_ann = jpf.dg1_advection_from_gmsh(ns["ANNULUS"],
                                        velocity=(0.0, 0.0, 1.0))
    levels, its = richardson_its(
        A_ann, dict(a_lump=True, smooth_order=(1, -1, 1)), 1, 4)
    assert got["annulus"] == (A_ann.shape[0], levels, its)
    A_s = jpf.supg_from_gmsh(ns["SQUARE"], curved=True, unit_velocity=False)
    d = np.abs(A_s.diagonal())
    assert abs(got["supg"]["diag_ratio"] - d.max() / d.min()) < 1e-9
    for ds in (False, True):
        assert got["supg"][ds] == richardson_its(
            A_s, dict(a_lump=True, diag_scale_polys=ds), 2, 20)[1]


TWINS = {f.__name__: f for f in (
    ex_airg_advection, ex_cf_splitting, ex_complexities, ex_device_setup,
    ex_getcoeffs, ex_pflareinv_options, ex_reuse, ex_scaling,
    nb01_intro_pcair, nb02_polynomial_inverses, nb03_cf_splittings,
    nb04_parallel_mesh, nb05_reuse_device_resetup, nb06_meshes_and_fem)}


@pytest.mark.parametrize("twin", list(TWINS))
def test_twin_matches_reference(host_kernels, twin):
    TWINS[twin]()


def test_twins_refuse_a_missing_card():
    """A twin asked for the card raises when there is none (and its
    ``--device`` flag defaults to it)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = os.path.join(REPO, "examples", "torch", "ex_reuse.py")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(path).main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_notebook(os.path.join(REPO, "notebooks", "torch",
                                  "01_intro_pcair.py"))
    assert "default=\"cuda\"" in open(path).read()
