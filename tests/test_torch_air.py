"""The port's AIR main path against the JAX reference, on the CPU.

Same matrix, same seeds, f64 (and the f32 host setup of the bench):
CF markers, level sizes and nnz are identical; coefficients and operator
values agree to 1e-12; ``apply`` to 1e-10; the Richardson norm history of
``solve_device`` to 1e-8 of the initial norm; the host-driven GMRES
(``eager=True``) iteration counts equal the reference's.  Every test
that holds the port against the reference takes the ``host_kernels``
fixture (tests/torch_reference.py), so both packages run their setup on
the same host kernels.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

import pflare_tpu as jpf
from pflare_tpu.sparse import ELL as JELL
import pflare_tpu_torch as tpf
from pflare_tpu_torch import native as tnative
from pflare_tpu_torch.air.smooth import vcycle_kaskade
from pflare_tpu_torch.convert import hierarchy_from_numpy
from torch_reference import NATIVE, NUMPY, host_kernels, pair_host_kernels  # noqa: F401

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")


def bench_kw(pkg, coarse_order=24, max_levels=6):
    """The main path's options (bench.py:430-436) in either package."""
    return pkg.AIROptions(
        a_lump=True, a_drop=1e-5, strong_threshold=0.99,
        max_levels=max_levels,
        coarsest_inverse_type=pkg.InverseType.NEWTON,
        coarsest_poly_order=coarse_order, coarsest_matrix_free_polys=True)


def rhs(n, seed=3):
    return np.random.default_rng(seed).standard_normal(n)


def _snapshot(h):
    """Host matrices and inverses of a hierarchy, taken right after setup
    (the reference frees its host copies once it uploads)."""
    levels = []
    for lv in h.levels:
        inv = lv.inv_Aff
        levels.append(dict(
            n=lv.n, fine=np.asarray(lv.fine), coarse=np.asarray(lv.coarse),
            A=lv.A, A_ff=lv.A_ff, A_fc=lv.A_fc, R=lv.R, P=lv.P,
            inv_kind=inv.kind,
            inv_coeffs=(None if inv.coefficients is None
                        else np.asarray(inv.coefficients)),
            inv_host=inv.host_csr))
    ci = h.coarse_inv
    return dict(levels=levels, coarse_A=h.coarse_matrix,
                coarse_kind=ci.kind, coarse_steps=ci.steps,
                coarse_coeffs=np.asarray(ci.coefficients))


_CACHE = {}


def _pair(n, pairing, dtype=np.float64):
    """(reference PCAIR, port PCAIR, ref snapshot, port snapshot) for the
    bench options on adv_diff_2d(n), built once per worker and host-kernel
    pairing."""
    key = (n, np.dtype(dtype).name, pairing)
    if key not in _CACHE:
        A = jpf.adv_diff_2d(n).astype(dtype)
        jpc = jpf.PCAIR(bench_kw(jpf), jit=False).setup(A)
        js = _snapshot(jpc.hierarchy)
        tpc = tpf.PCAIR(bench_kw(tpf), dtype=torch.float64,
                        device="cpu").setup(A)
        ts = _snapshot(tpc.hierarchy)
        _CACHE[key] = (A, jpc, tpc, js, ts)
    return _CACHE[key]


def _same_csr(M, N, rtol):
    M, N = sp.csr_matrix(M), sp.csr_matrix(N)
    assert M.shape == N.shape
    assert np.array_equal(M.indptr, N.indptr)
    assert np.array_equal(M.indices, N.indices)
    scale = max(np.abs(M.data).max(initial=0.0), 1e-300)
    assert np.abs(M.data - N.data).max(initial=0.0) <= rtol * scale


@pytest.mark.parametrize("n,dtype,host_kernels", [
    pytest.param(64, np.float64, NATIVE, id="64-float64"),
    pytest.param(64, np.float64, NUMPY, id="64-float64-numpy"),
    pytest.param(128, np.float64, NATIVE, id="128-float64"),
    pytest.param(64, np.float32, NATIVE, id="64-float32")],
    indirect=["host_kernels"])
def test_hierarchy_matches_reference(n, dtype, host_kernels):
    """CF markers, level sizes and nnz identical; operator values and
    polynomial coefficients to 1e-12 (f64) -- also for the f32 host setup
    the bench runs.  64-float64 runs once on the native host kernels (when
    both load) and once on the numpy fallbacks of both packages."""
    _check_hierarchy(n, dtype, host_kernels)


def test_pairing_falls_back_to_numpy(monkeypatch):
    """With the reference's native library missing, the pairing puts the
    port on its numpy fallbacks too, and the 64^2 f64 hierarchies still
    agree to 1e-12."""
    from pflare_tpu import native as jnative

    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    assert pair_host_kernels(monkeypatch, NATIVE) == NUMPY
    assert tnative.get_lib() is None and jnative.get_lib() is None
    _check_hierarchy(64, np.float64, NUMPY)


def _check_hierarchy(n, dtype, pairing):
    _, _, _, js, ts = _pair(n, pairing, dtype)
    rtol = 1e-12 if dtype == np.float64 else 1e-6
    assert len(ts["levels"]) == len(js["levels"])
    for a, b in zip(js["levels"], ts["levels"]):
        assert a["n"] == b["n"]
        assert np.array_equal(a["fine"], b["fine"])
        assert np.array_equal(a["coarse"], b["coarse"])
        for name in ("A", "A_ff", "A_fc", "R", "P"):
            assert a[name].nnz == b[name].nnz, name
            _same_csr(a[name], b[name], rtol)
        assert a["inv_kind"] == b["inv_kind"]
        if a["inv_coeffs"] is not None:
            np.testing.assert_allclose(b["inv_coeffs"], a["inv_coeffs"],
                                       rtol=rtol, atol=0)
        if a["inv_host"] is not None:
            _same_csr(a["inv_host"], b["inv_host"], rtol)
    _same_csr(js["coarse_A"], ts["coarse_A"], rtol)
    assert js["coarse_kind"] == ts["coarse_kind"] == "newton_mf"
    np.testing.assert_allclose(ts["coarse_coeffs"], js["coarse_coeffs"],
                               rtol=rtol, atol=0)
    assert len(js["coarse_steps"]) == len(ts["coarse_steps"])


@pytest.mark.parametrize("n", [64, 128])
def test_apply_matches_reference(n, host_kernels):
    A, jpc, tpc, _, _ = _pair(n, host_kernels)
    r = rhs(A.shape[0])
    y_ref = np.asarray(jpc.apply(jnp.asarray(r)))
    y = tpc.apply(r).numpy()
    assert np.linalg.norm(y - y_ref) <= 1e-10 * np.linalg.norm(y_ref)


@pytest.mark.parametrize("n", [64, 128])
def test_solve_device_history_matches_reference(n, host_kernels):
    """Richardson norm history of ``solve_device`` against the same
    iteration driven through the reference's apply."""
    A, jpc, tpc, _, _ = _pair(n, host_kernels)
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    x, norms = tpc.solve_device(b, max_it=10)
    E = JELL.from_scipy(A)
    bj = jnp.asarray(b)
    xj = jnp.zeros_like(bj)
    r = bj
    ref = [float(jnp.linalg.norm(r))]
    for _ in range(10):
        xj = xj + jpc.apply(r)
        r = bj - E.matvec(xj)
        ref.append(float(jnp.linalg.norm(r)))
    ref = np.asarray(ref)
    assert np.abs(norms.numpy() - ref).max() <= 1e-8 * ref[0]
    assert norms[-1] <= 1e-5 * norms[0]
    true = np.linalg.norm(A @ x.numpy() - b) / np.linalg.norm(b)
    assert true <= 1e-5


def test_hierarchy_from_numpy_matches_reference_apply(host_kernels):
    """The reference's own device hierarchy, carried across as numpy
    arrays, gives the reference's apply."""
    A, jpc, _, js, _ = _pair(64, host_kernels)
    levels = []
    for lev in jpc.hierarchy.device_levels:
        inv = lev["inv_Aff"]
        spec = ({"kind": "diagonal", "diag": np.asarray(inv.diag)}
                if inv.kind == "diagonal" else
                {"kind": "assembled", "matrix": inv.mat.to_scipy()})
        levels.append({k: lev[k].to_scipy() for k in ("A_ff", "A_fc", "R",
                                                      "P")}
                      | {"inv_Aff": spec,
                         "mask_f": np.asarray(lev["mask_f"]),
                         "fine": np.asarray(lev["fine"]),
                         "coarse": np.asarray(lev["coarse"])})
    coarse = {"kind": "newton_mf", "steps": jpc.hierarchy.coarse_inv.steps,
              "matrix": js["coarse_A"]}
    dh = hierarchy_from_numpy(levels, coarse, torch.float64, "cpu", top=A)
    r = rhs(A.shape[0], seed=7)
    y = vcycle_kaskade(dh.levels, dh.coarse_inv, torch.from_numpy(r),
                       jpc.options.smooth_arg).numpy()
    y_ref = np.asarray(jpc.apply(jnp.asarray(r)))
    assert np.linalg.norm(y - y_ref) <= 1e-10 * np.linalg.norm(y_ref)
    with pytest.raises(ValueError):
        bad = dict(levels[0], fine=levels[0]["fine"][1:])
        hierarchy_from_numpy([bad], coarse, torch.float64, "cpu")


_VARIANTS = {
    "poly_mf": dict(matrix_free_polys=True),
    "newton_assembled": dict(inverse_type="NEWTON"),
    "power_scaled": dict(inverse_type="POWER", diag_scale_polys=True),
    "neumann_assembled": dict(inverse_type="NEUMANN"),
    "neumann_mf": dict(inverse_type="NEUMANN", matrix_free_polys=True),
    "jacobi": dict(inverse_type="JACOBI"),
    "wjacobi": dict(inverse_type="WJACOBI"),
    "sai": dict(inverse_type="SAI"),
    "isai": dict(inverse_type="ISAI"),
    "lu": dict(inverse_type="LU"),
    "coarsest_lu": dict(coarsest_inverse_type="LU"),
}


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_inverse_variants_match_reference_apply(variant, host_kernels):
    """Level smoothers and coarse solvers beyond the main path's:
    matrix-free Arnoldi (Horner), assembled Newton, diagonally scaled
    power basis, and every other inverse type (Neumann in both forms,
    Jacobi, weighted Jacobi, SAI, ISAI, LU), with
    LU also as the coarse solver.  Kinds equal, coefficients to 1e-12,
    ``apply`` to 1e-10."""
    kw = _VARIANTS[variant]
    A = tpf.adv_diff_2d(40)
    jpc = jpf.PCAIR(jpf.AIROptions(**kw), jit=False).setup(A)
    tpc = tpf.PCAIR(tpf.AIROptions(**kw), **F64).setup(A)
    assert len(jpc.hierarchy.levels) == len(tpc.hierarchy.levels)
    for a, b in zip(jpc.hierarchy.levels, tpc.hierarchy.levels):
        assert np.array_equal(a.fine, b.fine)
        assert a.inv_Aff.kind == b.inv_Aff.kind
        if a.inv_Aff.coefficients is not None:
            np.testing.assert_allclose(b.inv_Aff.coefficients,
                                       np.asarray(a.inv_Aff.coefficients),
                                       rtol=1e-12, atol=0)
    assert jpc.hierarchy.coarse_inv.kind == tpc.hierarchy.coarse_inv.kind
    r = rhs(A.shape[0])
    y_ref = np.asarray(jpc.apply(jnp.asarray(r)))
    y = tpc.apply(r).numpy()
    assert np.linalg.norm(y - y_ref) <= 1e-10 * np.linalg.norm(y_ref)


def test_f32_main_path_converges_on_cpu():
    """The f32 bench configuration (f32 host setup, f32 solve) converges
    within 10 Richardson iterations, as the card must."""
    A = tpf.adv_diff_2d(64).astype(np.float32)
    pc = tpf.PCAIR(bench_kw(tpf), dtype=torch.float32, device="cpu")
    pc.setup(A)
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    x, norms = pc.solve_device(b, max_it=10)
    assert x.dtype == torch.float32
    assert float(norms[-1]) <= 1e-5 * float(norms[0])


def test_numpy_fallbacks_match_native(monkeypatch):
    """Without the native host kernels the numpy fallbacks build the same
    hierarchy."""
    A = tpf.adv_diff_2d(32)
    nat = tpf.PCAIR(bench_kw(tpf), **F64).setup(A).hierarchy
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", True)
    assert tnative.get_lib() is None
    fb = tpf.PCAIR(bench_kw(tpf), **F64).setup(A).hierarchy
    assert len(fb.levels) == len(nat.levels)
    for a, b in zip(nat.levels, fb.levels):
        assert np.array_equal(a.fine, b.fine)
        for name in ("A_ff", "A_fc", "R", "P"):
            _same_csr(getattr(a, name), getattr(b, name), 1e-12)
    _same_csr(nat.coarse_matrix, fb.coarse_matrix, 1e-12)


# ~~~~~~ torch copies of the reference's oracles (tests/test_air.py) ~~~~~~

def _gmres_pair(A, opts_kw, b, x0=None, **solve_kw):
    """(port result, reference eager iteration count) of one GMRES solve,
    both by the host-driven GMRES (``eager=True``)."""
    tpc = tpf.PCAIR(tpf.AIROptions(**opts_kw), **F64).setup(A)
    res = tpc.solve(b, x0=x0, eager=True, **solve_kw)
    jpc = jpf.PCAIR(jpf.AIROptions(**opts_kw), jit=False).setup(A)
    jres = jpc.solve(jnp.asarray(b),
                     x0=None if x0 is None else jnp.asarray(x0),
                     eager=True, **solve_kw)
    return res, jres.iterations, tpc


def test_check_adv_diff_25(host_kernels):
    """reference: tests/Makefile:1323 -- adv_diff 25^2, default AIR,
    <= 5 its."""
    A = tpf.adv_diff_2d(25)
    res, j_its, _ = _gmres_pair(A, {}, rhs(A.shape[0]), rtol=1e-5, max_it=5)
    assert res.converged, res.iterations
    assert res.iterations == j_its


def test_check_matrandom(host_kernels):
    """reference: tests/Makefile:1319 -- random diag-dominant, <= 5 its."""
    A = tpf.random_diag_dominant(300, 0.02, seed=11)
    res, j_its, _ = _gmres_pair(A, {}, rhs(300), rtol=1e-5, max_it=5)
    assert res.converged, res.iterations
    assert res.iterations == j_its


def test_medium_scaling_100(host_kernels):
    """reference: tests/Makefile:1117-1131 -- right-PC GMRES rtol 1e-10,
    a_lump, a_drop 1e-5, strong_threshold 0.99: <= 6 its at 100^2."""
    A = tpf.adv_diff_2d(100)
    res, j_its, _ = _gmres_pair(
        A, dict(a_lump=True, a_drop=1e-5, strong_threshold=0.99),
        rhs(A.shape[0]), rtol=1e-10, atol=1e-50, max_it=6, side="right")
    assert res.converged, res.iterations
    assert res.iterations == j_its


def test_medium_scaling_zero_rhs_100(host_kernels):
    """The reference driver's convention (tests/adv_diff_fd.c:178,325):
    zero RHS from x0 = 1, right GMRES rtol 1e-10, <= 6 its -- the f64
    parity configuration chip_smoke.py runs at 512^2."""
    A = tpf.adv_diff_2d(100)
    n = A.shape[0]
    res, j_its, _ = _gmres_pair(
        A, dict(a_lump=True, a_drop=1e-5, strong_threshold=0.99),
        np.zeros(n), x0=np.ones(n), rtol=1e-10, atol=1e-50, max_it=6,
        side="right")
    assert res.converged, res.iterations
    assert res.iterations == j_its
    x = res.x.numpy()
    assert np.linalg.norm(A @ x) / np.linalg.norm(A @ np.ones(n)) <= 1e-8


def test_bench_truncated_config(host_kernels):
    """The bench's truncation of the medium config (5 levels, order-32
    matrix-free Newton coarse solve) at 128^2 (tests/test_air.py:291)."""
    A = tpf.adv_diff_2d(128)
    kw = dict(a_lump=True, a_drop=1e-5, strong_threshold=0.99, max_levels=5,
              coarsest_inverse_type=tpf.InverseType.NEWTON,
              coarsest_poly_order=32, coarsest_matrix_free_polys=True)
    b = rhs(A.shape[0])
    res, j_its, pc = _gmres_pair(A, kw, b, rtol=1e-5, max_it=10)
    assert pc.n_levels <= 5
    assert res.converged, res.iterations
    assert res.iterations == j_its
    x = res.x.numpy()
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-4
