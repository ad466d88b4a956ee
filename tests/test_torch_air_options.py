"""The port's AIR options against the JAX reference, on the CPU.

Every ``AIROptions`` field the port honours, on the reference's own
oracles (tests/test_air.py) with generated matrices: lAIR and SAI-lAIR
with and without strong-R dropping, the ideal prolongator (also with a
matrix-free smoother), improvement and near-nullspace constraints,
symmetric PtAP, full smoothing, C-point smoothing and per-level orders,
auto-truncation, every serial CF splitting, the RCM reorder, every
``ksp`` and the device GMRES.  The same f64 matrix goes through
``pflare_tpu.PCAIR(jit=False)`` and ``pflare_tpu_torch.PCAIR(device="cpu",
dtype=torch.float64)``: CF markers, level sizes and nnz identical,
operators and assembled inverses within 1e-12 relative, ``apply`` within
1e-10 relative, and GMRES (or the option set's own ksp) iteration counts
equal with residual histories within 1e-8 relative.  Every test takes the
``host_kernels`` fixture (tests/torch_reference.py).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

import pflare_tpu as jpf
from pflare_tpu.sparse import ELL as JELL
import pflare_tpu_torch as tpf
from torch_reference import host_kernels  # noqa: F401

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
OPERATOR_RTOL = 1e-12
# polynomial coefficients: the monomial (POWER) basis amplifies the
# rounding of the setup's local solves (the port solves lAIR's square
# blocks by LU, the reference by QR) some hundred times on deep levels
COEFF_RTOL = 1e-10
APPLY_RTOL = 1e-10
# residual norms agree to 1e-8 of themselves, or to 1e-12 of the initial
# norm once a history falls below 1e-4 of it (there rounding differences of
# order eps * ||r_0|| are all that is left to compare)
HISTORY_RTOL = 1e-8
HISTORY_FLOOR = 1e-12


def _scrambled24():
    """adv_diff_2d(24) in a seeded random order (tests/test_air.py:630)."""
    A = tpf.adv_diff_2d(24)
    p = np.random.default_rng(8).permutation(A.shape[0])
    return sp.csr_matrix(A[p][:, p])


_MATRICES = {
    "adv32": lambda: tpf.adv_diff_2d(32),
    "adv24": lambda: tpf.adv_diff_2d(24),
    "adv20": lambda: tpf.adv_diff_2d(20),
    "diff20": lambda: tpf.adv_diff_2d(20, alpha=1.0),
    "aniso24": lambda: tpf.anisotropic_diffusion_2d(24, 1e-3),
    "adv3d10": lambda: tpf.adv_diff_3d(10),
    "scrambled24": _scrambled24,
    "dg24": lambda: tpf.dg_upwind_advection_unstructured(24),
    "random300": lambda: tpf.random_diag_dominant(300, 0.02, seed=11),
}

_POWER = dict(inverse_type="POWER", a_drop=1e-3)

# id: (matrix, options, solve keywords)
CASES = {
    "lair": ("adv32", dict(z_type="LAIR"), {}),
    "lair_strong_r": ("adv32", dict(z_type="LAIR", strong_r_threshold=0.01),
                      {}),
    "sai": ("adv32", dict(z_type="LAIR_SAI"), {}),
    "sai_strong_r": ("adv32", dict(z_type="LAIR_SAI",
                                  strong_r_threshold=0.01),
                     {}),
    "airg_strong_r": ("adv32", dict(strong_r_threshold=0.01), {}),
    "ideal_w": ("adv24", dict(one_point_classical_prolong=False), {}),
    "ideal_w_mf": ("adv24", dict(one_point_classical_prolong=False,
                                 matrix_free_polys=True, max_levels=4),
                   dict(rtol=1e-8, max_it=25)),
    "ideal_w_lair": ("adv24", dict(one_point_classical_prolong=False,
                                   z_type="LAIR"), {}),
    "ideal_w_mf_lair": ("adv24", dict(one_point_classical_prolong=False,
                                      matrix_free_polys=True, z_type="LAIR",
                                      max_levels=4),
                        dict(rtol=1e-8, max_it=25)),
    "improve_constrain": ("adv20", dict(
        one_point_classical_prolong=False, improve_w_its=2, improve_z_its=2,
        constrain_w=True, constrain_z=True), dict(max_it=10)),
    "symmetric": ("diff20", dict(symmetric=True), dict(max_it=25)),
    "full_smoothing": ("diff20", dict(full_smoothing_up_and_down=True,
                                      inverse_type="ARNOLDI"),
                       dict(max_it=25)),
    "smooth_fc": ("adv20", dict(inverse_type="POWER", smooth_order="fc"),
                  {}),
    "smooth_fcf": ("adv32", dict(smooth_order="fcf"), {}),
    "smooth_fcf_mf": ("adv32", dict(smooth_order="fcf",
                                    matrix_free_polys=True), {}),
    "smooth_levels": ("adv32", dict(smooth_order_levels=("fcf", "ff", "f")),
                      {}),
    "aniso_ffc": ("aniso24", dict(strong_threshold=0.2, smooth_order="ffc"),
                  dict(rtol=1e-8, max_it=40)),
    "auto_truncate": ("adv32", dict(auto_truncate_start_level=2,
                                    auto_truncate_tol=1e-2,
                                    coarsest_poly_order=12), {}),
    "cf_pmis": ("adv32", dict(cf_splitting_type="PMIS"), dict(max_it=30)),
    "cf_pmis_dist2": ("adv32", dict(cf_splitting_type="PMIS_DIST2"),
                      dict(max_it=30)),
    "cf_agg": ("adv32", dict(cf_splitting_type="AGG"), dict(max_it=30)),
    "cf_pmis_agg": ("adv32", dict(cf_splitting_type="PMIS_AGG"),
                    dict(max_it=30)),
    "cf_cr": ("random300", dict(cf_splitting_type="CR",
                                strong_threshold=0.4), {}),
    "cf_diag_dom": ("adv32", dict(cf_splitting_type="DIAG_DOM",
                                  strong_threshold=0.9), {}),
    "rcm": ("scrambled24", dict(reorder="rcm"), dict(rtol=1e-6)),
    "ksp_fgmres": ("adv32", {}, dict(ksp="fgmres")),
    "ksp_richardson": ("adv32", {}, dict(ksp="richardson", max_it=20)),
    "adv_diff_3d": ("adv3d10", {}, {}),
    "dg_airg": ("dg24", dict(_POWER), dict(rtol=1e-10, max_it=8)),
    "dg_lair": ("dg24", dict(_POWER, z_type="LAIR"),
                dict(rtol=1e-10, max_it=8)),
}

_CACHE = {}


def _pair(case, pairing):
    """(A, reference PCAIR, port PCAIR) of one option set, built once per
    worker and host-kernel pairing."""
    key = (case, pairing)
    if key not in _CACHE:
        mat, kw, _ = CASES[case]
        A = _MATRICES[mat]()
        jpc = jpf.PCAIR(jpf.AIROptions().replace(**kw), jit=False).setup(A)
        tpc = tpf.PCAIR(tpf.AIROptions().replace(**kw), **F64).setup(A)
        _CACHE[key] = (A, jpc, tpc)
    return _CACHE[key]


def _same_csr(M, N, rtol=OPERATOR_RTOL, name=""):
    M, N = sp.csr_matrix(M), sp.csr_matrix(N)
    M.sort_indices()
    N.sort_indices()
    assert M.shape == N.shape, name
    assert M.nnz == N.nnz, name
    assert np.array_equal(M.indptr, N.indptr), name
    assert np.array_equal(M.indices, N.indices), name
    scale = max(np.abs(M.data).max(initial=0.0), 1e-300)
    err = np.abs(M.data - N.data).max(initial=0.0)
    assert err <= rtol * scale, (name, err / scale)


def _host_inverse(inv):
    """The assembled host matrix of an Inverse, or None (matrix-free)."""
    if inv is None:
        return None
    if inv.kind == "diagonal":
        return sp.diags(np.asarray(inv.diag)).tocsr()
    host = getattr(inv, "host_csr", None)
    return None if host is None else sp.csr_matrix(host)


def check_hierarchy(jh, th):
    """CF markers, level sizes, transfer orders and nnz identical; every
    host operator and assembled inverse within OPERATOR_RTOL."""
    assert len(jh.levels) == len(th.levels)
    assert jh.auto_truncated == th.auto_truncated
    for i, (a, b) in enumerate(zip(jh.levels, th.levels)):
        assert a.n == b.n, i
        assert np.array_equal(a.fine, b.fine), i
        assert np.array_equal(a.coarse, b.coarse), i
        if a.coarse_order is None:
            assert b.coarse_order is None, i
        else:
            assert np.array_equal(a.coarse_order, b.coarse_order), i
        for name in ("A", "A_ff", "A_fc", "A_cf", "A_cc", "R", "P"):
            M, N = getattr(a, name), getattr(b, name)
            assert (M is None) == (N is None), (i, name)
            if M is not None:
                _same_csr(M, N, name=f"level {i} {name}")
        for name in ("inv_Aff", "inv_Acc"):
            ia, ib = getattr(a, name), getattr(b, name)
            assert (ia is None) == (ib is None), (i, name)
            if ia is None:
                continue
            assert ia.kind == ib.kind, (i, name)
            if ia.coefficients is not None:
                np.testing.assert_allclose(ib.coefficients,
                                           np.asarray(ia.coefficients),
                                           rtol=COEFF_RTOL, atol=0)
            Ma = _host_inverse(ia)
            if Ma is not None:
                _same_csr(Ma, _host_inverse(ib), name=f"level {i} {name}")
    _same_csr(jh.coarse_matrix, th.coarse_matrix, name="coarse matrix")
    assert jh.coarse_inv.kind == th.coarse_inv.kind


def rhs(n, seed=3):
    return np.random.default_rng(seed).standard_normal(n)


@pytest.mark.parametrize("case", list(CASES))
def test_hierarchy_matches_reference(case, host_kernels):
    _, jpc, tpc = _pair(case, host_kernels)
    check_hierarchy(jpc.hierarchy, tpc.hierarchy)


@pytest.mark.parametrize("case", list(CASES))
def test_apply_matches_reference(case, host_kernels):
    A, jpc, tpc = _pair(case, host_kernels)
    r = rhs(A.shape[0])
    y_ref = np.asarray(jpc.apply(jnp.asarray(r)))
    y = tpc.apply(r).numpy()
    assert np.linalg.norm(y - y_ref) <= APPLY_RTOL * np.linalg.norm(y_ref)


@pytest.mark.parametrize("case", list(CASES))
def test_solve_matches_reference(case, host_kernels):
    """Equal iteration counts, residual histories within HISTORY_RTOL
    relative, and the port's x solves the caller's system; GMRES by the
    host-driven solver (``eager=True``) in both packages."""
    A, jpc, tpc = _pair(case, host_kernels)
    kw = dict(rtol=1e-5, max_it=15) | CASES[case][2]
    b = rhs(A.shape[0], seed=1)
    res = tpc.solve(b, eager=True, **kw)
    jres = jpc.solve(jnp.asarray(b), eager=True, **kw)
    assert res.iterations == jres.iterations
    assert res.converged == jres.converged
    h, jh = res.history, np.asarray(jres.history)
    assert len(h) == len(jh)
    assert np.all(np.abs(h - jh)
                  <= HISTORY_RTOL * jh + HISTORY_FLOOR * jh[0])
    if res.converged and kw.get("ksp", "gmres") != "gmres":
        true = np.linalg.norm(A @ res.x.numpy() - b) / np.linalg.norm(b)
        assert true <= 1.01 * kw["rtol"]


@pytest.mark.parametrize("case", ["lair", "smooth_fcf", "full_smoothing",
                                  "rcm"])
def test_solve_device_gmres_matches_reference(case, host_kernels):
    """solve_device(ksp="gmres") against the reference's
    gmres_right_fixed driven through its own apply: norms within
    HISTORY_RTOL of the initial norm at every iteration.  Under full
    smoothing the port runs vcycle_full, as its solve does (the
    reference's solve_device would run the Kaskade cycle there), so the
    oracle is the reference's apply, not its solve_device."""
    from pflare_tpu.solvers.jitted import gmres_right_fixed

    A, jpc, tpc = _pair(case, host_kernels)
    b = rhs(A.shape[0], seed=2)
    x, norms = tpc.solve_device(b, max_it=8, ksp="gmres")
    E = JELL.from_scipy(A)
    _, ref = gmres_right_fixed(E.matvec, jpc.apply, jnp.asarray(b), 8)
    ref = np.asarray(ref)
    assert np.abs(norms.numpy() - ref).max() <= HISTORY_RTOL * ref[0]
    true = np.linalg.norm(A @ x.numpy() - b) / np.linalg.norm(b)
    assert abs(true - float(norms[-1]) / ref[0]) <= 1e-6 + 1e-3 * true


def test_full_smoothing_solve_device_richardson(host_kernels):
    """Full smoothing's Richardson solve_device against a Richardson loop
    over the reference's apply."""
    A, jpc, tpc = _pair("full_smoothing", host_kernels)
    b = rhs(A.shape[0], seed=4)
    _, norms = tpc.solve_device(b, max_it=6)
    E = JELL.from_scipy(A)
    bj = jnp.asarray(b)
    xj = jnp.zeros_like(bj)
    r = bj
    ref = [float(jnp.linalg.norm(r))]
    for _ in range(6):
        xj = xj + jpc.apply(r)
        r = bj - E.matvec(xj)
        ref.append(float(jnp.linalg.norm(r)))
    ref = np.asarray(ref)
    assert np.abs(norms.numpy() - ref).max() <= HISTORY_RTOL * ref[0]


@pytest.mark.parametrize("case", ["smooth_fcf", "full_smoothing",
                                  "ideal_w_mf", "aniso_ffc", "lair"])
def test_stats_match_reference(case, host_kernels):
    from pflare_tpu.air.stats import compute_stats

    _, jpc, tpc = _pair(case, host_kernels)
    ref = compute_stats(jpc.hierarchy)
    got = tpc.stats()
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-14, err_msg=k)
    text = tpc.view(out=lambda line: None)
    assert "complexities" in text


def test_rcm_returns_callers_order(host_kernels):
    """reorder="rcm" bands the scrambled matrix, and apply, solve and
    solve_device all answer in the caller's order
    (tests/test_air.py:630-656)."""
    from pflare_tpu_torch.sparse import BandedSpMV

    A, _, tpc = _pair("rcm", host_kernels)
    assert BandedSpMV.bandwidth(A) > 500
    assert BandedSpMV.bandwidth(tpc.hierarchy.levels[0].A) < 60
    b = rhs(A.shape[0])
    res = tpc.solve(b, rtol=1e-6, max_it=10)
    assert res.converged
    assert np.linalg.norm(A @ res.x.numpy() - b) / np.linalg.norm(b) < 1e-5
    x, norms = tpc.solve_device(b, max_it=10)
    true = np.linalg.norm(A @ x.numpy() - b) / np.linalg.norm(b)
    assert abs(true - float(norms[-1] / norms[0])) <= 1e-12 + 1e-6 * true


def test_print_stats_timings(capsys, host_kernels):
    A = tpf.adv_diff_2d(16)
    tpf.PCAIR(tpf.AIROptions(print_stats_timings=True), **F64).setup(A)
    out = capsys.readouterr().out
    assert "Number of levels" in out and "Total setup time" in out


def test_dg_hierarchy_has_no_dia_operator(host_kernels):
    """The unstructured hierarchy holds no DIA operator: its top levels
    take the banded kernel (the Delaunay numbering of a jittered grid
    keeps a bounded bandwidth) and its deeper levels the plain TELL
    gather."""
    from pflare_tpu_torch.sparse import DIA, TELL, BandedSpMV

    _, _, tpc = _pair("dg_lair", host_kernels)
    dh = tpc.upload()
    ops = [dh.top] + [lev[k] for lev in dh.levels
                      for k in ("A_ff", "A_fc", "R", "P")]
    assert not any(isinstance(op, DIA) for op in ops)
    assert isinstance(dh.top, BandedSpMV)
    assert any(isinstance(op, TELL) for op in ops)


def test_near_nullspace_constraints_match_reference(host_kernels):
    """Constraints with two caller-given near-nullspace candidates (the
    constant and a ramp): hierarchy and apply equal the reference's."""
    A = tpf.adv_diff_2d(20)
    nulls = [np.ones(A.shape[0]), np.linspace(0.0, 1.0, A.shape[0])]
    kw = dict(one_point_classical_prolong=False, constrain_w=True,
              constrain_z=True)
    jpc = jpf.PCAIR(jpf.AIROptions().replace(**kw), jit=False).setup(
        A, near_nullspace=[v.copy() for v in nulls])
    tpc = tpf.PCAIR(tpf.AIROptions().replace(**kw), **F64).setup(
        A, near_nullspace=nulls)
    check_hierarchy(jpc.hierarchy, tpc.hierarchy)
    r = rhs(A.shape[0])
    y_ref = np.asarray(jpc.apply(jnp.asarray(r)))
    assert (np.linalg.norm(tpc.apply(r).numpy() - y_ref)
            <= APPLY_RTOL * np.linalg.norm(y_ref))
