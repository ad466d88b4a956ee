"""Same-pattern re-setup (``reuse_sparsity``) on the host, against the JAX
reference, on the CPU.

The port's counterparts of the reference's reuse oracles
(tests/test_air.py:327-450, 584, 658; tests/test_parallel.py:483, run
serially), each also held to the reference's values, and the parity of
``setup(A2, "same")`` with the reference's ``setup(A2,
structure="same")`` for every ``reuse_amount`` with and without
``reuse_poly_coeffs``, lAIR, the ideal W and strong R: CF markers, level
sizes and nnz equal, operators within 1e-12, coefficients, ``apply``
within 1e-10 and the host-driven GMRES histories (``eager=True`` in both
packages).  A2 has A's pattern and its values times 1 + 0.01 N(0, 1),
seeded.  Every test that holds the port against the reference takes the
``host_kernels`` fixture (tests/torch_reference.py); the plan re-setup
(``host_fast``) exists only on the native host kernels, so its plans are
asserted only on that pairing.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

import pflare_tpu as jpf
import pflare_tpu_torch as tpf
from pflare_tpu_torch.solvers.jitted import (gmres_right_fixed,
                                             richardson_fixed)
from test_torch_air_options import (APPLY_RTOL, HISTORY_FLOOR, HISTORY_RTOL,
                                    check_hierarchy)
from torch_reference import NATIVE, host_kernels  # noqa: F401

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
BENCH = dict(a_lump=True, a_drop=1e-5, strong_threshold=0.99)


def rhs(n, seed=3):
    return np.random.default_rng(seed).standard_normal(n)


def perturbed(A, seed=11, scale=0.01):
    """A's pattern, its values times 1 + scale N(0, 1)."""
    A2 = A.copy()
    A2.data = A2.data * (1.0 + scale * np.random.default_rng(seed)
                         .standard_normal(A.nnz))
    return A2


def _pcs(A, kw):
    opts = dict(reuse_sparsity=True) | kw
    return (jpf.PCAIR(jpf.AIROptions().replace(**opts), jit=False),
            tpf.PCAIR(tpf.AIROptions().replace(**opts), **F64))


def _same_history(res, jres):
    h, jh = res.history, np.asarray(jres.history)
    assert res.iterations == jres.iterations
    assert len(h) == len(jh)
    assert np.all(np.abs(h - jh) <= HISTORY_RTOL * jh + HISTORY_FLOOR * jh[0])


# id: (matrix side, options)
PARITY = {
    **{f"amount{a}{'_poly' if p else ''}": (
        32, BENCH | dict(reuse_amount=a, reuse_poly_coeffs=p))
       for a in (1, 2, 3) for p in (False, True)},
    "lair": (24, dict(z_type="LAIR", reuse_amount=2)),
    "lair_strong_r": (24, dict(z_type="LAIR", strong_r_threshold=0.01,
                               reuse_amount=3, reuse_poly_coeffs=True)),
    "ideal_w": (24, dict(one_point_classical_prolong=False,
                         reuse_amount=3)),
    "ideal_w_amount2": (24, dict(one_point_classical_prolong=False,
                                 reuse_amount=2)),
    "strong_r": (24, dict(strong_r_threshold=0.01, reuse_amount=2)),
    "newton": (24, dict(inverse_type="NEWTON", reuse_amount=3)),
}


@pytest.mark.parametrize("case", list(PARITY))
def test_resetup_matches_reference(case, host_kernels):
    n, kw = PARITY[case]
    A = tpf.adv_diff_2d(n)
    A2 = perturbed(A)
    jpc, tpc = _pcs(A, kw)
    jpc.setup(A)
    tpc.setup(A)
    fine = [lv.fine for lv in tpc.hierarchy.levels]
    jpc.setup(A2, structure="same")
    tpc.setup(A2, "same")
    # the stored CF splitting is reused, at every amount
    assert all(a is lv.fine for a, lv in zip(fine, tpc.hierarchy.levels))
    check_hierarchy(jpc.hierarchy, tpc.hierarchy)
    th, jh = tpc.hierarchy, jpc.hierarchy
    for a, b in zip(jh.levels, th.levels):
        if a.inv_Aff.coefficients is not None:
            np.testing.assert_allclose(b.inv_Aff.coefficients,
                                       np.asarray(a.inv_Aff.coefficients),
                                       rtol=1e-10, atol=0)
        assert ("host_fast" in a.patterns) == ("host_fast" in b.patterns)
        if host_kernels == NATIVE and kw.get("reuse_amount", 3) >= 2 \
                and "z_type" not in kw and "one_point_classical_prolong" \
                not in kw and "strong_r_threshold" not in kw:
            assert "host_fast" in b.patterns
        for key in ("W_drop", "Z_drop", "RAP_drop", "Aff_drop",
                    "Z_lair_sparsity"):
            assert (key in a.patterns) == (key in b.patterns), key
    if jh.coarse_inv.coefficients is not None:
        np.testing.assert_allclose(th.coarse_inv.coefficients,
                                   np.asarray(jh.coarse_inv.coefficients),
                                   rtol=1e-10, atol=0)
    assert tpc.stats() == pytest.approx(jpc.stats())
    r = rhs(A.shape[0])
    y_ref = np.asarray(jpc.apply(jnp.asarray(r)))
    assert (np.linalg.norm(tpc.apply(r).numpy() - y_ref)
            <= APPLY_RTOL * np.linalg.norm(y_ref))
    kw = dict(rtol=1e-10, atol=1e-50, max_it=30, side="right", eager=True)
    _same_history(tpc.solve(r, **kw), jpc.solve(jnp.asarray(r), **kw))


def test_reuse_same_pattern(host_kernels):
    """tests/test_air.py:327: a re-setup with the same pattern keeps the
    level count and the complexities, and converges."""
    A = tpf.adv_diff_2d(25)
    jpc, tpc = _pcs(A, {})
    tpc.setup(A)
    s1 = tpc.stats()
    A2 = A.copy()
    A2.data = A2.data * 1.1
    tpc.setup(A2, "same")
    s2 = tpc.stats()
    res = tpc.solve(rhs(A.shape[0]), rtol=1e-5, max_it=10)
    assert res.converged
    assert s1["levels"] == s2["levels"]
    assert np.isclose(s1["grid_complexity"], s2["grid_complexity"])
    assert s2["reuse_storage_complexity"] > 0
    jpc.setup(A)
    jpc.setup(A2, structure="same")
    check_hierarchy(jpc.hierarchy, tpc.hierarchy)


def test_reuse_poly_coeffs_identical(host_kernels):
    """tests/test_air.py:347: frozen coefficients and the same matrix
    reproduce the preconditioner: the same history to 1e-8, and the
    reference's."""
    A = tpf.adv_diff_2d(20)
    jpc, tpc = _pcs(A, dict(reuse_poly_coeffs=True))
    b = rhs(A.shape[0])
    tpc.setup(A)
    h1 = tpc.solve(b, rtol=1e-8, max_it=20).history
    tpc.setup(A, "same")
    res = tpc.solve(b, rtol=1e-8, max_it=20)
    assert len(h1) == len(res.history)
    assert np.allclose(h1, res.history, rtol=1e-8)
    jpc.setup(A)
    jpc.setup(A, structure="same")
    check_hierarchy(jpc.hierarchy, tpc.hierarchy)
    kw = dict(rtol=1e-8, max_it=20, eager=True)
    _same_history(tpc.solve(b, **kw), jpc.solve(jnp.asarray(b), **kw))


def _fast_and_generic(A, A2, opts):
    """Two PCAIRs re-set up on A2: by the stored plans, and with the plans
    popped (the generic reuse path)."""
    fast = tpf.PCAIR(opts, **F64).setup(A)
    had_plans = [("host_fast" in lv.patterns) for lv in fast.hierarchy.levels]
    fast.setup(A2, "same")
    gen = tpf.PCAIR(opts, **F64).setup(A)
    for lv in gen.hierarchy.levels:
        lv.patterns.pop("host_fast", None)
    gen.setup(A2, "same")
    return fast, gen, had_plans


def test_host_fast_matches_generic(host_kernels):
    """tests/test_air.py:360: the plan re-setup reproduces the generic
    pattern-reusing path (to 1e-11, 1e-10 the coarse matrices), which the
    reference's re-setup values hold too."""
    A = tpf.adv_diff_2d(40)
    A2 = perturbed(A)
    opts = tpf.AIROptions(**BENCH, reuse_sparsity=True, reuse_amount=2,
                          reuse_poly_coeffs=True)
    fast, gen, had_plans = _fast_and_generic(A, A2, opts)
    if host_kernels == NATIVE:
        assert all(had_plans)
    else:
        assert not any(had_plans)
    assert fast.n_levels == gen.n_levels
    for l1, l2 in zip(fast.hierarchy.levels, gen.hierarchy.levels):
        for name in ("A_ff", "A_fc", "R"):
            assert abs(getattr(l1, name) - getattr(l2, name)).max() < 1e-11
        assert abs(l1.patterns["coarse_A"]
                   - l2.patterns["coarse_A"]).max() < 1e-10
        assert abs(l1.inv_Aff_host - l2.inv_Aff_host).max() < 1e-11
    b = rhs(A.shape[0])
    r1 = fast.solve(b, rtol=1e-8, max_it=12)
    r2 = gen.solve(b, rtol=1e-8, max_it=12)
    assert r1.converged and r2.converged
    assert r1.iterations == r2.iterations
    jpc = jpf.PCAIR(jpf.AIROptions(**BENCH, reuse_sparsity=True,
                                   reuse_amount=2, reuse_poly_coeffs=True),
                    jit=False)
    jpc.setup(A)
    jpc.setup(A2, structure="same")
    check_hierarchy(jpc.hierarchy, fast.hierarchy)


def test_host_fast_reiterates_coefficients(host_kernels):
    """tests/test_air.py:407: without reuse_poly_coeffs the re-setup
    iterates the coefficients anew on the new values (doubling A divides
    c_k by 2^(k+1)), as the reference's does."""
    A = tpf.adv_diff_2d(30)
    jpc, tpc = _pcs(A, dict(reuse_amount=2))
    tpc.setup(A)
    i = next(i for i, lv in enumerate(tpc.hierarchy.levels)
             if lv.inv_Aff.kind == "assembled")
    c1 = np.asarray(tpc.hierarchy.levels[i].inv_Aff.coefficients).copy()
    A2 = A.copy()
    A2.data = A2.data * 2.0
    tpc.setup(A2, "same")
    c2 = np.asarray(tpc.hierarchy.levels[i].inv_Aff.coefficients)
    assert not np.allclose(c1, c2)
    np.testing.assert_allclose(c2, c1 / 2.0 ** np.arange(1, len(c1) + 1),
                               rtol=1e-8)
    assert tpc.solve(rhs(A.shape[0]), rtol=1e-6, max_it=10).converged
    jpc.setup(A)
    jpc.setup(A2, structure="same")
    np.testing.assert_allclose(
        c2, np.asarray(jpc.hierarchy.levels[i].inv_Aff.coefficients),
        rtol=1e-10)


def test_freeze_and_reset():
    """tests/test_air.py:437: a frozen PCAIR keeps its hierarchy through
    setup; unfrozen it sets up anew.  set_options and reset drop the
    hierarchy; apply before a setup raises."""
    A = tpf.adv_diff_2d(20)
    pc = tpf.PCAIR(**F64).setup(A)
    h = pc.hierarchy
    dh = pc.upload()
    pc.freeze(True)
    A2 = A.copy()
    A2.data = A2.data * 2.0
    pc.setup(A2)
    assert pc.hierarchy is h and pc.upload() is dh
    pc.freeze(False)
    pc.setup(A2)
    assert pc.hierarchy is not h and pc.upload() is not dh
    pc.set_options(max_levels=2)
    assert pc.hierarchy is None and pc.options.max_levels == 2
    with pytest.raises(RuntimeError):
        pc.apply(np.zeros(A.shape[0]))
    assert pc.setup(A).n_levels == 2
    pc.reset()
    assert pc.hierarchy is None


def test_reuse_keeps_host_state(host_kernels):
    """tests/test_air.py:584: with reuse the host hierarchy survives the
    upload, a re-setup drops the uploaded form, and the re-set-up
    preconditioner converges, with the reference's values."""
    A = tpf.adv_diff_2d(32)
    jpc, tpc = _pcs(A, dict(reuse_amount=3))
    tpc.setup(A)
    b = rhs(A.shape[0])
    tpc.solve(b, rtol=1e-5, max_it=8)
    dh = tpc.upload()
    assert sp.issparse(tpc.hierarchy.levels[1].A)
    A2 = A.copy()
    A2.data = A2.data * 1.05
    tpc.setup(A2, "same")
    assert tpc.upload() is not dh
    assert tpc.solve(b, rtol=1e-5, max_it=8).converged
    jpc.setup(A)
    jpc.setup(A2, structure="same")
    check_hierarchy(jpc.hierarchy, tpc.hierarchy)


@pytest.mark.parametrize("inv_type", ["POWER", "ARNOLDI", "NEWTON"])
def test_set_poly_coefficients_exact_reproduction(inv_type, host_kernels):
    """tests/test_air.py:658: every level's coefficients (and the coarse
    solver's) taken from one PCAIR and injected into a fresh one before
    its setup reproduce the history to 1e-12; the coefficients equal the
    reference's."""
    A = tpf.adv_diff_2d(32)
    b = rhs(A.shape[0])
    kw = dict(inverse_type=inv_type, poly_order=4,
              coarsest_inverse_type=inv_type)
    pc1 = tpf.PCAIR(tpf.AIROptions().replace(**kw), **F64).setup(A)
    res1 = pc1.solve(b, rtol=1e-10, max_it=20)
    pc2 = tpf.PCAIR(tpf.AIROptions().replace(**kw), **F64)
    for lvl in range(pc1.n_levels - 1):
        c = pc1.get_poly_coefficients(lvl)
        if c is not None:
            pc2.set_poly_coefficients(lvl, c)
    pc2.set_poly_coefficients(-1, pc1.get_poly_coefficients(-1))
    pc2.setup(A)
    res2 = pc2.solve(b, rtol=1e-10, max_it=20)
    assert res2.iterations == res1.iterations
    np.testing.assert_allclose(res2.history, res1.history, rtol=1e-12)
    jpc = jpf.PCAIR(jpf.AIROptions().replace(**kw), jit=False).setup(A)
    for lvl in list(range(pc1.n_levels - 1)) + [-1]:
        c = pc2.get_poly_coefficients(lvl)
        c_ref = jpc.get_poly_coefficients(lvl)
        assert (c is None) == (c_ref is None)
        if c is not None:
            assert c.shape == c_ref.shape
            np.testing.assert_allclose(c, c_ref, rtol=1e-10)
    if inv_type == "NEWTON":
        assert pc2.get_poly_coefficients(-1).shape[0] == 2


def test_coarse_order_stable_under_reuse(host_kernels):
    """tests/test_parallel.py:483, serially: a same-pattern re-setup keeps
    the stored coarse permutations, which equal the reference's, and
    converges."""
    A = tpf.dg_upwind_advection_unstructured(24)
    kw = dict(strong_threshold=0.99, max_levels=4, coarse_repartition=True,
              reuse_amount=2)
    jpc, tpc = _pcs(A, kw)
    tpc.setup(A)
    perms = [None if lv.coarse_order is None else lv.coarse_order.copy()
             for lv in tpc.hierarchy.levels]
    assert any(p is not None for p in perms)
    A2 = perturbed(A, seed=1, scale=1e-4)
    tpc.setup(A2, "same")
    for p_old, lv in zip(perms, tpc.hierarchy.levels):
        if p_old is None:
            assert lv.coarse_order is None
        else:
            assert np.array_equal(p_old, lv.coarse_order)
    res = tpc.solve(rhs(A.shape[0], seed=0), rtol=1e-8, max_it=40)
    assert res.converged, res.iterations
    jpc.setup(A)
    jpc.setup(A2, structure="same")
    check_hierarchy(jpc.hierarchy, tpc.hierarchy)


def test_f32_resetup_follows_reference_dtypes(host_kernels):
    """An f32 matrix: the re-setup's host dtypes are the reference's (the
    plan path computes R, the coarse matrices and the inverses from the
    first re-built level on in f64, the generic path keeps f32), and the
    upload is f32 all the same.  Values agree to f32 rounding."""
    A = tpf.adv_diff_2d(32).astype(np.float32)
    A2 = perturbed(A).astype(np.float32)
    jpc, tpc = _pcs(A, BENCH | dict(reuse_amount=2))
    jpc.setup(A)
    tpc.setup(A)
    jpc.setup(A2, structure="same")
    tpc.setup(A2, "same")
    for a, b in zip(jpc.hierarchy.levels, tpc.hierarchy.levels):
        for name in ("A", "A_ff", "A_fc", "R", "P", "inv_Aff_host"):
            assert getattr(a, name).dtype == getattr(b, name).dtype, name
        assert np.array_equal(a.fine, b.fine)
        for name in ("R", "inv_Aff_host"):
            M, N = getattr(a, name), getattr(b, name)
            assert np.array_equal(M.indices, N.indices)
            assert np.abs(M.data - N.data).max() <= 1e-5 * np.abs(M.data).max()
    assert (jpc.hierarchy.coarse_matrix.dtype
            == tpc.hierarchy.coarse_matrix.dtype)
    pc = tpf.PCAIR(tpc.options, dtype=torch.float32, device="cpu")
    pc.hierarchy = tpc.hierarchy
    dh = pc.upload()
    assert dh.top.dtype == torch.float32
    assert all(lev[k].dtype == torch.float32 for lev in dh.levels
               for k in ("A_ff", "A_fc", "R", "P"))
    y = pc.apply(rhs(A.shape[0]))
    assert y.dtype == torch.float32 and torch.isfinite(y).all()


# ~~~~~~ the two port faults of ROADMAP queue 3 ~~~~~~

def test_setup_structure_is_not_a_near_nullspace(monkeypatch, host_kernels):
    """setup's second parameter is the reference's ``structure``: "same"
    keeps the CF markers after a reuse setup and runs a full setup
    without reuse; a near-nullspace passed by keyword still reaches the
    constraints; anything else is refused."""
    import pflare_tpu_torch.air.pcair as tpcair

    A = tpf.adv_diff_2d(20)
    A2 = perturbed(A)
    seen = []
    real = tpcair.setup_hierarchy
    monkeypatch.setattr(tpcair, "setup_hierarchy", lambda *a, **k: (
        seen.append((k["previous"], k["near_nullspace"])) or real(*a, **k)))
    pc = tpf.PCAIR(tpf.AIROptions(reuse_sparsity=True), **F64).setup(A)
    h = pc.hierarchy
    pc.setup(A2, "same")
    assert seen[-1] == (h, None)
    assert all(a.fine is b.fine for a, b in zip(h.levels, pc.hierarchy.levels))
    pc = tpf.PCAIR(**F64).setup(A)
    pc.setup(A2, "same")
    assert seen[-1] == (None, None)
    full = tpf.PCAIR(**F64).setup(A2)
    check_hierarchy(full.hierarchy, pc.hierarchy)
    with pytest.raises(ValueError, match="structure"):
        pc.setup(A2, [np.ones(A.shape[0])])
    kw = dict(one_point_classical_prolong=False, constrain_w=True,
              constrain_z=True)
    nulls = [np.ones(A.shape[0]), np.linspace(0.0, 1.0, A.shape[0])]
    tpc = tpf.PCAIR(tpf.AIROptions().replace(**kw), **F64).setup(
        A, near_nullspace=nulls)
    assert seen[-1][1] is nulls
    jpc = jpf.PCAIR(jpf.AIROptions().replace(**kw), jit=False).setup(
        A, near_nullspace=[v.copy() for v in nulls])
    check_hierarchy(jpc.hierarchy, tpc.hierarchy)
    plain = tpf.PCAIR(tpf.AIROptions().replace(**kw), **F64).setup(A)
    R, R_nulls = plain.hierarchy.levels[0].R, tpc.hierarchy.levels[0].R
    assert abs(R - R_nulls).max() > 0


@pytest.mark.parametrize("ksp", ["richardson", "gmres"])
def test_solve_device_x0_under_reorder(ksp, host_kernels):
    """solve_device(x0=...) on the scrambled 24^2 matrix with
    reorder="rcm": the first norm is the true ||b - A x0||, and x equals
    a Richardson loop over the port's own apply (right GMRES:
    gmres_right_fixed over it) in the caller's order, to 1e-12."""
    A = tpf.adv_diff_2d(24)
    p = np.random.default_rng(8).permutation(A.shape[0])
    A = sp.csr_matrix(A[p][:, p])
    pc = tpf.PCAIR(tpf.AIROptions(reorder="rcm"), **F64).setup(A)
    assert pc._perm is not None
    b = rhs(A.shape[0], seed=1)
    x0 = rhs(A.shape[0], seed=2)
    x, norms = pc.solve_device(b, max_it=3, ksp=ksp, x0=x0)
    r0 = np.linalg.norm(b - A @ x0)
    assert abs(float(norms[0]) - r0) <= 1e-12 * r0
    Ab = torch.from_numpy(A.toarray())
    solver = richardson_fixed if ksp == "richardson" else gmres_right_fixed
    x_ref, n_ref = solver(lambda v: Ab @ v, pc.apply, torch.from_numpy(b), 3,
                          x0=torch.from_numpy(x0))
    assert (torch.linalg.norm(x - x_ref) <= 1e-12 * torch.linalg.norm(x_ref))
    np.testing.assert_allclose(norms.numpy(), n_ref.numpy(), rtol=1e-10,
                               atol=1e-12 * r0)
    assert np.linalg.norm(b - A @ x.numpy()) < 1e-2 * r0


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
def test_native_plan_bindings_match_reference(index_dtype, host_kernels):
    """The plan, gather and onto-pattern bindings give the reference's
    arrays bit for bit (int32 and int64 indices), the plan execution
    equals a numpy bincount over its triples, and the onto-pattern
    product is scipy's restricted to the pattern (its outside mass on the
    diagonal with ``lump``); without the library each answers None."""
    import pflare_tpu.native as jn
    import pflare_tpu_torch.native as tn

    rng = np.random.default_rng(0)

    def rand(m, n, density):
        M = sp.random(m, n, density, format="csr", random_state=rng)
        M = sp.csr_matrix(M + sp.eye(m, n))
        M.sort_indices()
        M.indptr = M.indptr.astype(index_dtype)
        M.indices = M.indices.astype(index_dtype)
        return M

    A, B = rand(60, 50, 0.08), rand(50, 60, 0.08)
    C = rand(60, 60, 0.05)
    arrs = (A.indptr, A.indices, B.indptr, B.indices, C.indptr, C.indices)
    if host_kernels != NATIVE:     # every binding answers None
        assert tn.plan_triples32_native(*arrs, 60) is None
        assert tn.gather_fill_native(A.data, A.indices, 0.0) is None
        assert tn.spgemm_onto_pattern_native(A, B, C, True) is None
        return
    for name in ("plan_triples_native", "plan_triples_lump_native"):
        got, ref = getattr(tn, name)(*arrs, 60), getattr(jn, name)(*arrs, 60)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    for lump in (False, True):
        got = tn.plan_triples32_native(*arrs, 60, lump=lump)
        ref = jn.plan_triples32_native(*arrs, 60, lump=lump)
        assert all(g.dtype == np.int32 for g in got)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        a, b, c = got
        vals = tn.plan_execute_native(A.data, B.data, a, b, c, C.nnz,
                                      alpha=-2.0)
        np.testing.assert_array_equal(vals, jn.plan_execute_native(
            A.data, B.data, a, b, c, C.nnz, alpha=-2.0))
        np.testing.assert_allclose(vals, -2.0 * np.bincount(
            c, weights=A.data[a] * B.data[b], minlength=C.nnz), rtol=1e-14)
        unit = tn.plan_execute_native(A.data, None, a, None, c, C.nnz)
        np.testing.assert_array_equal(unit, np.bincount(
            c, weights=A.data[a], minlength=C.nnz))
        onto = tn.spgemm_onto_pattern_native(A, B, C, lump)
        np.testing.assert_array_equal(
            onto.data, jn.spgemm_onto_pattern_native(A, B, C, lump).data)
        full = sp.csr_matrix(A @ B)
        np.testing.assert_allclose(onto.toarray()[C.toarray() != 0],
                                   full.toarray()[C.toarray() != 0]
                                   + (np.diag(np.asarray(
                                       full.sum(1)).ravel()
                                       - np.asarray(full.multiply(
                                           C != 0).sum(1)).ravel())
                                      [C.toarray() != 0] if lump else 0),
                                   rtol=1e-12, atol=1e-14)
    idx = rng.integers(-1, A.nnz, 40).astype(index_dtype)
    np.testing.assert_array_equal(tn.gather_fill_native(A.data, idx, 7.0),
                                  np.where(idx >= 0, A.data[idx], 7.0))
