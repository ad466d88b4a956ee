"""The device re-setup (``air/device_resetup.py``) on the CPU.

The port's plan runs on ``device="cpu"`` in f64: the same torch ops a
card runs, its segment sums sequential.  Its oracles are the port's own
host re-setup (``setup(A2, "same")`` + ``upload()``: every rebuilt
operator within 1e-10 of the largest entry of the host's) and the JAX
package's host re-setup (``setup(A)``, ``setup(A2, structure="same")``,
then ``solve``: equal iterations, x within 1e-8) for each configuration
of the reference's device re-setup tests (tests/test_device_resetup.py:
60-133), the bench's main path and diagonal scaling.  The reference's
own device re-setup is no oracle: it scrambles TELL operators
(reference fault 1).  Also the device halves of the SpGEMM, polynomial
and SAI plans against the reference's, the reference's validation,
wrong-pattern, repeated-install and auto-truncation cases, and the
reorder.  A2 has A's pattern and its
values times 1 + 0.05 N(0, 1), seeded, as in the reference's tests.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

import pflare_tpu as jpf
import pflare_tpu_torch as tpf
from pflare_tpu.inverse import sai as jsai
from pflare_tpu.sparse import spgemm as jspgemm
from pflare_tpu_torch.inverse import sai as tsai
from pflare_tpu_torch.sparse import TELL, SparsityPattern
from pflare_tpu_torch.sparse import spgemm as tspgemm
from torch_reference import host_kernels  # noqa: F401

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
N = 24          # grid side of the configuration tests
OPERATOR_RTOL = 1e-10
BENCH = dict(a_lump=True, a_drop=1e-5, strong_threshold=0.99,
             coarsest_inverse_type="NEWTON", coarsest_poly_order=24,
             coarsest_matrix_free_polys=True)

# tests/test_device_resetup.py:60-133, and the bench's main path
CONFIGS = {
    "lump": dict(a_lump=True, a_drop=1e-4),
    "mf_smooth": dict(matrix_free_polys=True),
    "fcf_c_smooth": dict(smooth_order="fcf"),
    "newton_mf_coarse": dict(coarsest_inverse_type="NEWTON",
                             coarsest_matrix_free_polys=True,
                             coarsest_poly_order=10),
    "lu_coarse": dict(coarsest_inverse_type="LU"),
    "ideal_w": dict(one_point_classical_prolong=False),
    "ideal_w_mf": dict(one_point_classical_prolong=False,
                       matrix_free_polys=True),
    "newton_assembled": dict(inverse_type="NEWTON", poly_order=4),
    "newton_assembled_coarse": dict(coarsest_inverse_type="NEWTON",
                                    coarsest_poly_order=6),
    "newton_mf_smooth_sep": dict(inverse_type="NEWTON",
                                 matrix_free_polys=True, poly_order=4),
    "strong_r": dict(strong_r_threshold=0.01),
    "strong_r_mf": dict(strong_r_threshold=0.01, matrix_free_polys=True),
    "strong_r_dense": dict(strong_r_threshold=1e-6),
    "improve_z": dict(improve_z_its=2),
    "symmetric_ptap": dict(symmetric=True),
    "lair": dict(z_type="LAIR"),
    "sai_lair": dict(z_type="LAIR_SAI"),
    "sai_smoother": dict(inverse_type="SAI"),
    "isai_smoother": dict(inverse_type="ISAI"),
    "constrain_z": dict(constrain_z=True),
    "constrain_wz_ideal": dict(one_point_classical_prolong=False,
                               constrain_w=True, constrain_z=True),
    "improve_wz_ideal": dict(one_point_classical_prolong=False,
                             improve_w_its=2, improve_z_its=1),
    "strong_r_ideal_w": dict(strong_r_threshold=0.01,
                             one_point_classical_prolong=False),
    "full_smooth": dict(full_smoothing_up_and_down=True),
    "full_smooth_mf": dict(full_smoothing_up_and_down=True,
                           matrix_free_polys=True),
    "full_smooth_jac": dict(full_smoothing_up_and_down=True,
                            inverse_type="JACOBI"),
    "full_smooth_ideal": dict(full_smoothing_up_and_down=True,
                              one_point_classical_prolong=False),
    "full_smooth_sym": dict(full_smoothing_up_and_down=True, symmetric=True),
    "lair_improve_z": dict(z_type="LAIR", improve_z_its=2),
    "lair_improve_z_mf": dict(z_type="LAIR", improve_z_its=2,
                              matrix_free_polys=True),
    "sai_lair_improve_z": dict(z_type="LAIR_SAI", improve_z_its=1),
    "lair_improve_z_sai_inv": dict(z_type="LAIR", inverse_type="SAI",
                                   improve_z_its=1),
    "fs_lair_improve_z": dict(z_type="LAIR", improve_z_its=2,
                              full_smoothing_up_and_down=True),
    "fs_lair_improve_z_jac": dict(z_type="LAIR", improve_z_its=2,
                                  inverse_type="JACOBI",
                                  full_smoothing_up_and_down=True),
    "fs_lair_improve_z_mf": dict(z_type="LAIR", improve_z_its=2,
                                 matrix_free_polys=True,
                                 full_smoothing_up_and_down=True),
    "fs_lair_improve_z_sai": dict(z_type="LAIR", improve_z_its=1,
                                  inverse_type="SAI",
                                  full_smoothing_up_and_down=True),
    "sai_ideal_w": dict(inverse_type="SAI",
                        one_point_classical_prolong=False),
    "sai_improve_z": dict(inverse_type="SAI", improve_z_its=1),
    "bench": BENCH,
    # the port's own addition: an assembled inverse of D^-1 A_ff, times
    # D^-1
    "diag_scale": dict(diag_scale_polys=True),
}


def perturbed(A, seed=3, eps=0.05):
    A2 = A.copy()
    A2.data = A2.data * (1.0 + eps * np.random.default_rng(seed)
                         .standard_normal(A2.nnz))
    return A2


def options(pkg, **kw):
    return pkg.AIROptions().replace(reuse_sparsity=True, reuse_amount=3,
                                    reuse_poly_coeffs=True, max_levels=5,
                                    **kw)


def assert_same_operators(dh, ref, skip=()):
    got, want = dh.to_scipy(), ref.to_scipy()
    assert got.keys() == want.keys()
    for name in want:
        if name in skip:
            continue
        scale = max(abs(want[name]).max(), 1e-300)
        diff = abs(got[name] - want[name]).max()
        assert diff <= OPERATOR_RTOL * scale, (name, diff, scale)
    return got


# the host re-setup iterates two sets of coefficients anew where the
# device re-setup (as the reference's) carries them over: inv(A_cc) of a
# C-point smooth and the auto-truncated coarse solver
CARRIED = {"fcf_c_smooth": ("level 0 inv_Acc", "level 1 inv_Acc",
                            "level 2 inv_Acc", "level 3 inv_Acc")}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plan_rebuilds_the_host_resetup(name, host_kernels):
    """Every operator ``plan(A2)`` rebuilds (levels, coarse inverse, top)
    equals the port's host re-setup's upload within 1e-10 of its largest
    entry."""
    A = tpf.adv_diff_2d(N)
    A2 = perturbed(A)
    opts = options(tpf, **CONFIGS[name])
    pc = tpf.PCAIR(opts, **F64).setup(A)
    dh = pc.build_device_resetup()(A2)
    ref = tpf.PCAIR(opts, **F64).setup(A)
    ref.setup(A2, "same")
    assert_same_operators(dh, ref.upload(), skip=CARRIED.get(name, ()))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_install_solve_matches_reference(name, host_kernels):
    """``install`` + ``solve`` against the JAX package's host re-setup and
    solve (its device re-setup is no oracle, reference fault 1): equal
    iterations, x within 1e-8 (host-driven GMRES in both)."""
    A = tpf.adv_diff_2d(N)
    A2 = perturbed(A)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    kw = dict(rtol=1e-8, max_it=80, eager=True)
    pc = tpf.PCAIR(options(tpf, **CONFIGS[name]), **F64).setup(A)
    pc.build_device_resetup().install(pc, A2)
    res = pc.solve(b, **kw)
    jpc = jpf.PCAIR(options(jpf, **CONFIGS[name]), jit=False)
    jpc.setup(A)
    jpc.setup(A2, structure="same")
    jres = jpc.solve(jnp.asarray(b), **kw)
    assert res.converged and jres.converged
    assert res.iterations == jres.iterations
    x, jx = res.x.numpy(), np.asarray(jres.x)
    assert np.linalg.norm(x - jx) <= 1e-8 * np.linalg.norm(jx)


def test_dense_inverse_gauss_jordan():
    """The re-setup's dense coarse inverse, Gauss-Jordan with partial
    pivoting (a zero leading entry forces a row swap), against LAPACK's
    within 1e-13 of its largest entry."""
    from pflare_tpu_torch.air.device_resetup import dense_inverse

    rng = np.random.default_rng(6)
    for n in (1, 7, 120):
        D = rng.standard_normal((n, n)) + 0.1 * n * np.eye(n)
        D[0, 0] = 0.0 if n > 1 else 2.0
        got = dense_inverse(torch.as_tensor(D)).numpy()
        want = np.linalg.inv(D)
        assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


def test_tell_operators_rebuilt():
    """A level held as a TELL ([K, n] slots) is rebuilt equal to the
    host's: the case where the reference's device re-setup fails
    (reference fault 1, tests/test_device_resetup.py::
    test_device_resetup_matches_host_values; its ``_op_layout`` maps TELL
    operators with ELL's [n, K] slots)."""
    A = tpf.adv_diff_2d(40)
    A2 = perturbed(A)
    opts = options(tpf)
    pc = tpf.PCAIR(opts, **F64).setup(A)
    dh = pc.build_device_resetup()(A2)
    tells = [(i, k) for i, lev in enumerate(dh.levels)
             for k, op in lev.items() if isinstance(op, TELL)]
    assert tells, "the hierarchy holds no TELL operator"
    ref = tpf.PCAIR(opts, **F64).setup(A)
    ref.setup(A2, "same")
    rdh = ref.upload()
    for i, k in tells:
        assert isinstance(rdh.levels[i][k], TELL)
        want = rdh.levels[i][k].to_scipy()
        assert abs(dh.levels[i][k].to_scipy() - want).max() <= \
            OPERATOR_RTOL * abs(want).max(), (i, k)
    assert_same_operators(dh, rdh)


def test_validation_matches_reference():
    """The configurations the reference's plan rejects raise its
    ValueError (tests/test_device_resetup.py:162-185)."""
    A = tpf.adv_diff_2d(25)
    cases = [(dict(), "reuse_sparsity"),
             (dict(reuse_sparsity=True, reuse_amount=2), "reuse_sparsity"),
             (dict(reuse_sparsity=True, reuse_amount=3, z_type="LAIR",
                   symmetric=True), "lair with symmetric"),
             (dict(reuse_sparsity=True, reuse_amount=3, z_type="LAIR",
                   one_point_classical_prolong=False),
              "lair with ideal prolongator")]
    for kw, match in cases:
        for pkg, extra in ((tpf, F64), (jpf, dict(jit=False))):
            pc = pkg.PCAIR(pkg.AIROptions().replace(**kw), **extra)
            pc.setup(A)
            with pytest.raises(ValueError, match=match):
                pc.build_device_resetup()
    with pytest.raises(RuntimeError):
        tpf.PCAIR(**F64).build_device_resetup()
    pc = tpf.PCAIR(options(tpf, inverse_type="NEWTON"), **F64).setup(A)
    assert pc.build_device_resetup() is not None


def test_rejects_wrong_pattern():
    A = tpf.adv_diff_2d(25)
    pc = tpf.PCAIR(options(tpf), **F64).setup(A)
    plan = pc.build_device_resetup()
    with pytest.raises(ValueError, match="SAME sparsity"):
        plan(sp.csr_matrix(sp.eye(A.shape[0])))
    with pytest.raises(ValueError, match="nnz"):
        plan(np.ones(3))


def test_repeated_installs(host_kernels):
    """Time-dependent use: three installs on drifting matrices each
    converge, x checked by scipy, and a host re-setup after them
    (``setup(A3, "same")``) reproduces a fresh one's operators."""
    A = tpf.adv_diff_2d(30)
    opts = options(tpf, **BENCH)
    pc = tpf.PCAIR(opts, **F64).setup(A)
    plan = pc.build_device_resetup()
    b = np.ones(A.shape[0])
    for step in range(3):
        A2 = perturbed(A, seed=10 + step, eps=0.02 * (step + 1))
        plan.install(pc, A2)
        res = pc.solve(b, rtol=1e-7, max_it=20)
        assert res.converged, step
        assert (np.linalg.norm(A2 @ res.x.numpy() - b)
                <= 1e-6 * np.linalg.norm(b)), step
    assert abs(pc.hierarchy.levels[0].A - A2).max() == 0
    A3 = perturbed(A, seed=20)
    pc.setup(A3, "same")
    ref = tpf.PCAIR(opts, **F64).setup(A)
    ref.setup(A3, "same")
    assert_same_operators(pc.upload(), ref.upload())


def test_auto_truncated_probe():
    """An auto-truncated hierarchy keeps its truncation level; the probe
    re-runs on the rebuilt coarse values and gives the host probe's
    quality for the same coarse matrix and carried coefficients, and the
    solve converges (tests/test_device_resetup.py:216-253)."""
    from pflare_tpu_torch.air.hierarchy import (_build_coarse_inverse,
                                                _coarse_solver_quality)

    A = tpf.adv_diff_2d(20)
    opts = options(tpf, auto_truncate_start_level=2, auto_truncate_tol=0.5,
                   coarsest_poly_order=12)
    pc = tpf.PCAIR(opts, **F64).setup(A)
    assert pc.hierarchy.auto_truncated
    n_levels = pc.n_levels
    coeffs = pc.get_poly_coefficients(-1)
    A2 = perturbed(A, eps=0.01)
    plan = pc.build_device_resetup()
    plan.install(pc, A2)
    assert pc.n_levels == n_levels and plan.probe_quality is not None
    ref = tpf.PCAIR(opts, **F64).setup(A)
    ref.setup(A2, "same")
    h = ref.hierarchy
    assert h.auto_truncated and h.n_levels == n_levels
    q_host = _coarse_solver_quality(
        h.coarse_matrix, _build_coarse_inverse(h.coarse_matrix, opts, coeffs),
        opts.seed)
    assert abs(plan.probe_quality - q_host) <= 1e-10 * q_host
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    res = pc.solve(b, rtol=1e-5, max_it=40)
    assert res.converged
    x = res.x.numpy()
    assert np.linalg.norm(A2 @ x - b) <= 1e-4 * np.linalg.norm(b)


def test_reorder_takes_the_callers_order(host_kernels):
    """Under ``reorder="rcm"`` ``plan`` and ``install`` take A2 in the
    caller's order, as ``setup(A2, "same")`` does, and rebuild the host
    re-setup's operators; the reference's plan rejects that matrix
    (reference fault 7: it compares A2 with the permuted finest matrix).
    A hierarchy with a repartitioned coarse level (here the scrambled
    matrix without the reorder) both packages reject."""
    A = tpf.adv_diff_2d(24)
    p = np.random.default_rng(8).permutation(A.shape[0])
    A = sp.csr_matrix(A[p][:, p])
    A2 = perturbed(A)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    opts = options(tpf, reorder="rcm")
    pc = tpf.PCAIR(opts, **F64).setup(A)
    assert pc._perm is not None
    assert all(lv.coarse_order is None for lv in pc.hierarchy.levels)
    plan = pc.build_device_resetup()
    ref = tpf.PCAIR(opts, **F64).setup(A)
    ref.setup(A2, "same")
    assert_same_operators(plan(A2), ref.upload())
    plan.install(pc, A2)
    kw = dict(rtol=1e-10, max_it=40, side="right")
    res, rres = pc.solve(b, **kw), ref.solve(b, **kw)
    assert res.iterations == rres.iterations
    assert np.linalg.norm(A2 @ res.x.numpy() - b) <= 1e-9 * np.linalg.norm(b)
    jpc = jpf.PCAIR(options(jpf, reorder="rcm"), jit=False)
    jpc.setup(A)
    with pytest.raises(ValueError, match="SAME sparsity"):
        jpc.build_device_resetup()(A2)
    for pkg, extra in ((tpf, F64), (jpf, dict(jit=False))):
        pcr = pkg.PCAIR(options(pkg, coarse_repartition=True), **extra)
        pcr.setup(A)
        with pytest.raises(ValueError, match="repartition"):
            pcr.build_device_resetup()


def _reference_poly_plan(A, order, so):
    pat = jpf.sparse.SparsityPattern(A.indptr, A.indices, A.shape)
    return jspgemm.FixedSparsityPolyPlan(pat, order, so)


@pytest.mark.parametrize("so", [1, 2])
def test_plan_device_halves_match_reference(so):
    """The device halves of the SpGEMM and polynomial plans (CSR value
    space) against the reference's host executions of the same plans."""
    A = tpf.adv_diff_2d(12)
    rng = np.random.default_rng(1)
    A.data = A.data * (1.0 + 0.1 * rng.standard_normal(A.nnz))
    coeffs = rng.standard_normal(5)
    plan = tspgemm.FixedSparsityPolyPlan(
        SparsityPattern(A.indptr, A.indices, A.shape), 4, so)
    got = plan.execute(torch.from_numpy(A.data), torch.from_numpy(coeffs))
    want = _reference_poly_plan(A, 4, so).execute_host(A, coeffs)
    assert np.array_equal(plan.pat_S.indices, want.indices)
    np.testing.assert_allclose(got.numpy(), want.data, rtol=1e-13,
                               atol=1e-13 * abs(want.data).max())
    step = plan.step_plan
    x = rng.standard_normal(plan.pat_S.nnz)
    got = step.execute(torch.from_numpy(x), torch.from_numpy(A.data))
    want = _reference_poly_plan(A, 4, so).step_plan.execute_host(x, A.data)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13,
                               atol=1e-13 * abs(want).max())


@pytest.mark.parametrize("incomplete", [True, False])
def test_sai_plan_matches_reference(incomplete, monkeypatch):
    """``SAISolvePlan`` + ``sai_execute`` against the reference's, on the
    lAIR blocks of a CF split and on the square inverse; ``sai_z`` under
    ``PFLARE_SAI_DEVICE=1`` (on the CPU here) against the host solves."""
    A = tpf.adv_diff_2d(14)
    n = A.shape[0]
    fine, coarse = np.arange(0, n, 2), np.arange(1, n, 2)
    A_ff = sp.csr_matrix(A[fine][:, fine])
    A_cf = sp.csr_matrix(A[coarse][:, fine])
    S = sp.csr_matrix(A_cf @ A_ff)
    S.data[:] = 1.0
    for acf, pat in ((A_cf, S), (None, A_ff)):
        plan = tsai.SAISolvePlan(A_ff, acf, pat, incomplete)
        got = plan.execute(torch.from_numpy(A_ff.data),
                           None if acf is None else torch.from_numpy(acf.data))
        jplan = jsai.SAISolvePlan(A_ff, acf, pat, incomplete)
        want = np.asarray(jplan.execute(
            jnp.asarray(A_ff.data),
            None if acf is None else jnp.asarray(acf.data)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-12 * abs(want).max())
    host = tsai.sai_z(A_ff, A_cf, S, incomplete)
    dev = tsai.sai_z(A_ff, A_cf, S, incomplete, device="cpu")
    assert abs(dev - host).max() <= 1e-12 * abs(host).max()
    # the opt-in sends the solves to the card
    seen = []
    monkeypatch.setenv("PFLARE_SAI_DEVICE", "1")
    monkeypatch.setattr(tsai, "_sai_z_device",
                        lambda *a: seen.append(a[-1]) or host)
    tsai.sai_z(A_ff, A_cf, S, incomplete)
    assert seen == [torch.device("cuda")]
