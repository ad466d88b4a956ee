"""The port's stationary GMRES, on the CPU.

``gmres_stationary`` against a dense numpy GMRES, and ``PCAIR.solve``'s
default GMRES against the reference's default (jitted) solve: equal
iteration counts and residual histories within 1e-8 of each norm plus
1e-12 of the first (the rule of tests/test_torch_air_options.py).  The
reference's jitted program runs slowly on the CPU with deep hierarchies,
so its hierarchies here stop at 4 levels.  Every test that holds the port
against the reference takes the ``host_kernels`` fixture
(tests/torch_reference.py).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

import pflare_tpu as jpf
import pflare_tpu_torch as tpf
from pflare_tpu_torch.air import pcair as tpcair
from pflare_tpu_torch.solvers import jitted, krylov
from pflare_tpu_torch.solvers.jitted import gmres_stationary
from torch_reference import host_kernels  # noqa: F401

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
HISTORY_RTOL = 1e-8
HISTORY_FLOOR = 1e-12


def _dense_gmres(A, b, x0, M, side, rtol, atol, max_it, restart):
    """Restarted GMRES in dense numpy: each cycle builds its orthonormal
    Krylov basis by modified Gram-Schmidt (twice) and solves each step's
    least-squares problem with ``lstsq``; the residual norm that ends a
    cycle is the true (right) or preconditioned (left) one."""
    op = (lambda v: M @ (A @ v)) if side == "left" else (lambda v: A @ (M @ v))
    resid = ((lambda x: M @ (b - A @ x)) if side == "left"
             else (lambda x: b - A @ x))
    x = x0.copy()
    r = resid(x)
    rhs = np.linalg.norm(M @ b if side == "left" else b)
    if rhs == 0:
        rhs = np.linalg.norm(r) or 1.0
    tol = max(rtol * rhs, atol)
    hist = [np.linalg.norm(r)]
    tot = 0
    while hist[-1] > tol and tot < max_it:
        beta = np.linalg.norm(r)
        V = [r / beta]
        H = np.zeros((restart + 1, restart))
        y = np.zeros(0)
        for j in range(min(restart, max_it - tot)):
            w = op(V[j])
            for _ in range(2):
                for i in range(j + 1):
                    h = V[i] @ w
                    H[i, j] += h
                    w = w - h * V[i]
            H[j + 1, j] = np.linalg.norm(w)
            e1 = np.zeros(j + 2)
            e1[0] = beta
            y = np.linalg.lstsq(H[: j + 2, : j + 1], e1, rcond=None)[0]
            res = np.linalg.norm(e1 - H[: j + 2, : j + 1] @ y)
            hist.append(res)
            if res <= tol or H[j + 1, j] == 0:
                break
            V.append(w / H[j + 1, j])
        update = np.array(V[: len(y)]).T @ y
        x = x + (M @ update if side == "right" else update)
        tot += len(y)
        r = resid(x)
        hist[-1] = np.linalg.norm(r)
    return x, tot, np.array(hist), hist[-1] <= tol


def _run(A, b, x0=None, M=None, side="left", rtol=1e-10, atol=0.0,
         max_it=40, restart=30):
    n = A.shape[0]
    M = np.eye(n) if M is None else M
    At, Mt = torch.from_numpy(A), torch.from_numpy(M)
    x, its, hist, done = gmres_stationary(
        lambda v: At @ v, lambda v: Mt @ v, torch.from_numpy(b),
        None if x0 is None else torch.from_numpy(x0), rtol, atol, max_it,
        restart, side)
    ref = _dense_gmres(A, b, np.zeros(n) if x0 is None else x0, M, side,
                       rtol, atol, max_it, restart)
    return (x.numpy(), its, hist[: its + 1], done), ref


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("max_it,restart", [(40, 8), (5, 30), (40, 60)],
                         ids=["restarted", "max_it<restart", "unrestarted"])
def test_gmres_stationary_matches_dense_gmres(side, max_it, restart):
    """A 50x50 nonsymmetric matrix with a Jacobi preconditioner: the same
    iterations, residual norms and solution as the dense numpy GMRES."""
    rng = np.random.default_rng(5)
    A = 4.0 * np.eye(50) + rng.standard_normal((50, 50)) / 3.0
    M = np.diag(1.0 / np.diag(A))
    b = rng.standard_normal(50)
    (x, its, hist, done), (x_ref, its_ref, h_ref, done_ref) = _run(
        A, b, M=M, side=side, max_it=max_it, restart=restart)
    assert its == its_ref and done == done_ref
    np.testing.assert_allclose(hist, h_ref, rtol=1e-9, atol=1e-13 * h_ref[0])
    np.testing.assert_allclose(x, x_ref, rtol=1e-9, atol=1e-12)
    if done:
        assert np.linalg.norm(b - A @ x) <= 1e-9 * np.linalg.norm(b)


def test_gmres_stationary_breakdown():
    """b in a 3-dimensional invariant subspace: the Krylov space is
    exhausted at step 3 (||w|| at rounding level), where GMRES has the
    solution; and b an eigenvector of a diagonal A: ||w|| is exactly 0
    at step 1, whose rotation still forms, with a zero residual."""
    rng = np.random.default_rng(2)
    Q = np.linalg.qr(rng.standard_normal((50, 50)))[0]
    A = Q @ np.diag(np.arange(1.0, 51.0)) @ Q.T
    b = Q[:, :3] @ np.array([1.0, -2.0, 0.5])
    (x, its, hist, done), (_, its_ref, h_ref, _) = _run(A, b)
    assert done and its == its_ref == 3
    assert hist[-1] <= 1e-10 * hist[0]
    np.testing.assert_allclose(A @ x, b, atol=1e-10)
    A = np.diag(np.arange(1.0, 51.0))
    b = np.zeros(50)
    b[4] = 2.0
    (x, its, hist, done), (x_ref, its_ref, _, _) = _run(A, b)
    assert done and its == its_ref == 1
    assert hist[1] == 0.0
    np.testing.assert_array_equal(x, x_ref)


def test_gmres_stationary_zero_column_guard():
    """A nilpotent A whose Krylov space of b is annihilated at once: the
    rotation is not formed (the reference's ``live`` guard), the residual
    stays ||b|| at every step, and x stays 0."""
    A = np.diag(np.ones(3), 1)
    b = np.array([1.0, 0.0, 0.0, 0.0])
    x, its, hist, done = gmres_stationary(
        lambda v: torch.from_numpy(A) @ v, lambda v: v, torch.from_numpy(b),
        None, 1e-8, 0.0, 4, 2, "left")
    assert not done and its == 4
    np.testing.assert_array_equal(hist, np.ones(5))
    np.testing.assert_array_equal(x.numpy(), np.zeros(4))


def test_gmres_stationary_zero_rhs_and_x0():
    """A zero RHS from x0 = 1 measures rtol against ||r0||."""
    rng = np.random.default_rng(7)
    A = 4.0 * np.eye(50) + rng.standard_normal((50, 50)) / 3.0
    (x, its, hist, done), (x_ref, its_ref, h_ref, _) = _run(
        A, np.zeros(50), x0=np.ones(50), side="right", rtol=1e-8)
    assert done and its == its_ref
    np.testing.assert_allclose(hist, h_ref, rtol=1e-9, atol=1e-13 * h_ref[0])
    assert np.linalg.norm(A @ x) <= 1e-8 * np.linalg.norm(A @ np.ones(50))


# ~~~~~~ PCAIR.solve's default GMRES against the reference's ~~~~~~

def _scrambled24():
    A = tpf.adv_diff_2d(24)
    p = np.random.default_rng(8).permutation(A.shape[0])
    return sp.csr_matrix(A[p][:, p])


_BENCH = dict(a_lump=True, a_drop=1e-5, strong_threshold=0.99)
_MATRICES = {"adv24": lambda: tpf.adv_diff_2d(24),
             "diff24": lambda: tpf.adv_diff_2d(24, alpha=1.0),
             "scrambled24": _scrambled24}
# id: (matrix, options, solve keywords, zero RHS from x0 = 1)
CASES = {
    "left": ("adv24", {}, {}, False),
    "right": ("adv24", {}, dict(side="right"), False),
    "restart3_left": ("adv24", {}, dict(restart=3), False),
    "restart3_right": ("adv24", {}, dict(restart=3, side="right"), False),
    "zero_rhs_x0": ("adv24", _BENCH, dict(side="right"), True),
    "rcm": ("scrambled24", dict(reorder="rcm"), {}, False),
    "single_level": ("adv24", dict(max_levels=1), {}, False),
    "full_smoothing": ("diff24", dict(full_smoothing_up_and_down=True,
                                      inverse_type="ARNOLDI"), {}, False),
    "matrix_free": ("adv24", dict(matrix_free_polys=True), {}, False),
}
_CACHE = {}


def _pcs(mat, kw, pairing):
    """(A, reference PCAIR, port PCAIR), built once per worker."""
    key = (mat, tuple(sorted(kw.items())), pairing)
    if key not in _CACHE:
        A = _MATRICES[mat]()
        kw = dict(max_levels=4) | kw
        _CACHE[key] = (A, jpf.PCAIR(jpf.AIROptions().replace(**kw)).setup(A),
                       tpf.PCAIR(tpf.AIROptions().replace(**kw),
                                 **F64).setup(A))
    return _CACHE[key]


@pytest.mark.parametrize("case", list(CASES))
def test_default_solve_matches_reference_default(case, host_kernels):
    """The port's default solve (gmres_stationary) against the
    reference's default, one jitted program: equal iterations and
    histories.  With matrix-free smoothers the reference's CPU run takes
    its host-driven GMRES instead (pflare_tpu/air/pcair.py:305-317), so
    there the iterations agree within 1, as its own
    test_default_solve_jit_first allows."""
    mat, kw, solve_kw, zero_rhs = CASES[case]
    A, jpc, tpc = _pcs(mat, kw, host_kernels)
    n = A.shape[0]
    b = (np.zeros(n) if zero_rhs
         else np.random.default_rng(1).standard_normal(n))
    x0 = np.ones(n) if zero_rhs else None
    kw = dict(rtol=1e-10, atol=1e-50, max_it=30) | solve_kw
    res = tpc.solve(b, x0=x0, **kw)
    jres = jpc.solve(jnp.asarray(b),
                     x0=None if x0 is None else jnp.asarray(x0), **kw)
    if case == "matrix_free":
        assert not jpc._cycle_jitted
        assert abs(res.iterations - jres.iterations) <= 1
        assert res.converged and jres.converged
        return
    assert jpc._cycle_jitted
    assert res.iterations == jres.iterations
    assert res.converged == jres.converged
    h, jh = res.history, np.asarray(jres.history)
    assert len(h) == len(jh) == res.iterations + 1
    assert np.all(np.abs(h - jh) <= HISTORY_RTOL * jh + HISTORY_FLOOR * jh[0])
    if res.converged:
        x = res.x.numpy()
        r = (A @ x) if zero_rhs else (A @ x - b)
        scale = np.linalg.norm(A @ x0) if zero_rhs else np.linalg.norm(b)
        assert np.linalg.norm(r) <= 1e-6 * scale


def test_default_solve_reads_once_an_iteration(monkeypatch, host_kernels):
    """The default GMRES never enters the host-driven ``gmres``, makes no
    host read a Gram-Schmidt dot, and reads at most iterations + 2 reads
    a cycle + 2 values back; ``eager=True`` and PFLARE_EAGER_KSP=1 take
    the host-driven solver, with its reads a dot."""
    A, _, tpc = _pcs("adv24", {}, host_kernels)
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    eager = tpc.solve(b, rtol=1e-10, max_it=30, restart=3, eager=True)

    def boom(*a, **k):
        raise AssertionError("the host-driven gmres ran on the default path")

    monkeypatch.setattr(tpcair, "gmres", boom)
    reads, dots = jitted.HOST_READS, krylov.HOST_READS
    res = tpc.solve(b, rtol=1e-10, max_it=30, restart=3)
    reads = jitted.HOST_READS - reads
    cycles = -(-res.iterations // 3)
    assert krylov.HOST_READS == dots
    assert res.converged and 0 < reads <= res.iterations + 2 * cycles + 2
    assert abs(res.iterations - eager.iterations) <= 1
    monkeypatch.undo()
    monkeypatch.setenv("PFLARE_EAGER_KSP", "1")
    reads, dots = jitted.HOST_READS, krylov.HOST_READS
    env = tpc.solve(b, rtol=1e-10, max_it=30, restart=3)
    assert jitted.HOST_READS == reads
    assert krylov.HOST_READS - dots > 2 * env.iterations
    np.testing.assert_array_equal(env.history, eager.history)


def test_solve_refuses_unknown_side():
    A = tpf.adv_diff_2d(8)
    pc = tpf.PCAIR(**F64).setup(A)
    with pytest.raises(ValueError, match="side"):
        pc.solve(np.ones(A.shape[0]), side="flexible")
