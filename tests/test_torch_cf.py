"""The port's CF splittings and the host helpers of the AIR options
against the JAX reference, on the CPU.

CF markers are compared exactly (every later level depends on them), for
every splitting type, with both packages on the same host kernels (the
``host_kernels`` fixture, tests/torch_reference.py) and with the port's
native kernels against its own numpy fallbacks.  The helpers the option
paths use -- the distance-2 strength matrix, pattern restriction, the
symbolic product, the near-nullspace constraint, the Newton residual
polynomial, the coarse repartition, FGMRES and the fixed-iteration device
GMRES -- are held against their reference counterparts.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

import pflare_tpu as jpf
import pflare_tpu.cf as jcf
import pflare_tpu_torch as tpf
import pflare_tpu_torch.cf as tcf
from pflare_tpu_torch import native as tnative
from torch_reference import NATIVE, NUMPY, host_kernels  # noqa: F401

torch.set_num_threads(1)

_TYPES = ("PMISR_DDC", "DIAG_DOM", "PMIS", "PMIS_DIST2", "AGG", "PMIS_AGG",
          "CR")
_MATRICES = {
    "adv32": lambda pkg: pkg.adv_diff_2d(32),
    "curved25": lambda pkg: pkg.adv_diff_2d(25, curved_velocity=True),
    "aniso20": lambda pkg: pkg.anisotropic_diffusion_2d(20, 1e-3),
    "random200": lambda pkg: pkg.random_diag_dominant(200, 0.05, seed=5),
}


def _threshold(t):
    # CR's strong_threshold is its target rate; DIAG_DOM's the max ratio
    return {"CR": 0.4, "DIAG_DOM": 0.9}.get(t, 0.5)


@pytest.mark.parametrize("matrix", list(_MATRICES))
@pytest.mark.parametrize("cf_type", _TYPES)
def test_cf_markers_match_reference(cf_type, matrix, host_kernels):
    A = _MATRICES[matrix](tpf)
    th = _threshold(cf_type)
    jf, jc = jcf.compute_cf_splitting(
        A, strong_threshold=th,
        cf_splitting_type=jpf.CFSplittingType[cf_type])
    tf, tc = tpf.compute_cf_splitting(
        A, strong_threshold=th,
        cf_splitting_type=tpf.CFSplittingType[cf_type])
    assert np.array_equal(jf, tf) and np.array_equal(jc, tc)
    assert len(tf) + len(tc) == A.shape[0] and len(tc) > 0


@pytest.mark.parametrize("cf_type", ("PMIS_DIST2", "AGG", "CR"))
def test_cf_numpy_fallback_matches_native(cf_type, monkeypatch):
    """The port's numpy fallbacks give its native kernels' markers."""
    A = tpf.adv_diff_2d(24, curved_velocity=True)
    kw = dict(strong_threshold=_threshold(cf_type),
              cf_splitting_type=tpf.CFSplittingType[cf_type])
    nat = tpf.compute_cf_splitting(A, **kw)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    fb = tpf.compute_cf_splitting(A, **kw)
    assert all(np.array_equal(a, b) for a, b in zip(nat, fb))


@pytest.mark.parametrize("square,symmetrize,diag_strength", [
    (True, True, False), (True, False, False), (False, True, True),
    (True, True, True)])
def test_strength_matrix_matches_reference(square, symmetrize, diag_strength,
                                           host_kernels):
    A = tpf.adv_diff_2d(20, curved_velocity=True)
    kw = dict(symmetrize=symmetrize, square=square,
              diag_strength=diag_strength)
    S_ref = jcf.strength_matrix(A, 0.5, **kw)
    S = tcf.strength_matrix(A, 0.5, **kw)
    assert (S_ref != S).nnz == 0
    assert np.array_equal(S_ref.indptr, S.indptr)
    assert np.array_equal(S_ref.indices, S.indices)


def test_strength_square_keeps_unit_values_before_squaring(monkeypatch):
    """Without the native kernels the scipy fallback's S + S^T could hold
    cancelling signed sums; unit values before squaring keep its
    distance-2 pattern equal to the native one."""
    A = tpf.adv_diff_2d(16, curved_velocity=True)
    nat = tcf.strength_matrix(A, 0.5, symmetrize=True, square=True)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    fb = tcf.strength_matrix(A, 0.5, symmetrize=True, square=True)
    assert (nat != fb).nnz == 0 and np.all(fb.data == 1.0)


@pytest.mark.parametrize("host_kernels", [NATIVE, NUMPY],
                         indirect=["host_kernels"])
def test_aggregation_matches_reference(host_kernels):
    A = tpf.adv_diff_2d(20)
    S = tcf.strength_matrix(A, 0.5, symmetrize=True)
    seed_cf = np.zeros(A.shape[0], dtype=np.int64)
    seed_cf[::37] = 1
    for cf0 in (None, seed_cf):
        j_cf, j_agg = jcf.serial_aggregation(S, cf_markers=cf0)
        t_cf, t_agg = tcf.serial_aggregation(S, cf_markers=cf0)
        assert np.array_equal(j_cf, t_cf)
        assert np.array_equal(j_agg, t_agg)


def test_diag_dom_submatrix_matches_reference(host_kernels):
    A = tpf.adv_diff_2d(25)
    sub_ref, idx_ref = jpf.compute_diag_dom_submatrix(A, max_dd_ratio=0.9)
    sub, idx = tpf.compute_diag_dom_submatrix(A, max_dd_ratio=0.9)
    assert np.array_equal(idx, idx_ref)
    assert (sub != sub_ref).nnz == 0
    from pflare_tpu_torch.sparse.ops import diag_dominance_ratio

    assert diag_dominance_ratio(sub, np.ones(sub.shape[0], bool)).max() < 0.9


@pytest.mark.parametrize("lump,alpha", [(False, None), (True, None),
                                        (False, 0.5)])
def test_remove_from_sparse_match_matches_reference(lump, alpha):
    rng = np.random.default_rng(3)
    A = sp.random(60, 60, density=0.1, random_state=4, format="csr") \
        + sp.eye(60)
    P = sp.random(60, 60, density=0.05, random_state=5, format="csr") \
        + sp.eye(60)
    A.data = rng.standard_normal(A.nnz)
    ref = jpf.remove_from_sparse_match(A, P, lump=lump, alpha=alpha)
    got = tpf.remove_from_sparse_match(A, P, lump=lump, alpha=alpha)
    assert np.array_equal(ref.indices, got.indices)
    assert np.array_equal(ref.data, got.data)


def test_symbolic_matmat_and_identity_match_reference():
    from pflare_tpu.sparse import ops as jops
    from pflare_tpu_torch.sparse import ops as tops

    A = tpf.adv_diff_2d(12)
    B = sp.csr_matrix(A.T)
    ref, got = jops.symbolic_matmat(A, B), tops.symbolic_matmat(A, B)
    assert (ref != got).nnz == 0 and np.all(got.data == 1.0)
    assert (jops.identity_csr(7, 2.0) != tops.identity_csr(7, 2.0)).nnz == 0


def test_constrain_grid_transfer_projector():
    """W B_c = B_f holds on every row whose support can represent it, and
    decayed candidates leave W unchanged (the reference's absolute sigma
    cutoff; tests/test_air.py:239-263); equal to the reference's."""
    from pflare_tpu.air.constrain import constrain_grid_transfer as jcgt
    from pflare_tpu_torch.air.constrain import constrain_grid_transfer

    rng = np.random.default_rng(5)
    W = sp.random(80, 30, density=0.2, random_state=9, format="csr")
    W.sort_indices()
    b_c = [rng.standard_normal(30) + 2.0]
    b_f = [rng.standard_normal(80)]
    Wc = constrain_grid_transfer(W, b_f, b_c, is_z=False)
    assert Wc.nnz == W.nnz
    r = np.abs(Wc @ b_c[0] - b_f[0])
    assert r[np.diff(W.indptr) > 0].max() < 1e-10
    ref = jcgt(W, b_f, b_c, is_z=False)
    np.testing.assert_allclose(Wc.toarray(), ref.toarray(), rtol=0,
                               atol=1e-13)
    Wt = constrain_grid_transfer(W, [v * 1e-12 for v in b_f],
                                 [v * 1e-12 for v in b_c], is_z=False)
    assert abs(Wt - W).max() == 0.0
    Zc = constrain_grid_transfer(W.T.tocsr(), b_f, b_c, is_z=True)
    np.testing.assert_allclose(
        Zc.toarray(), jcgt(W.T.tocsr(), b_f, b_c, is_z=True).toarray(),
        rtol=0, atol=1e-13)


def test_newton_residual_apply_matches_reference():
    """pi(A) x of a matrix-free Newton inverse, plain and diagonally
    scaled, against the reference's residual applier."""
    from pflare_tpu.inverse import build_inverse as jbuild

    A = tpf.adv_diff_2d(16)
    x = np.random.default_rng(2).standard_normal(A.shape[0])
    for scale in (False, True):
        kw = dict(poly_order=5, matrix_free=True, diag_scale=scale)
        ref = jbuild(None, jpf.InverseType.NEWTON, A_scipy=A, **kw)
        inv = tpf.inverse.build_inverse(A, tpf.InverseType.NEWTON, **kw).to(
            torch.device("cpu"), torch.float64)
        y = inv.apply_residual(torch.from_numpy(x)).numpy()
        y_ref = np.asarray(ref.apply_residual(jnp.asarray(x)))
        assert np.linalg.norm(y - y_ref) <= 1e-12 * np.linalg.norm(y_ref)
        # pi(A) = I - A q(A): the residual of the inverse's own apply
        y_alt = x - A @ inv.apply(torch.from_numpy(x)).numpy()
        assert np.linalg.norm(y - y_alt) <= 1e-10 * np.linalg.norm(x)


def test_coarse_repartition_perm_matches_reference():
    from pflare_tpu.parallel.repartition import coarse_repartition_perm as jp
    from pflare_tpu_torch.parallel import coarse_repartition_perm

    A = tpf.adv_diff_2d(24)
    p = np.random.default_rng(8).permutation(A.shape[0])
    As = sp.csr_matrix(A[p][:, p])
    perm = coarse_repartition_perm(As)
    assert perm is not None and np.array_equal(perm, jp(As))
    assert coarse_repartition_perm(A) is None and jp(A) is None


def test_fgmres_matches_reference():
    """Host-driven restarted FGMRES with a Jacobi preconditioner:
    iterations and history equal to the reference's."""
    from pflare_tpu.solvers import fgmres as jfgmres
    from pflare_tpu.sparse import ELL as JELL

    A = tpf.random_diag_dominant(300, 0.05, seed=3)
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    d = A.diagonal()
    kw = dict(rtol=1e-8, max_it=60, restart=5)
    res = tpf.fgmres(lambda v: torch.from_numpy(A @ v.numpy()),
                     torch.from_numpy(b),
                     M=lambda v: v / torch.from_numpy(d), **kw)
    E = JELL.from_scipy(A)
    jres = jfgmres(E, jnp.asarray(b), M=lambda v: v / jnp.asarray(d), **kw)
    assert res.iterations == jres.iterations and res.converged
    np.testing.assert_allclose(res.history, np.asarray(jres.history),
                               rtol=1e-8, atol=1e-12 * jres.history[0])
    true = np.linalg.norm(A @ res.x.numpy() - b) / np.linalg.norm(b)
    assert true <= 1.01e-8


def test_gmres_right_fixed_matches_reference():
    from pflare_tpu.solvers.jitted import gmres_right_fixed as jgrf
    from pflare_tpu_torch.solvers import gmres_right_fixed

    A = tpf.adv_diff_2d(16, alpha=1.0)
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    d = A.diagonal()
    x0 = np.ones(A.shape[0])
    for guess in (None, x0):
        x, norms = gmres_right_fixed(
            lambda v: torch.from_numpy(A @ v.numpy()),
            lambda v: v / torch.from_numpy(d), torch.from_numpy(b), 12,
            x0=None if guess is None else torch.from_numpy(guess))
        xr, ref = jgrf(lambda v: jnp.asarray(A @ np.asarray(v)),
                       lambda v: v / jnp.asarray(d), jnp.asarray(b), 12,
                       x0=None if guess is None else jnp.asarray(guess))
        ref = np.asarray(ref)
        assert np.abs(norms.numpy() - ref).max() <= 1e-10 * ref[0]
        np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=0,
                                   atol=1e-10 * np.abs(np.asarray(xr)).max())
