"""The port's approximate inverses against the JAX reference, on the CPU.

``build_inverse`` of both packages on the same matrix, f64, every inverse
type with the ``matrix_free`` and ``diag_scale`` settings the reference
reads for it: kinds equal, coefficients or roots to 1e-12 (elementwise,
relative), assembled patterns identical with values to 1e-12 of the
largest, dense and diagonal inverses to 1e-12, ``apply`` on a seeded
vector to 1e-10 (relative 2-norm).  Then torch copies of the reference's
data-free oracles (tests/test_inverse.py) and the SAI Z build on a
hierarchy's level 0.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

from pflare_tpu.inverse import build_inverse as jbuild_inverse
from pflare_tpu.inverse import sai as jsai
from pflare_tpu.sparse.pattern import SparsityPattern as JPattern
from pflare_tpu.sparse.spgemm import FixedSparsityPolyPlan as JPlan
import pflare_tpu_torch as tpf
from pflare_tpu_torch import InverseType as T
from pflare_tpu_torch.air.operators import extract_submatrices
from pflare_tpu_torch.inverse import build_inverse
from pflare_tpu_torch.inverse import sai as tsai
from pflare_tpu_torch.inverse.gmres_poly import (coefficients_arnoldi,
                                                 coefficients_power)
from pflare_tpu_torch.solvers import gmres
from pflare_tpu_torch.sparse import ELL, SparsityPattern
from pflare_tpu_torch.sparse.spgemm import FixedSparsityPolyPlan
from torch_reference import NUMPY, host_kernels  # noqa: F401

torch.set_num_threads(1)

F64 = torch.float64

MATRICES = {
    "adv_diff_32": lambda: tpf.adv_diff_2d(32),
    "random_150": lambda: tpf.random_diag_dominant(150, 0.04, seed=3),
}

# (type, matrix_free, diag_scale): every setting the reference reads --
# the polynomial bases read both, NEUMANN only matrix_free, the rest none
_POLY = (T.POWER, T.ARNOLDI, T.NEWTON, T.NEWTON_NO_EXTRA)
CASES = ([(t, mf, ds) for t in _POLY for mf in (False, True)
          for ds in (False, True)]
         + [(T.NEUMANN, False, False), (T.NEUMANN, True, False)]
         + [(t, False, False) for t in (T.JACOBI, T.WJACOBI, T.SAI, T.ISAI,
                                        T.LU)])


def _case_id(case):
    t, mf, ds = case
    return t.name.lower() + ("-mf" if mf else "") + ("-scaled" if ds else "")


def _vec(n, seed=3):
    return np.random.default_rng(seed).standard_normal(n)


def _same_csr(M, N, rtol):
    M, N = sp.csr_matrix(M), sp.csr_matrix(N)
    M.sort_indices()
    N.sort_indices()
    assert M.shape == N.shape
    assert np.array_equal(M.indptr, N.indptr)
    assert np.array_equal(M.indices, N.indices)
    scale = max(np.abs(M.data).max(initial=0.0), 1e-300)
    assert np.abs(M.data - N.data).max(initial=0.0) <= rtol * scale


def _apply(inv, x):
    """The port's inverse applied on the CPU in f64."""
    return inv.to("cpu", F64).apply(torch.from_numpy(x)).numpy()


def _rel(y, y_ref):
    return np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref)


@pytest.mark.parametrize("matrix", list(MATRICES))
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_build_inverse_matches_reference(case, matrix, host_kernels):
    itype, mf, ds = case
    A = MATRICES[matrix]()
    ref = jbuild_inverse(None, int(itype), matrix_free=mf, diag_scale=ds,
                         A_scipy=A)
    inv = build_inverse(A, itype, matrix_free=mf, diag_scale=ds)
    assert inv.kind == ref.kind
    assert (ref.coefficients is None) == (inv.coefficients is None)
    if ref.coefficients is not None:
        np.testing.assert_allclose(inv.coefficients,
                                   np.asarray(ref.coefficients),
                                   rtol=1e-12, atol=0)
    if inv.kind == "assembled":
        _same_csr(ref.host_csr, inv.host_csr, 1e-12)
    elif inv.kind == "diagonal":
        np.testing.assert_allclose(inv.diag, np.asarray(ref.diag),
                                   rtol=1e-12, atol=0)
    elif inv.kind == "dense":
        d = np.abs(inv.mat - np.asarray(ref.mat)).max()
        assert d <= 1e-12 * np.abs(inv.mat).max()
    x = _vec(A.shape[0])
    dev = inv.to("cpu", F64)
    assert dev.num_matvecs == ref.num_matvecs
    y_ref = np.asarray(ref.apply(jnp.asarray(x)))
    assert _rel(dev.apply(torch.from_numpy(x)).numpy(), y_ref) <= 1e-10


@pytest.mark.parametrize("order,sparsity_order", [(4, 1), (4, 2), (6, 3)])
def test_fixed_sparsity_poly_plan_matches_reference(order, sparsity_order,
                                                    host_kernels):
    """The assembled Neumann's plan on N = I - D^-1 A (no structural
    diagonal): the reference's host plan's pattern, and its values to
    1e-12 of the largest -- bit for bit on the numpy paths, which sum the
    same triples in the same order (the reference's native sweep may
    fuse a multiply and an add)."""
    A = tpf.random_diag_dominant(120, 0.05, seed=2)
    d = A.diagonal()
    N = sp.csr_matrix(sp.eye(120, format="csr") - sp.diags(1.0 / d) @ A)
    N.sort_indices()
    coeffs = np.random.default_rng(1).standard_normal(order + 1)
    ref = JPlan(JPattern(N.indptr, N.indices, N.shape), order,
                sparsity_order).execute_host(N, coeffs)
    out = FixedSparsityPolyPlan(SparsityPattern(N.indptr, N.indices,
                                                N.shape),
                                order, sparsity_order).execute_host(N, coeffs)
    _same_csr(ref, out, 0.0 if host_kernels == NUMPY else 1e-12)


def test_sai_z_level0_matches_reference(host_kernels):
    """SAI and ISAI Z = -A_cf inv(A_ff) on the A_cf pattern of the 64^2
    main-path hierarchy's level 0, to 1e-12 of the largest entry."""
    pc = tpf.PCAIR(tpf.AIROptions(a_lump=True, a_drop=1e-5,
                                  strong_threshold=0.99),
                   dtype=F64, device="cpu").setup(tpf.adv_diff_2d(64))
    lvl = pc.hierarchy.levels[0]
    # the level keeps A_cf only for C-point smoothing
    A_cf = extract_submatrices(lvl.A, lvl.fine, lvl.coarse)[2]
    for incomplete in (True, False):
        ref = jsai.sai_z(lvl.A_ff, A_cf, A_cf, incomplete, device=False)
        Z = tsai.sai_z(lvl.A_ff, A_cf, A_cf, incomplete)
        _same_csr(ref, Z, 1e-12)


# ~~~~~~ torch copies of the reference's oracles (tests/test_inverse.py) ~~~~~~

def _solve(A, inv, rtol=1e-5, max_it=100):
    b = torch.from_numpy(_vec(A.shape[0]))
    return gmres(ELL.from_scipy(A), b, M=inv.to("cpu", F64).apply,
                 rtol=rtol, max_it=max_it)


def test_power_equals_arnoldi_low_order():
    """Power and Arnoldi bases minimise the same LS problem, so the low
    order polynomials are identical."""
    A = tpf.random_diag_dominant(60, 0.1, seed=5)
    cp = coefficients_power(lambda v: A @ v, 60, 3, seed=11)
    ca = coefficients_arnoldi(lambda v: A @ v, 60, 3, seed=11)
    assert np.allclose(cp, ca, rtol=1e-6, atol=1e-10)


def test_poly_inverse_exact_for_small_matrix():
    """For order + 1 >= n the GMRES polynomial is an exact inverse."""
    n = 8
    A = tpf.random_diag_dominant(n, 0.4, seed=2)
    inv = build_inverse(A, T.ARNOLDI, poly_order=n, matrix_free=True)
    x = _vec(n)
    assert np.allclose(A @ _apply(inv, x), x, atol=1e-8)


def test_assembled_matches_matrix_free_full_sparsity():
    A = tpf.random_diag_dominant(40, 0.08, seed=3)
    coeffs = coefficients_arnoldi(lambda v: A @ v, 40, 3, seed=11)
    mf = build_inverse(A, T.ARNOLDI, poly_order=3, matrix_free=True,
                       coefficients=coeffs)
    asm = build_inverse(A, T.ARNOLDI, poly_order=3, sparsity_order=3,
                        coefficients=coeffs)
    x = _vec(40)
    assert np.allclose(_apply(mf, x), _apply(asm, x), atol=1e-10)


def test_diag_scaled_assembled_matches_mf():
    A = tpf.random_diag_dominant(40, 0.08, seed=9)
    mf = build_inverse(A, T.POWER, poly_order=3, matrix_free=True,
                       diag_scale=True, seed=13)
    asm = build_inverse(A, T.POWER, poly_order=3, sparsity_order=3,
                        diag_scale=True, seed=13)
    x = _vec(40)
    assert np.allclose(_apply(mf, x), _apply(asm, x), atol=1e-9)


def test_neumann_assembled_and_mf():
    A = tpf.random_diag_dominant(100, 0.05, seed=6)
    for mf in (True, False):
        inv = build_inverse(A, T.NEUMANN, poly_order=4, sparsity_order=2,
                            matrix_free=mf)
        assert _solve(A, inv, max_it=40).converged, f"neumann mf={mf}"


def test_jacobi_weights():
    A = tpf.random_diag_dominant(50, 0.1, seed=7)
    inv_w = build_inverse(A, T.WJACOBI)
    inv_u = build_inverse(A, T.JACOBI)
    d = A.diagonal()
    Dm = sp.diags(1.0 / np.sqrt(np.abs(d)))
    w = 3.0 / (4.0 * abs(Dm @ A @ Dm).sum(axis=1).max())
    assert np.allclose(inv_w.diag, w / d, rtol=1e-10)
    assert np.allclose(inv_u.diag, 1.0 / d, rtol=1e-12)
    assert _solve(A, inv_w, max_it=200).converged


def test_sai_exact_with_full_pattern():
    A = tpf.random_diag_dominant(20, 0.3, seed=8)
    M = tsai.sai_inverse(A, incomplete=False,
                         sparsity=sp.csr_matrix(np.ones((20, 20))))
    assert np.allclose((M @ A).toarray(), np.eye(20), atol=1e-8)


def test_sai_isai_solve():
    A = tpf.random_diag_dominant(150, 0.04, seed=9)
    for t in (T.SAI, T.ISAI):
        inv = build_inverse(A, t, sparsity_order=1)
        assert _solve(A, inv, max_it=60).converged, f"{t.name} failed"


def test_coefficient_reuse_protocol():
    """Rebuilding from saved coefficients reproduces the preconditioner
    (reference: tests/ex6_getcoeffs.c)."""
    A = tpf.random_diag_dominant(80, 0.05, seed=10)
    inv1 = build_inverse(A, T.ARNOLDI, poly_order=4, matrix_free=True)
    inv2 = build_inverse(A, T.ARNOLDI, poly_order=4, matrix_free=True,
                         coefficients=np.asarray(inv1.coefficients))
    x = _vec(80)
    assert np.allclose(_apply(inv1, x), _apply(inv2, x), atol=1e-14)


def test_sai_batched_matches_loop_oracle():
    """Batched padded-QR SAI/ISAI == per-row solves, with an empty row and
    the rank-deficient min-norm fallback (reference: src/SAI_Z.F90)."""
    rng = np.random.RandomState(21)
    n_f, n_c = 90, 30
    A_ff = sp.csr_matrix(sp.random(n_f, n_f, density=0.07, random_state=rng)
                         + sp.diags(2.0 + rng.rand(n_f)))
    A_ff.sort_indices()
    A_cf = sp.csr_matrix(sp.random(n_c, n_f, density=0.1, random_state=rng))
    A_cf = sp.vstack([A_cf[: n_c - 1], sp.csr_matrix((1, n_f))]).tocsr()
    A_cf.sort_indices()
    S = sp.csr_matrix((np.ones(A_cf.nnz), A_cf.indices, A_cf.indptr),
                      shape=A_cf.shape)
    for inc in (True, False):
        Zb = tsai.sai_z(A_ff, A_cf, S, inc, batched=True)
        Zl = tsai._sai_z_loop(A_ff, A_cf, S, inc)
        assert (Zb.indptr == Zl.indptr).all()
        assert (Zb.indices == Zl.indices).all()
        assert np.allclose(Zb.data, Zl.data, atol=1e-9)
    # a rank-deficient local block from an empty A_ff row
    A2 = A_ff.tolil()
    A2[3, :] = 0
    A2 = A2.tocsr()
    A2.eliminate_zeros()
    A2.sort_indices()
    Zb = tsai.sai_z(A2, A_cf, S, True, batched=True)
    Zl = tsai._sai_z_loop(A2, A_cf, S, True)
    assert (Zb.indices == Zl.indices).all()
    assert np.allclose(Zb.data, Zl.data, atol=1e-8)
