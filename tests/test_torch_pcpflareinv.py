"""The port's PCPFLAREINV against the JAX reference, on the CPU.

Torch copies of the data-free tests of tests/test_pcpflareinv.py, each
also run through the reference on the same inputs (f64): GMRES (or
Richardson) iteration counts equal and solutions to 1e-8 (relative
2-norm).  Then Richardson, a same-structure re-setup with reused
coefficients, the refusal of a card that is not there, and inverses
carried across from the reference (``convert.inverse_from_numpy``),
whose ``apply`` must equal the reference's to 1e-10.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

import pflare_tpu as jpf
import pflare_tpu_torch as tpf
from pflare_tpu_torch.convert import inverse_from_numpy
from pflare_tpu_torch.sparse import DIA
from torch_reference import host_kernels  # noqa: F401

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")


def _vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


def _rel(y, y_ref):
    return np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref)


def _same_solve(tpc, jpc, b, **kw):
    """Both preconditioners' solves of b: iteration counts equal, the
    solutions to 1e-8; returns the port's result."""
    res = tpc.solve(b, **kw)
    jres = jpc.solve(jnp.asarray(b), **kw)
    assert res.iterations == jres.iterations
    assert res.converged == jres.converged
    assert _rel(res.x.numpy(), np.asarray(jres.x)) <= 1e-8
    return res


def test_pcpflareinv_basic(host_kernels):
    A = tpf.random_diag_dominant(150, 0.04, seed=3)
    tpc = tpf.PCPFLAREINV(**F64).setup(A)
    jpc = jpf.PCPFLAREINV().setup(A)
    res = _same_solve(tpc, jpc, _vec(150, 0), max_it=25)
    assert res.converged


def test_pcpflareinv_coeff_roundtrip(host_kernels):
    """Get/SetPolyCoeffs protocol (reference: tests/ex6_getcoeffs.c)."""
    A = tpf.random_diag_dominant(100, 0.05, seed=4)
    pc = tpf.PCPFLAREINV(matrix_free=True, **F64).setup(A)
    coeffs = pc.get_poly_coeffs()
    assert coeffs is not None and len(coeffs) == 7
    jpc = jpf.PCPFLAREINV(matrix_free=True).setup(A)
    np.testing.assert_allclose(coeffs, jpc.get_poly_coeffs(), rtol=1e-12,
                               atol=0)
    # injected before the first setup: the iteration is skipped
    pc2 = tpf.PCPFLAREINV(matrix_free=True, **F64)
    pc2.set_poly_coeffs(coeffs)
    pc2.setup(A)
    b = _vec(100, 1)
    y1 = pc.apply(b).numpy()
    assert np.allclose(pc2.apply(b).numpy(), y1, atol=1e-13)
    # injected after a setup: the built inverse takes them
    pc3 = tpf.PCPFLAREINV(matrix_free=True, **F64).setup(A)
    pc3.apply(b)
    pc3.set_poly_coeffs(coeffs)
    assert np.allclose(pc3.apply(b).numpy(), y1, atol=1e-13)
    jpc2 = jpf.PCPFLAREINV(matrix_free=True)
    jpc2.set_poly_coeffs(coeffs)
    jpc2.setup(A)
    _same_solve(pc2, jpc2, b, max_it=25)


def test_pcpflareinv_get_inverse_mat(host_kernels):
    A = tpf.random_diag_dominant(80, 0.06, seed=5)
    pc = tpf.PCPFLAREINV(**F64).setup(A)       # assembled by default
    M = pc.get_inverse_mat()
    assert M is not None
    b = torch.from_numpy(_vec(80, 2))
    assert np.allclose(M.matvec(b).numpy(), pc.apply(b).numpy())
    jM = jpf.PCPFLAREINV().setup(A).get_inverse_mat()
    assert _rel(M.matvec(b).numpy(),
                np.asarray(jM.matvec(jnp.asarray(b.numpy())))) <= 1e-12
    _same_solve(pc, jpf.PCPFLAREINV().setup(A), b.numpy(), max_it=25)
    assert tpf.PCPFLAREINV(matrix_free=True, **F64).setup(
        A).get_inverse_mat() is None


def test_pcpflareinv_freeze_and_reset(host_kernels):
    A = tpf.random_diag_dominant(60, 0.08, seed=6)
    pc = tpf.PCPFLAREINV(**F64).setup(A)
    inv1 = pc.inverse
    pc.freeze(True)
    pc.setup(2.0 * A)
    assert pc.inverse is inv1
    jpc = jpf.PCPFLAREINV().setup(A)
    jpc.freeze(True)
    jpc.setup(2.0 * A)
    _same_solve(pc, jpc, _vec(60, 3), max_it=25)
    pc.freeze(False)
    pc.set_options(poly_order=4)
    assert pc.inverse is None
    with pytest.raises(RuntimeError):
        pc.apply(np.zeros(60))


def test_option_reset_correctness(host_kernels):
    """matrandom_check_reset analogue (reference:
    tests/matrandom_check_reset.F90): changing an option resets the PC and
    the rebuilt preconditioner follows the new option."""
    A = tpf.random_diag_dominant(120, 0.05, seed=11)
    pc = tpf.PCPFLAREINV(poly_order=2, **F64).setup(A)
    assert len(pc.get_poly_coeffs()) == 3
    pc.set_options(poly_order=5)
    assert pc.inverse is None
    pc.setup(A)
    assert len(pc.get_poly_coeffs()) == 6
    jpc = jpf.PCPFLAREINV(poly_order=2).setup(A)
    jpc.set_options(poly_order=5)
    jpc.setup(A)
    _same_solve(pc, jpc, _vec(120, 4), max_it=25)


@pytest.mark.parametrize("inverse_type,matrix_free", [
    ("ARNOLDI", False), ("NEWTON", True), ("NEUMANN", True), ("JACOBI", False)])
def test_richardson_matches_reference(inverse_type, matrix_free,
                                      host_kernels):
    A = tpf.random_diag_dominant(150, 0.04, seed=3)
    kw = dict(inverse_type=inverse_type, matrix_free=matrix_free)
    res = _same_solve(tpf.PCPFLAREINV(**kw, **F64).setup(A),
                      jpf.PCPFLAREINV(**kw).setup(A), _vec(150, 5),
                      ksp="richardson", rtol=1e-8, max_it=200)
    assert res.converged
    assert len(res.residual_norms) == res.iterations + 1


def test_same_structure_reuses_coefficients(host_kernels):
    """structure='same' with reuse_poly_coeffs keeps the first setup's
    polynomial for the new values, as the reference does."""
    A = tpf.random_diag_dominant(150, 0.04, seed=3)
    A2 = sp.csr_matrix(A.copy())
    A2.data *= 1.0 + 0.1 * np.random.default_rng(7).random(A2.nnz)
    pcs = []
    for pkg, kw in ((tpf, F64), (jpf, {})):
        pc = pkg.PCPFLAREINV(**kw).setup(A)
        c1 = pc.get_poly_coeffs()
        pc.reuse_poly_coeffs = True
        pc.setup(A2, structure="same")
        assert np.array_equal(pc.get_poly_coeffs(), c1)
        pcs.append(pc)
    fresh = tpf.PCPFLAREINV(**F64).setup(A2).get_poly_coeffs()
    assert not np.allclose(fresh, pcs[0].get_poly_coeffs())
    _same_solve(*pcs, _vec(150, 6), max_it=25)


def test_structured_operators_take_dia():
    """On adv_diff_2d the Krylov operator and the assembled inverses of
    sparsity orders 1 and 2 are DIA (the DIA kernel on a card); a
    matrix-free inverse shares the Krylov operator."""
    A = tpf.adv_diff_2d(24)
    for order, K in ((1, 3), (2, 6)):
        op, inv = tpf.PCPFLAREINV(inverse_sparsity_order=order,
                                  **F64).setup(A).upload()
        assert isinstance(op, DIA) and isinstance(inv.mat, DIA)
        assert len(inv.mat.offsets) == K
    op, inv = tpf.PCPFLAREINV(matrix_free=True, **F64).setup(A).upload()
    assert inv.mat is op


def test_no_silent_cpu_run():
    """device='cuda' without a card raises; it never runs on the CPU."""
    if torch.cuda.is_available():
        assert tpf.PCPFLAREINV().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tpf.PCPFLAREINV()
    text = tpf.PCPFLAREINV(**F64).view(out=lambda s: None)
    assert "ARNOLDI" in text and "cpu" in text


def _spec(jinv, A):
    """A reference inverse as ``inverse_from_numpy`` takes it: the
    assembled or dense matrix, or the coefficients or roots with A."""
    kind = jinv.kind
    if kind == "assembled":
        return {"kind": kind, "matrix": jinv.mat.to_scipy()}
    if kind == "dense":
        return {"kind": kind, "matrix": np.asarray(jinv.mat)}
    if kind == "diagonal":
        return {"kind": kind, "diag": np.asarray(jinv.diag)}
    return {"kind": kind, "matrix": A,
            "coefficients": np.asarray(jinv.coefficients),
            "diag": None if jinv.diag is None else np.asarray(jinv.diag),
            "scaled": jinv.scaled}


@pytest.mark.parametrize("opts", [
    dict(), dict(matrix_free=True, diag_scale=True),
    dict(inverse_type="NEWTON", matrix_free=True),
    dict(inverse_type="NEUMANN", matrix_free=True),
    dict(inverse_type="WJACOBI"), dict(inverse_type="LU")],
    ids=["arnoldi", "arnoldi-mf-scaled", "newton-mf", "neumann-mf",
         "wjacobi", "lu"])
def test_inverse_carried_across_matches_reference(opts):
    """A reference PCPFLAREINV's inverse, carried across as arrays, applies
    as the reference's does, to 1e-10."""
    A = tpf.random_diag_dominant(150, 0.04, seed=3)
    jpc = jpf.PCPFLAREINV(**opts).setup(A)
    inv = inverse_from_numpy(_spec(jpc.inverse, A), torch.float64, "cpu")
    assert inv.kind == jpc.inverse.kind
    b = _vec(150, 8)
    assert _rel(inv.apply(torch.from_numpy(b)).numpy(),
                np.asarray(jpc.apply(jnp.asarray(b)))) <= 1e-10
