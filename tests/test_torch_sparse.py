"""The port's sparse containers: DIA, banded and TELL/ELL matvecs.

On the CPU each container runs its kernel's plain PyTorch version.  It is
held against scipy (f64), against the JAX reference's Pallas kernels in
interpret mode (f32), and against CPU emulations of the CUDA kernels'
block and index arithmetic -- the kernels themselves run only on a card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

from pflare_tpu.sparse import dia as jdia
from pflare_tpu.sparse.banded import BandedSpMV as JBanded
from pflare_tpu_torch import adv_diff_2d
from pflare_tpu_torch.sparse import DIA, ELL, TELL, BandedSpMV
from pflare_tpu_torch.sparse import banded as tbanded
from pflare_tpu_torch.sparse import dia as tdia
from pflare_tpu_torch.sparse import ell as tell
from pflare_tpu_torch.air.fullspace import make_op
from torch_cases import (LEVEL0_OPERATORS, dia_odd_rows, masked_level0,
                         masked_level1)

torch.set_num_threads(1)


def _dia_case(n, seed=0):
    """The 5-offset DIA case of tests/test_sparse.py:227."""
    rng = np.random.default_rng(seed)
    offs = [-64, -1, 0, 1, 64]
    A = sp.diags([rng.random(n - abs(o)) + 0.1 for o in offs], offs,
                 format="csr")
    return A, rng.random(n)


def _band_matrix(n, w, seed):
    """The random band of tests/test_banded.py:18-30."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n):
        nz = rng.integers(1, 9)
        c = np.clip(i + rng.integers(-w, w + 1, size=nz), 0, n - 1)
        rows += [i] * len(c)
        cols += c.tolist()
        vals += rng.standard_normal(len(c)).tolist()
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    A.sum_duplicates()
    A.sort_indices()
    return A


def _rect_dia(seed=5):
    """Rectangular, wide: offsets reach past n_rows on both sides."""
    rng = np.random.default_rng(seed)
    n_rows, n_cols = 700, 2100
    rows, cols = [], []
    for off in (-5, 0, 3, 1400):
        i = np.arange(n_rows)
        ok = (i + off >= 0) & (i + off < n_cols)
        rows.append(i[ok])
        cols.append(i[ok] + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    A = sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                      shape=(n_rows, n_cols))
    A.sort_indices()
    return A


def _rel(y, ref):
    y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


def _f32_reference(A, x32):
    """Exact-in-f64 product of the f32-rounded operator and vector."""
    Af = A.copy()
    Af.data = Af.data.astype(np.float32).astype(np.float64)
    return Af @ np.asarray(x32, dtype=np.float64)


def _with_x(A, seed):
    return A, np.random.default_rng(seed).standard_normal(A.shape[1])


# n_rows = 3001, 3002, 3003 (1, 2 and 3 mod 4) and the masked level-0
# operators of the 128^2 main path, beside the reference's own cases
NEW_DIA_CASES = {
    **{f"odd{n}": (lambda n=n: _with_x(dia_odd_rows(n, seed=n), seed=n))
       for n in (3001, 3002, 3003)},
    **{f"level0_{name}": (lambda name=name: _with_x(masked_level0(name),
                                                    seed=7))
       for name in LEVEL0_OPERATORS},
}
DIA_CASES = {
    "n8192": lambda: _dia_case(8192),
    "n4224": lambda: _dia_case(4224),
    "adv64": lambda: (adv_diff_2d(64),
                      np.random.default_rng(1).standard_normal(4096)),
    "rect": lambda: (_rect_dia(),
                     np.random.default_rng(2).standard_normal(2100)),
    **NEW_DIA_CASES,
}


@pytest.mark.parametrize("case", sorted(DIA_CASES))
def test_dia_plain_matches_scipy_f64(case):
    A, x = DIA_CASES[case]()
    D = DIA.from_scipy(A, dtype=torch.float64)
    assert _rel(D.matvec(torch.from_numpy(x)), A @ x) < 1e-14
    assert abs(D.to_scipy() - A).max() == 0
    assert D.nnz == A.nnz


def test_dia_plain_matches_jax_fused_pallas(monkeypatch):
    """f32 against the reference's fused Pallas DIA kernel in interpret
    mode, run exactly as tests/test_sparse.py:212-248 runs it: aligned at
    n=8192, padded at n=4224."""
    monkeypatch.setattr(jdia, "_FUSED_MIN_ROWS", 4096)
    monkeypatch.setenv("PFLARE_DIA_FUSED", "force")
    for n, want_aligned in ((8192, True), (4224, False)):
        A, x = _dia_case(n)
        x32 = x.astype(np.float32)
        J = jdia.DIA.from_scipy(A, dtype=np.float32)
        assert J._tr[2] == want_aligned
        y_ref = np.asarray(J.matvec(jnp.asarray(x32)), dtype=np.float64)
        y = DIA.from_scipy(A, dtype=torch.float32).matvec(
            torch.from_numpy(x32)).numpy().astype(np.float64)
        assert np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref) < 1e-6


@pytest.mark.parametrize("case", sorted(NEW_DIA_CASES))
def test_new_dia_cases_match_jax_fused_pallas(monkeypatch, case):
    """f32 against the reference's fused Pallas DIA kernel in interpret
    mode on the odd-n and masked level-0 cases (forced on below the
    reference's size gate, as tests/test_sparse.py:212-248 does)."""
    monkeypatch.setattr(jdia, "_FUSED_MIN_ROWS", 1024)
    monkeypatch.setenv("PFLARE_DIA_FUSED", "force")
    A, x = NEW_DIA_CASES[case]()
    x32 = x.astype(np.float32)
    J = jdia.DIA.from_scipy(A, dtype=np.float32)
    assert J._tr is not None
    y_ref = np.asarray(J.matvec(jnp.asarray(x32)), dtype=np.float64)
    y = DIA.from_scipy(A, dtype=torch.float32).matvec(
        torch.from_numpy(x32)).numpy().astype(np.float64)
    assert np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref) < 1e-6


BAND_CASES = {
    "adv64": lambda: (adv_diff_2d(64),
                      np.random.default_rng(0).standard_normal(4096)),
    "random_band": lambda: (_band_matrix(1200, 37, 1),
                            np.random.default_rng(2).standard_normal(1200)),
    "masked_level1": lambda: _with_x(masked_level1(), seed=3),
}


@pytest.mark.parametrize("case", sorted(BAND_CASES))
def test_banded_plain_matches_scipy_f64(case):
    A, x = BAND_CASES[case]()
    assert BandedSpMV.viable(A)
    M = BandedSpMV.from_scipy(A, dtype=torch.float64)
    assert _rel(M.matvec(torch.from_numpy(x)), A @ x) < 1e-14
    assert abs(M.to_scipy() - A).max() == 0
    assert M.nnz == A.nnz


@pytest.mark.parametrize("case", sorted(BAND_CASES))
def test_banded_plain_matches_jax_pallas(case):
    """f32 against the reference's banded Pallas kernel in interpret mode,
    as tests/test_banded.py runs it: 'highest' to 1e-6, 'split' to 2e-5
    (relative to the largest entry of the exact product)."""
    A, x = BAND_CASES[case]()
    x32 = x.astype(np.float32)
    scale = np.abs(_f32_reference(A, x32)).max()
    y = BandedSpMV.from_scipy(A, dtype=torch.float32).matvec(
        torch.from_numpy(x32)).numpy().astype(np.float64)
    for prec, tol in (("highest", 1e-6), ("split", 2e-5)):
        J = JBanded.from_scipy(A, dtype=jnp.float32, precision=prec)
        y_ref = np.asarray(J.matvec(jnp.asarray(x32)), dtype=np.float64)
        assert np.abs(y - y_ref).max() / scale < tol, prec
    # the port's plain version is exact up to f32 summation rounding
    assert np.abs(y - _f32_reference(A, x32)).max() / scale < 1e-6


@pytest.mark.parametrize("case", ["adv64", "random_band"])
def test_tell_ell_plain_match_scipy_f64(case):
    A, x = BAND_CASES[case]()
    for cls in (TELL, ELL):
        M = cls.from_scipy(A, dtype=torch.float64)
        assert _rel(M.matvec(torch.from_numpy(x)), A @ x) < 1e-14
        assert abs(M.to_scipy() - A).max() == 0


def _emulate_tell_kernel(data, cols, x):
    """csrc/tell_spmv.cu in numpy: block b of BLOCK_THREADS threads owns
    rows [B b, B b + B), one a thread (threads past n return); each row
    starts its sum with slot 0's product and adds the other slots' in
    order, every product and sum rounded on its own (numpy's elementwise
    arithmetic in the value type contracts nothing into an FMA)."""
    K, n = data.shape
    B = tell.BLOCK_THREADS
    y = np.empty(n, dtype=data.dtype)
    for b0 in range(0, n, B):
        rows = np.arange(b0, min(b0 + B, n))
        acc = data[0, rows] * x[cols[0, rows]]
        for k in range(1, K):
            acc = acc + data[k, rows] * x[cols[k, rows]]
        y[rows] = acc
    return y


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["adv64", "random_band", "wide"])
def test_tell_kernel_emulation_and_reference(case, dtype):
    """The TELL kernel's arithmetic, emulated, gives the plain version's
    bits (the card test holds the kernel itself to them), and both agree
    with the JAX package's TELL product to rounding."""
    from pflare_tpu.sparse import TELL as JTELL

    if case == "wide":
        A = sp.random(700, 500, density=0.05, random_state=3, format="csr")
        x = np.random.default_rng(3).standard_normal(500)
    else:
        A, x = BAND_CASES[case]()
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    M = TELL.from_scipy(A, dtype=tdt)
    xt = torch.from_numpy(x.astype(dtype))
    y = M.matvec(xt).numpy()
    np.testing.assert_array_equal(
        _emulate_tell_kernel(M.data.numpy(), M.cols.numpy(), xt.numpy()), y)
    J = JTELL.from_scipy(A, dtype=dtype)
    y_ref = np.asarray(J.matvec(jnp.asarray(x.astype(dtype))))
    tol = 1e-6 if dtype == np.float32 else 1e-14
    assert np.abs(y - y_ref).max() <= tol * np.abs(y_ref).max()


def test_make_op_picks_by_structure():
    A = adv_diff_2d(64)
    assert isinstance(make_op(A), DIA)
    assert isinstance(make_op(_band_matrix(1200, 37, 1)), BandedSpMV)
    wide = sp.random(600, 600, density=0.02, random_state=1, format="csr")
    wide = sp.csr_matrix(wide + sp.eye(600))
    assert isinstance(make_op(wide), TELL)
    assert make_op(A, dtype=torch.float32).dtype == torch.float32
    assert make_op(A).dtype == torch.float64


def test_cpu_matvec_launches_no_kernel():
    A, x = _dia_case(4224)
    d0, b0 = tdia.KERNEL_LAUNCHES, tbanded.KERNEL_LAUNCHES
    DIA.from_scipy(A).matvec(torch.from_numpy(x))
    B = _band_matrix(1200, 37, 1)
    BandedSpMV.from_scipy(B).matvec(torch.zeros(1200, dtype=torch.float64))
    assert (tdia.KERNEL_LAUNCHES, tbanded.KERNEL_LAUNCHES) == (d0, b0)


# ~~~~~~~~~~ CPU emulations of the CUDA kernels' index arithmetic ~~~~~~~~~~

def _emulate_dia_kernel(data, offsets, x, n_rows, n_cols, vector=True):
    """csrc/dia_spmv.cu, block by block.  Thread t owns the V =
    ROWS_PER_THREAD rows from r0 = V * t (threads with r0 >= n_rows
    return); block b the B = BLOCK_THREADS * V rows from b0 = B * b.  The
    vector instantiation (``vector``: data 16-byte aligned, and n_rows a
    multiple of V) reads whole groups of V rows; the scalar one masks the
    rows past n_rows.  A block is interior when all its rows exist and its
    x range [b0 + min(off), b0 + B + max(off)) lies in [0, n_cols): it
    reads unmasked (asserted here); an edge block masks every x read to
    [0, n_cols).  Each slot adds data * x in offset order, zero or not."""
    V = tdia.ROWS_PER_THREAD[data.dtype]
    B = tdia.BLOCK_THREADS * V
    vector = vector and n_rows % V == 0
    flat = data.reshape(-1)
    zero = torch.zeros((), dtype=data.dtype)
    y = torch.empty(n_rows, dtype=data.dtype)
    for b0 in range(0, n_rows, B):
        r0 = torch.arange(b0, min(b0 + B, n_rows), V)
        rows = r0[:, None] + torch.arange(V)
        exist = rows < n_rows
        if vector:
            assert bool(exist.all())
        edge = (b0 + B > n_rows or b0 + min(offsets) < 0
                or b0 + B + max(offsets) > n_cols)
        acc = torch.zeros(rows.shape, dtype=data.dtype)
        for k, off in enumerate(offsets):
            p = k * n_rows + rows
            if edge:
                d = torch.where(exist, flat[p.clamp(max=flat.numel() - 1)],
                                zero)
            else:
                assert int(p.max()) < flat.numel()
                d = flat[p]
            c = rows + off
            if edge:
                ok = (c >= 0) & (c < n_cols)
                xv = torch.where(ok, x[c.clamp(0, n_cols - 1)], zero)
            else:
                assert int(c.min()) >= 0 and int(c.max()) < n_cols
                xv = x[c]
            acc = acc + d * xv
        y[rows[exist]] = acc[exist]
    return y


@pytest.mark.parametrize("case", sorted(DIA_CASES))
def test_dia_kernel_emulation_matches_plain(case):
    """f64, the vector instantiation where n_rows allows it."""
    A, x = DIA_CASES[case]()
    D = DIA.from_scipy(A, dtype=torch.float64)
    xt = torch.from_numpy(x)
    y_plain = D.matvec(xt)
    y_emul = _emulate_dia_kernel(D.data, D.offsets, xt, *D.shape)
    assert torch.equal(y_emul, y_plain)


@pytest.mark.parametrize("dtype,vector", [
    (torch.float64, False), (torch.float32, True), (torch.float32, False)],
    ids=["f64-scalar", "f32-vector", "f32-scalar"])
@pytest.mark.parametrize("case", sorted(DIA_CASES))
def test_dia_kernel_emulation_other_instantiations(case, dtype, vector):
    """The scalar instantiation (an unaligned base) and the f32 grouping
    (four rows a thread) are bit-equal to the plain version too: each
    side rounds every product and adds in the same order."""
    A, x = DIA_CASES[case]()
    D = DIA.from_scipy(A, dtype=dtype)
    xt = torch.from_numpy(x).to(dtype)
    y_emul = _emulate_dia_kernel(D.data, D.offsets, xt, *D.shape,
                                 vector=vector)
    assert torch.equal(y_emul, D.matvec(xt))


def _emulate_banded_kernel(M: BandedSpMV, x, rows_per_thread=4):
    """csrc/banded_spmv.cu: thread t owns rows r0 = 4t .. 4t + 3 (threads
    with r0 >= n return).  They lie in one 128-row tile, so they share one
    window base, (tile row0 // W) * W - w.  For each slot k in order the
    thread reads its rows' data and lcols (all inside n_pad), forms the
    absolute column c = base + lcols, and adds data * x[c] unless data is
    0 or c lies outside [0, n_cols); rows >= n are not stored."""
    K, n_pad = M.data.shape
    V = rows_per_thread
    assert tbanded.TILE_ROWS % V == 0 and n_pad % V == 0
    r0 = torch.arange(0, M.n, V)
    rows = r0[:, None] + torch.arange(V)
    assert int(rows.max()) < n_pad
    tile0 = r0 - r0 % tbanded.TILE_ROWS
    assert torch.equal(rows // tbanded.TILE_ROWS * tbanded.TILE_ROWS,
                       tile0[:, None].expand_as(rows))
    base = (tile0 // M.W * M.W - M.w)[:, None]
    acc = torch.zeros(rows.shape, dtype=M.data.dtype)
    for k in range(K):
        d = M.data[k, rows]
        c = base + M.lcols[k, rows].long()
        take = (d != 0) & (c >= 0) & (c < M.n_cols)
        xv = x[c.clamp(0, M.n_cols - 1)]
        acc = torch.where(take, acc + d * xv, acc)
    return acc.reshape(-1)[:M.n]


@pytest.mark.parametrize("case", sorted(BAND_CASES))
def test_banded_kernel_emulation_matches_plain(case):
    A, x = BAND_CASES[case]()
    M = BandedSpMV.from_scipy(A, dtype=torch.float64)
    xt = torch.from_numpy(x)
    assert torch.equal(_emulate_banded_kernel(M, xt), M.matvec(xt))


def test_segment_sum_equals_index_add_on_plan_triples():
    """The device re-setup's segment sum, over a product plan's triples
    sorted as ``device_tables`` sorts them, equals the CPU's
    ``index_add_`` over the triples in plan order bit for bit, and so
    does the plan's execution."""
    from pflare_tpu_torch.sparse.pattern import SparsityPattern
    from pflare_tpu_torch.sparse.spgemm import build_spgemm_plan, segment_sum

    rng = np.random.default_rng(11)
    A = sp.csr_matrix(adv_diff_2d(24))
    A.data = A.data * 10.0 ** rng.integers(-6, 6, A.nnz)
    B = sp.csr_matrix(A @ A.T)
    C = sp.csr_matrix(A @ B)
    for M in (B, C):
        M.sort_indices()
    plan = build_spgemm_plan(*(SparsityPattern(M.indptr, M.indices,
                                               M.shape) for M in (A, B, C)))
    a, b = torch.as_tensor(A.data), torch.as_tensor(B.data)
    prod = a[plan.a_pos] * b[plan.b_pos]
    want = torch.zeros(C.nnz, dtype=torch.float64).index_add_(
        0, torch.as_tensor(plan.out_pos.astype(np.int64)), prod)
    tables = plan.device_tables("cpu")
    got = segment_sum(a[tables["a_pos"]] * b[tables["b_pos"]],
                      tables["lengths"])
    assert torch.equal(got, want)
    assert torch.equal(plan.execute(a, b), want)
