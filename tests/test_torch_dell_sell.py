"""The device setup's DELL on the gather kernel: its packed copy and the
kernel's arithmetic over it, on the CPU.

A DELL (``pflare_tpu_torch/sparse/dell.py``) packs by an index built from
its row lengths (``pack_dells``), so the packed layout is the one the
card's ``csrc/sell_spmv.cu`` reads: ``_emulate_sell_kernel`` (the kernel
in numpy, warp by warp) must give ``sell_spmv_plain``'s bits, and both
must agree with the JAX package's ``DELL.matvec`` to rounding.  The
kernel itself runs only on a card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

import pflare_tpu_torch as tpf
from pflare_tpu.sparse import dell as jdell
from pflare_tpu_torch.convert import dell_from_numpy
from pflare_tpu_torch.sparse import dell as tdell
from pflare_tpu_torch.sparse import ell as tell
from pflare_tpu_torch.sparse.dell import DELL, PADCOL
from test_torch_sparse import _emulate_sell_kernel

torch.set_num_threads(1)

TOL = {np.float32: 1e-6, np.float64: 1e-14}


def _random_rows(lens, n_cols, seed):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(len(lens)), lens)
    cols = np.concatenate([rng.choice(n_cols, k, replace=False)
                           for k in lens]) if lens.sum() else rows
    return sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                         shape=(len(lens), n_cols))


def _empty_rows():
    """1,003 rows of 0-12 entries, a third of them empty, more columns
    than rows."""
    rng = np.random.default_rng(1)
    lens = rng.integers(1, 13, 1003)
    lens[rng.random(1003) < 0.33] = 0
    return _random_rows(lens, 1500, 1)


def _one_wide():
    """K = 1: at most one entry a row (a prolongator's shape)."""
    rng = np.random.default_rng(2)
    return _random_rows(rng.integers(0, 2, 777), 400, 2)


def _long_rows():
    """Rows longer than 32 L slots at any lane count L (the coarse
    inverse's shape), beside short ones."""
    rng = np.random.default_rng(3)
    lens = rng.integers(2, 9, 96)
    lens[::7] = rng.integers(1100, 1500, len(lens[::7]))
    return _random_rows(lens, 2000, 3)


def _empty():
    return sp.csr_matrix((300, 200))


CASES = {"empty_rows": _empty_rows, "K1": _one_wide, "long_rows": _long_rows,
         "empty": _empty}


def _dell(A, source, dtype):
    """The port's DELL of A: from scipy, or from the JAX package's DELL
    (width rounded up to a multiple of 8) through ``dell_from_numpy``."""
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    if source == "scipy":
        return DELL.from_scipy(A, dtype=tdt, device="cpu")
    J = jdell.DELL.from_scipy(A, dtype=jnp.dtype(dtype))
    return dell_from_numpy(np.asarray(J.data), np.asarray(J.cols), J.n_cols,
                           dtype=tdt, device="cpu")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("source", ["scipy", "jax"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dell_pack_kernel_emulation_and_reference(case, source, dtype):
    """A DELL's packed copy: the emulated kernel equals
    ``sell_spmv_plain`` bit for bit; both are within 1e-6 (f32) or 1e-14
    (f64) of max |y| of the JAX package's ``DELL.matvec``, as is the
    DELL's own CPU product; only live slots are packed (pads (0, 0), no
    PADCOL), and the slots past each slice's rows are pads."""
    A = CASES[case]()
    M = _dell(A, source, dtype)
    assert M.packed is None             # a CPU DELL packs when asked
    P = M.pack()
    assert P is M.packed and P.lanes in tell.LANES
    assert (int(P.cols.max()) if P.cols.numel() else 0) < A.shape[1]
    assert int((P.data != 0).sum()) <= A.nnz
    assert (tell.WARP * -(-A.nnz // tell.WARP) <= P.data.numel()
            or A.nnz == 0)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        A.shape[1]).astype(dtype))
    y = tell.sell_spmv_plain(P, x)
    np.testing.assert_array_equal(_emulate_sell_kernel(P, x), y.numpy())
    J = jdell.DELL.from_scipy(A, dtype=jnp.dtype(dtype))
    y_ref = np.asarray(J.matvec(jnp.asarray(x.numpy())))
    scale = TOL[dtype] * np.abs(y_ref).max(initial=0.0)
    assert np.abs(y.numpy() - y_ref).max(initial=0.0) <= scale
    assert np.abs(M.matvec(x).numpy() - y_ref).max(initial=0.0) <= scale
    if case == "long_rows":
        assert np.diff(A.indptr).max() > tell.WARP * P.lanes
    if case == "K1":
        # the JAX package pads its width further (to a multiple of 8)
        assert int((M.cols < PADCOL).sum(dim=1).max()) == 1
        assert M.K == 1 or source == "jax"


def test_dell_with_a_dead_slot_before_a_live_one_raises():
    """The index packs each row's first slots, so a row whose dead slot
    (PADCOL) comes before a live one cannot be packed."""
    A = _empty_rows()
    M = DELL.from_scipy(A, device="cpu")
    row = int(np.argmax(np.diff(A.indptr) >= 2))
    cols, data = M.cols.clone(), M.data.clone()
    cols[row, 0], data[row, 0] = PADCOL, 0.0
    with pytest.raises(ValueError, match="dead slot"):
        DELL(data, cols, M.n_cols).pack()
    # the same row with its slots in order packs
    c, v = tdell.sort_rows(cols, data)
    DELL(v, c, M.n_cols).pack()


def test_dell_packs_share_an_index_by_cols_and_repack_after_to():
    """DELLs on one cols tensor share one packing index (A_ff_ext and
    A_fc_ext share A's), built with one read for several patterns;
    ``pack_dells`` packs each DELL once; ``DELL.to`` makes a fresh DELL
    that packs again."""
    A = _empty_rows()
    M = DELL.from_scipy(A, device="cpu")
    N = DELL(M.data * 2, M.cols, M.n_cols)
    other = DELL.from_scipy(_one_wide(), device="cpu")
    before = tdell.PACKS
    tdell.pack_dells([M, N, other, M])
    assert tdell.PACKS == before + 3
    assert M.packed.index is N.packed.index
    assert other.packed.index is not M.packed.index
    assert torch.equal(N.packed.data, 2 * M.packed.data)
    tdell.pack_dells([M, N])
    assert tdell.PACKS == before + 3
    moved = M.to("cpu")
    assert moved._packed is None and moved.pack() is not M.packed
    assert torch.equal(moved.packed.data, M.packed.data)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dell_nonzero_slots_pack_only_nonzeros(dtype):
    """A ``nonzero_slots`` DELL whose live slots hold zeros between its
    nonzeros (the masked A_ff of a level, on A's slots) packs its nonzeros
    alone, in row order: the emulated kernel equals ``sell_spmv_plain``
    bit for bit, both agree with the whole DELL's plain product and with
    the JAX package's product of the same arrays, and the packed copy is
    smaller than the structural one."""
    A = _empty_rows()
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    M = DELL.from_scipy(A, dtype=tdt, device="cpu")
    rng = np.random.default_rng(8)
    mask = torch.from_numpy(rng.random(tuple(M.data.shape)) < 0.5)
    data = torch.where(mask, M.data, 0)
    Z = DELL(data, M.cols, M.n_cols, nonzero_slots=True)
    S = DELL(data, M.cols, M.n_cols)
    tdell.pack_dells([Z, S])
    assert Z.packed.index is not S.packed.index
    nz = int(((M.cols < PADCOL) & (data != 0)).sum())
    assert int((Z.packed.index.src >= 0).sum()) == nz
    assert Z.packed.data.numel() < S.packed.data.numel()
    assert Z.to("cpu").nonzero_slots
    x = torch.from_numpy(rng.standard_normal(M.n_cols).astype(dtype))
    y = tell.sell_spmv_plain(Z.packed, x)
    np.testing.assert_array_equal(_emulate_sell_kernel(Z.packed, x),
                                  y.numpy())
    J = jdell.DELL(jnp.asarray(data.numpy()), jnp.asarray(M.cols.numpy()),
                   M.n_cols)
    y_ref = np.asarray(J.matvec(jnp.asarray(x.numpy())))
    scale = TOL[dtype] * np.abs(y_ref).max()
    assert np.abs(y.numpy() - y_ref).max() <= scale
    assert np.abs(tdell.dell_spmv_plain(Z, x).numpy() - y_ref).max() <= scale


_SETUPS = {
    "bench": dict(a_lump=True, a_drop=1e-5, strong_threshold=0.99,
                  max_levels=6, coarsest_inverse_type="NEWTON",
                  coarsest_poly_order=24, coarsest_matrix_free_polys=True),
    "default": dict(max_levels=5),
}


@pytest.mark.parametrize("name", sorted(_SETUPS))
def test_setup_device_solve_form_dells_pack(name):
    """Every DELL a 64^2 ``setup_device`` solve form multiplies by (on the
    CPU, where the setup does not pack) keeps its live slots before its
    dead ones and packs; the emulated kernel equals ``sell_spmv_plain``
    on each, within 1e-14 of max |y| of the DELL's plain product; the
    masked A_ff and A_fc (``nonzero_slots``) pack their nonzeros alone,
    each by an index of its own, and every other packed live slot is one
    of its DELL's live slots."""
    from pflare_tpu_torch.air.device_setup import solve_form_dells

    pc = tpf.PCAIR(tpf.AIROptions().replace(**_SETUPS[name]),
                   dtype=torch.float64, device="cpu")
    pc.setup_device(tpf.adv_diff_2d(64))
    dh = pc.upload()
    dells = solve_form_dells(dh)
    assert len(dells) >= 4
    for M in dells:
        assert M._packed is None
        live = M.cols < PADCOL
        assert not bool((live[:, 1:] & ~live[:, :-1]).any())
    tdell.pack_dells(dells)
    rng = np.random.default_rng(3)
    for M in dells:
        x = torch.from_numpy(rng.standard_normal(M.n_cols))
        y = tell.sell_spmv_plain(M.packed, x)
        np.testing.assert_array_equal(_emulate_sell_kernel(M.packed, x),
                                      y.numpy())
        ref = tdell.dell_spmv_plain(M, x)
        assert float((y - ref).abs().max()) <= 1e-14 * float(
            ref.abs().max())
        live = M.packed.index.src >= 0
        if M.nonzero_slots:
            assert int(live.sum()) == int(((M.cols < PADCOL)
                                           & (M.data != 0)).sum())
            assert bool((M.packed.data[live] != 0).all())
        else:
            assert int(live.sum()) == int((M.cols < PADCOL).sum())
    masked = [lev[k] for lev in dh.levels for k in ("A_ff", "A_fc")
              if isinstance(lev[k], DELL)]
    assert masked and all(M.nonzero_slots for M in masked)
    for lev in dh.levels:
        if isinstance(lev["A_ff"], DELL) and isinstance(lev["A_fc"], DELL):
            assert lev["A_ff"].packed.index is not lev["A_fc"].packed.index
            assert lev["A_ff"].cols is lev["A_fc"].cols


@pytest.mark.parametrize("cls_name", ["HaloELL", "RowShardedOp"])
def test_stacked_dell_block_packs(cls_name):
    """The stacked DELL block of a row-sharded operator (``from_op`` on 4
    CPU shards) keeps its rows' live slots first and packs: its packed
    product equals its plain one within 1e-14 of max |y|, and the sharded
    product equals the whole DELL's."""
    from pflare_tpu_torch import parallel
    from pflare_tpu_torch.parallel import halo
    from pflare_tpu_torch.parallel.mesh import _pad_op_rows_to, padded_rows

    A = tpf.adv_diff_2d(40) + sp.random(1600, 1600, density=0.002,
                                        random_state=4) * (
        cls_name == "RowShardedOp")
    A = sp.csr_matrix(A)
    mesh = parallel.make_mesh(4, device="cpu")
    M = DELL.from_scipy(A, device="cpu")
    n_pad = padded_rows(A.shape[0], mesh)
    E = getattr(halo, cls_name).from_op(_pad_op_rows_to(M, n_pad), mesh)
    (blk,) = E.blocks
    assert isinstance(blk, DELL) and blk._packed is None
    P = blk.pack()
    rng = np.random.default_rng(4)
    xs = torch.from_numpy(rng.standard_normal(blk.n_cols))
    ref = tdell.dell_spmv_plain(blk, xs)
    got = tell.sell_spmv_plain(P, xs)
    assert float((got - ref).abs().max()) <= 1e-14 * float(ref.abs().max())
    x = torch.from_numpy(rng.standard_normal(n_pad))
    x[A.shape[0]:] = 0
    want = M.matvec(x[:A.shape[0]])
    assert float((E.matvec(x)[:A.shape[0]] - want).abs().max()) <= (
        1e-14 * float(want.abs().max()))
