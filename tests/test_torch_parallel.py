"""The port's row mesh against the JAX package's on its 8 virtual CPU
devices (tests/conftest.py): the repartition helpers, sharded vectors
and operators, the halo SpMV, TSQR, the halo SpGEMM and extraction, the
distributed CF splittings and setup, the sharded V-cycle and the sharded
solve.  The port's shards all sit on "cpu", where the plain versions of
its kernels run; each exchange is counted in its mesh's log, which
stands in for the collectives the reference's tests read from the
compiled HLO."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pflare_tpu as jpf
import pflare_tpu_torch as tpf
from pflare_tpu import parallel as jpar
from pflare_tpu.sparse.dell import DELL as JDELL
from pflare_tpu_torch import parallel as tpar
from pflare_tpu_torch.parallel.mesh import padded_rows
from pflare_tpu_torch.sparse.dell import DELL, ShardedDELL
from torch_reference import host_kernels  # noqa: F401

torch.set_num_threads(1)

BENCH = dict(a_lump=True, a_drop=1e-5, strong_threshold=0.99, max_levels=4)


def _mesh(n=8):
    return tpar.make_mesh(n, device="cpu")


def _kinds(mesh):
    return set(mesh.traffic())


def test_make_mesh_places_shards():
    """n shards on the asked device; a mesh over two devices has two
    device groups, its controller the first shard's device; without a
    card "cuda" raises."""
    mesh = _mesh(8)
    assert mesh.size == 8 and mesh.device == torch.device("cpu")
    assert tpar.make_mesh(device="cpu").size == 1 and not mesh.split
    split = tpar.make_mesh(devices=["cpu", "meta"])
    assert split.split and split.device == torch.device("cpu")
    assert [g.device for g in split.groups] == [torch.device("cpu"),
                                                torch.device("meta")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tpar.make_mesh(4)


def test_repartition_helpers_equal_reference():
    A = jpf.random_diag_dominant(300, 0.03, seed=2)
    for shards in (1, 3, 8):
        assert tpar.local_nonlocal_nnz_ratio(A, shards) == \
            jpar.local_nonlocal_nnz_ratio(A, shards)
        np.testing.assert_array_equal(
            tpar.interleaved_partition(301, shards),
            jpar.interleaved_partition(301, shards))
    sizes = [65536, 16000, 3000, 700, 90, 12]
    for limit, factor in ((50, 2), (200, 4)):
        assert tpar.active_shards_schedule(sizes, 8, limit, factor) == \
            jpar.active_shards_schedule(sizes, 8, limit, factor)
    for args in ((1000, 8, 3.0, 50, 2.0), (300, 8, 3.0, 50, 2.0),
                 (1000, 8, 1.5, 50, 2.0), (1000, 1, 0.1, 50, 2.0)):
        assert tpar.should_agglomerate(*args) == \
            jpar.should_agglomerate(*args)


@pytest.mark.parametrize("grid", [16, 15], ids=["divisible", "padded"])
def test_shard_vec_and_ell_match_reference(grid):
    """shard_vec and the row-sharded ELL product equal the reference's to
    1e-12, with zeros in the pad."""
    A = jpf.adv_diff_2d(grid)
    n = A.shape[0]
    x = np.random.default_rng(grid).standard_normal(n)
    jmesh, mesh = jpar.make_mesh(8), _mesh(8)
    want_x = np.asarray(jpar.shard_vec(jnp.asarray(x), jmesh))
    got_x = tpar.shard_vec(torch.as_tensor(x), mesh).numpy()
    np.testing.assert_allclose(got_x, want_x, rtol=0, atol=1e-12)
    assert got_x.shape[0] == padded_rows(n, mesh) and not got_x[n:].any()
    want = np.asarray(jpar.shard_ell(jpf.ELL.from_scipy(A), jmesh).matvec(
        jnp.asarray(x)))
    E = tpar.shard_ell(tpf.ELL.from_scipy(A), mesh)
    got = E.matvec(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert not got[n:].any()
    assert _kinds(mesh) == {"all_gather"}


@pytest.mark.parametrize("grid", [32, 30])
def test_halo_spmv_matches_reference(grid):
    """HaloSpMV on 8 shards equals the reference's to 1e-12; only
    neighbour exchanges run."""
    A = jpf.adv_diff_2d(grid)
    x = np.random.default_rng(0).standard_normal(A.shape[0])
    want = np.asarray(jpar.HaloSpMV(A, jpar.make_mesh(8)) @ x)
    mesh = _mesh(8)
    h = tpar.HaloSpMV(A, mesh)
    np.testing.assert_allclose((h @ x).numpy(), want, rtol=0, atol=1e-12)
    assert _kinds(mesh) == {"ppermute"}
    assert all(type(b).__name__ == "DIA" for b in h.op.blocks)


def test_halo_spmv_rejects_wide_band():
    Abad = sp.random(512, 512, density=0.02,
                     random_state=np.random.RandomState(0), format="csr")
    with pytest.raises(ValueError, match="banded"):
        tpar.HaloSpMV(Abad, _mesh(8))


@pytest.mark.parametrize("kind", ["dia", "banded", "tell"])
def test_shard_containers_with_column_base(kind):
    """A shard's DIA or banded block, read from its extended window at
    column base w, and a TELL block over window columns, each equal the
    product of the rows it holds (plain versions, f64)."""
    A = tpf.adv_diff_2d(40)
    mesh = _mesh(4)
    E = tpar.HaloELL.from_scipy(A, mesh, kind=kind)
    x = np.random.default_rng(3).standard_normal(E.n_pad)
    y = E.matvec(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y[:A.shape[0]], A @ x[:A.shape[0]],
                               rtol=0, atol=1e-12)
    for s, blk in enumerate(E.blocks):
        assert getattr(blk, "col_base", E.w) == E.w
    assert abs(E.to_scipy()[:A.shape[0], :A.shape[0]] - A).max() == 0


@pytest.mark.parametrize("kind", ["dia", "banded", "tell", "ell", "dell"])
def test_device_sharding_equals_host_blocks(kind):
    """``_shard_op`` cuts a device operator on its device into the blocks
    ``from_scipy`` cuts from its host matrix: equal containers and
    products, a halo where the band check passes (adv_diff_2d(30) on 8
    shards of 113 rows, a 30-wide band), the all-gather fallback where it
    fails (a 40-wide band on 8 shards of 13 rows)."""
    from pflare_tpu_torch.parallel.halo import RowShardedOp
    from pflare_tpu_torch.parallel.mesh import _shard_op
    from pflare_tpu_torch.sparse import DIA, ELL, TELL
    from pflare_tpu_torch.sparse.banded import BandedSpMV

    make = {"dia": DIA.from_scipy, "banded": BandedSpMV.from_scipy,
            "tell": TELL.from_scipy, "ell": ELL.from_scipy,
            "dell": lambda M: DELL.from_scipy(M, device="cpu")}[kind]
    wide = sp.csr_matrix(sp.triu(sp.tril(sp.random(
        100, 100, density=0.3, random_state=np.random.RandomState(4)), 40),
        -40) + sp.eye(100))
    mesh = _mesh(8)
    for A, cls in ((tpf.adv_diff_2d(30), tpar.HaloELL),
                   (wide, RowShardedOp)):
        n_pad = padded_rows(A.shape[0], mesh)
        got = _shard_op(make(A), mesh, n_pad, "op")
        M = sp.csr_matrix(A, copy=True)
        M.resize(n_pad, n_pad)
        want = cls.from_scipy(M, mesh, n_pad=n_pad, kind=kind,
                              active=got.active)
        assert type(got) is cls and got.n_src == want.n_src
        assert abs(got.to_scipy() - want.to_scipy()).max() == 0
        for b1, b2 in zip(got.blocks, want.blocks):
            assert type(b1) is type(b2)
            assert torch.equal(b1.data[..., :b2.data.shape[-1]], b2.data)
            if kind in ("dia", "banded"):
                assert b1.col_base == b2.col_base
                assert getattr(b1, "offsets", None) == \
                    getattr(b2, "offsets", None)
                assert getattr(b1, "W", None) == getattr(b2, "W", None)
        x = torch.as_tensor(np.random.default_rng(5).standard_normal(n_pad))
        assert torch.equal(got.matvec(x), want.matvec(x))
        np.testing.assert_allclose(got.matvec(x)[:A.shape[0]].numpy(),
                                   A @ x[:A.shape[0]].numpy(), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("shards", [8, 6])
def test_tsqr_matches_reference(shards):
    """|R| of the butterfly (8 shards) or the all-gather restack (6)
    equals the reference's to 1e-10, and the power coefficients through
    make_qr_reduce equal the reference's to rtol 1e-8."""
    from pflare_tpu.inverse import coefficients_power as j_power
    from pflare_tpu_torch.inverse.gmres_poly import coefficients_power

    K = np.random.default_rng(0).standard_normal((240, 7))
    jmesh, mesh = jpar.make_mesh(shards), _mesh(shards)
    want = np.asarray(jpar.tsqr_r(jnp.asarray(K), jmesh))
    got = tpar.tsqr_r(torch.as_tensor(K), mesh).numpy()
    np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=0, atol=1e-10)
    assert _kinds(mesh) == ({"ppermute"} if shards == 8 else {"all_gather"})

    A = jpf.random_diag_dominant(256, 0.03, seed=1)
    c_ref = j_power(jpf.ELL.from_scipy(A).matvec, 256, 5, seed=9,
                    qr_reduce=jpar.make_qr_reduce(jmesh))
    c = coefficients_power(lambda v: A @ v, 256, 5, seed=9,
                           qr_reduce=tpar.make_qr_reduce(mesh))
    np.testing.assert_allclose(c, c_ref, rtol=1e-8)


def _shard_dells(A, jmesh, mesh):
    """A as the reference's row-sharded DELL and as the port's."""
    d = JDELL.from_scipy(A, dtype=jnp.float64)
    sh = jpar.row_sharding(jmesh)
    jd = JDELL(jax.device_put(d.data, sh), jax.device_put(d.cols, sh),
               d.n_cols)
    t = DELL.from_scipy(A, dtype=torch.float64, device="cpu")
    return jd, ShardedDELL(t.data, t.cols, t.n_cols, mesh)


def _csr_equal(got, want, tol=1e-12):
    got, want = sp.csr_matrix(got), sp.csr_matrix(want)
    for M in (got, want):
        M.sort_indices()
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=0, atol=tol)


def test_halo_spgemm_matches_reference_neighbour_only():
    """A @ A with a relative drop on the 8-shard halo path equals the
    reference's halo product (patterns equal, values to 1e-12); the
    mesh's log shows neighbour exchanges only."""
    from pflare_tpu.sparse.dell import spgemm_drop_dell as j_spgemm
    from pflare_tpu_torch.sparse.dell import spgemm_drop_dell

    A = jpf.adv_diff_2d(48)
    jmesh, mesh = jpar.make_mesh(8), _mesh(8)
    jd, td = _shard_dells(A, jmesh, mesh)
    want = j_spgemm(jd, jd, 0.1, True, False).to_scipy()
    got = spgemm_drop_dell(td, td, 0.1, True, False)
    assert isinstance(got, ShardedDELL)
    _csr_equal(got.to_scipy(), want)
    assert _kinds(mesh) == {"ppermute"}


def test_halo_extraction_matches_reference_neighbour_only():
    """The sharded submatrix extraction with and without the ensured
    diagonal equals the reference's; neighbour exchanges only; a
    rectangular operator is refused and extracted by the plain gather,
    as the reference does."""
    from pflare_tpu.sparse.dell import extract_dell as j_extract
    from pflare_tpu_torch.parallel.halo_spgemm import extract_halo
    from pflare_tpu_torch.sparse.dell import extract_dell

    A = jpf.adv_diff_2d(48)
    n = A.shape[0]
    jmesh, mesh = jpar.make_mesh(8), _mesh(8)
    jd, td = _shard_dells(A, jmesh, mesh)
    rng = np.random.default_rng(0)
    is_f = rng.random(n) < 0.6
    n_f = int(is_f.sum())
    idx = np.nonzero(is_f)[0].astype(np.int32)
    new = (np.cumsum(is_f) - 1).astype(np.int32)
    for ed in (True, False):
        want = j_extract(jd, jnp.asarray(idx), jnp.asarray(is_f),
                         jnp.asarray(new), n_f, ensure_diag=ed).to_scipy()
        got = extract_dell(td, torch.as_tensor(idx), torch.as_tensor(is_f),
                           torch.as_tensor(new), n_f, ensure_diag=ed)
        _csr_equal(got.to_scipy(), want)
    assert _kinds(mesh) == {"ppermute"}

    R = sp.csr_matrix(sp.random(16, 32, density=0.2, random_state=1)
                      + sp.eye(16, 32))
    keep = rng.random(32) < 0.7
    _, tr = _shard_dells(R, jmesh, mesh)
    args = (torch.arange(16, dtype=torch.int32), torch.as_tensor(keep),
            torch.as_tensor((np.cumsum(keep) - 1).astype(np.int32)))
    assert extract_halo(tr, *args, False, mesh) is None
    got = extract_dell(tr, *args, int(keep.sum()))
    want = sp.csr_matrix(R[:, keep])
    assert abs(got.to_scipy() - want).max() == 0


@pytest.mark.parametrize("splitting", ["PMISR_DDC", "PMIS", "AGG",
                                       "PMIS_AGG"])
def test_distributed_cf_splitting_matches_reference(splitting):
    """The sharded Luby rounds and the shard-local aggregations give the
    reference's ``compute_cf_splitting(..., mesh=)`` markers."""
    from pflare_tpu.cf.splitting import compute_cf_splitting as j_split
    from pflare_tpu_torch.cf.splitting import compute_cf_splitting

    A = jpf.adv_diff_2d(40)
    t = getattr(jpf.CFSplittingType, splitting)
    kw = dict(strong_threshold=0.5, cf_splitting_type=t)
    want = j_split(A, mesh=jpar.make_mesh(8), **kw)
    got = compute_cf_splitting(A, mesh=_mesh(8), **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("power", [False, True], ids=["bench", "power"])
def test_distributed_setup_matches_reference(host_kernels, power):
    """setup(A, mesh=make_mesh(8)) against the reference's on
    adv_diff_2d(32): markers equal, R to 1e-11, W/Z/AP/RAP all
    row-sharded products, the power coefficients (TSQR) to the
    reference test's own rtol 5e-2 / atol 1e-5, and equal GMRES
    iterations."""
    from pflare_tpu_torch.air import operators as tops

    A = jpf.adv_diff_2d(32)
    kw = dict(BENCH, one_point_classical_prolong=power)
    if power:
        kw.update(inverse_type="POWER", coarsest_inverse_type="POWER")
    ref = jpf.PCAIR(jpf.AIROptions().replace(**kw))
    ref.setup(A, mesh=jpar.make_mesh(8))
    tops.MESH_PRODUCT_LOG = log = []
    try:
        pc = tpf.PCAIR(tpf.AIROptions().replace(**kw), dtype=torch.float64,
                       device="cpu").setup(A, mesh=_mesh(8))
    finally:
        tops.MESH_PRODUCT_LOG = None
    names = {"Z", "AP", "RAP"} | (set() if power else {"W"})
    assert names <= {name for name, _ in log} and all(s for _, s in log)
    assert pc.n_levels == ref.n_levels
    for lt, lr in zip(pc.hierarchy.levels, ref.hierarchy.levels):
        np.testing.assert_array_equal(lt.fine, lr.fine)
        np.testing.assert_array_equal(lt.coarse, lr.coarse)
        assert lt.R.nnz == lr.R.nnz
        np.testing.assert_allclose(lt.R.toarray(), lr.R.toarray(),
                                   rtol=0, atol=1e-11 * abs(lr.R).max())
        if power and lr.inv_Aff.coefficients is not None:
            np.testing.assert_allclose(
                np.asarray(lt.inv_Aff.coefficients),
                np.asarray(lr.inv_Aff.coefficients), rtol=5e-2, atol=1e-5)
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    want = ref.solve(jnp.asarray(b), rtol=1e-8, max_it=20)
    got = pc.solve(b, rtol=1e-8, max_it=20)
    assert got.converged and want.converged
    assert got.iterations == want.iterations


def test_sharded_vcycle_matches_reference(host_kernels):
    """shard_hierarchy + vcycle_kaskade on 8 shards against the
    reference's sharded cycle on adv_diff_2d(16): rtol 1e-10."""
    from pflare_tpu.air.smooth import vcycle_kaskade as j_vcycle
    from pflare_tpu_torch.air.smooth import vcycle_kaskade

    A = jpf.adv_diff_2d(16)
    r = np.random.default_rng(2).standard_normal(A.shape[0])
    ref = jpf.PCAIR().setup(A)
    jlev, jci = jpar.shard_hierarchy(ref.hierarchy, jpar.make_mesh(8))
    order = ref.options.smooth_order
    want = np.asarray(j_vcycle(jlev, jci, jpar.shard_vec(
        jnp.asarray(r), jpar.make_mesh(8)), order))
    pc = tpf.PCAIR(dtype=torch.float64, device="cpu").setup(A)
    mesh = _mesh(8)
    levels, ci, _ = tpar.shard_hierarchy(pc.hierarchy, mesh)
    got = vcycle_kaskade(levels, ci, tpar.shard_vec(torch.as_tensor(r),
                                                    mesh), order).numpy()
    np.testing.assert_allclose(got[:A.shape[0]], want[:A.shape[0]],
                               rtol=1e-10, atol=1e-12)
    assert any(isinstance(op, tpar.HaloELL) for op in levels[0].values())


def _neighbour_only(mesh, label):
    kinds = mesh.traffic(label)
    return bool(kinds) and set(kinds) == {"ppermute"}


@pytest.mark.parametrize("variant", ["auto_reorder", "coarse_repartition"])
def test_sharded_solve_unstructured_neighbour_only(host_kernels, variant):
    """The port's counterparts of the reference's red
    test_auto_reorder_unstructured_neighbour_only and
    test_coarse_level_repartition_neighbour_only: on the unstructured DG
    operator the sharded solve equals the serial one to 1e-12 (f64); the
    RCM-ordered top operator, and the level after a repartitioned one,
    are HaloELL on their banded and TELL shards (which the reference
    replicates: its fault 2) and exchange with neighbours only."""
    A = tpf.dg_upwind_advection_unstructured(24)
    if variant == "auto_reorder":
        opts = tpf.AIROptions(reorder="auto", strong_threshold=0.99)
    else:
        opts = tpf.AIROptions(strong_threshold=0.99, max_levels=4,
                              coarse_repartition=True)
    pc = tpf.PCAIR(opts, dtype=torch.float64, device="cpu").setup(A)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    x_s, n_s = pc.solve_device(b, max_it=20)
    mesh = _mesh(8)
    x_m, n_m = pc.solve_device(b, max_it=20, mesh=mesh)
    assert float((x_m - x_s).norm() / x_s.norm()) < 1e-12
    np.testing.assert_allclose(n_m.numpy(), n_s.numpy(), rtol=1e-12)
    st = pc._distributed_state(mesh)
    if variant == "auto_reorder":
        assert pc._perm is not None
        assert isinstance(st.top, tpar.HaloELL)
        assert _neighbour_only(mesh, "top")
        assert {type(b).__name__ for b in st.top.blocks} == {"BandedSpMV"}
        tr = np.linalg.norm(A @ x_m.numpy() - b) / np.linalg.norm(b)
        assert tr < 1e-10
    else:
        reparted = [i for i, lv in enumerate(pc.hierarchy.levels)
                    if lv.coarse_order is not None]
        assert reparted
        i = reparted[0] + 1
        ops = [k for k, v in st.levels[i].items()
               if isinstance(v, tpar.HaloELL)]
        assert ops and all(_neighbour_only(mesh, f"level {i} {k}")
                           for k in ops)
