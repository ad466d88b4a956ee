"""The port's row mesh over several devices, against the JAX package's
mesh on the conftest's 8 virtual CPU devices and against the port's own
mesh on one device.

Torch keeps ``cpu:0`` ... ``cpu:7`` apart as devices while every tensor
made there lies on the CPU, so a mesh of 8 shards over 4 or 8 of them
has 4 or 8 device groups: its vectors are ``Rows``, each group's
operator blocks and vector blocks are its own tensors, and every
exchange between groups is a real copy, as between cards."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pflare_tpu as jpf
import pflare_tpu_torch as tpf
from pflare_tpu import parallel as jpar
from pflare_tpu_torch import parallel as tpar
from pflare_tpu_torch.parallel.mesh import Rows, _spread, gather
from pflare_tpu_torch.sparse import ELL, TELL
from pflare_tpu_torch.sparse.dell import DELL
from torch_reference import host_kernels  # noqa: F401

torch.set_num_threads(1)

BENCH = dict(a_lump=True, a_drop=1e-5, strong_threshold=0.99, max_levels=4)
# 8 shards over 4 device groups (two a group) and over 8
LAYOUTS = {"4 groups": [f"cpu:{s // 2}" for s in range(8)],
           "8 groups": [f"cpu:{s}" for s in range(8)]}
# the JAX package's distributed setup and sharded solve at 32^2, by host
# kernel pairing (each worker makes it at most once)
_REFERENCE = {}
# the containers shard_ell takes, from a host matrix
CONTAINERS = {"ell": ELL.from_scipy, "tell": TELL.from_scipy,
              "dell": lambda M: DELL.from_scipy(M, device="cpu")}
# the JAX package's shard_ell products (plain x, shard_vec x) by case
_SHARD_ELL = {}


@pytest.fixture(params=list(LAYOUTS))
def split(request):
    return tpar.make_mesh(devices=LAYOUTS[request.param])


def _exchanges(mesh):
    """The log without the bytes that crossed devices."""
    return {k: list(v) for k, v in mesh.log.items() if k[1] != "peer"}


def test_halo_spmv_matches_reference(split):
    """(a) HaloSpMV at 32^2 against the reference's on 8 devices."""
    A = jpf.adv_diff_2d(32)
    x = np.random.default_rng(1).standard_normal(A.shape[0])
    want = np.asarray(jpar.HaloSpMV(A, jpar.make_mesh(8)) @ jnp.asarray(x))
    op = tpar.HaloSpMV(A, split)
    assert len(split.groups) > 1 and all(
        blk is None or blk.data.device == torch.device("cpu")
        for blk in op.op.blocks)
    got = op.matvec(x).numpy()
    assert np.linalg.norm(got - want) <= 1e-14 * np.linalg.norm(want)
    assert set(split.traffic()) == {"ppermute", "peer"}


@pytest.mark.parametrize("shards", [8, 6])
def test_tsqr_matches_reference(shards):
    """(b) The split mesh's TSQR (butterfly at 8 shards, restack at 6)
    against the reference's, and bit for bit the one-device mesh's."""
    K = np.random.default_rng(0).standard_normal((240, 7))
    want = np.asarray(jpar.tsqr_r(jnp.asarray(K), jpar.make_mesh(shards)))
    mesh = tpar.make_mesh(devices=[f"cpu:{s // 2}" for s in range(shards)])
    one = tpar.make_mesh(shards, device="cpu")
    got = tpar.tsqr_r(torch.as_tensor(K), mesh)
    np.testing.assert_allclose(np.abs(got.numpy()), np.abs(want), rtol=0,
                               atol=1e-10)
    assert torch.equal(got, tpar.tsqr_r(torch.as_tensor(K), one))
    assert _exchanges(mesh) == _exchanges(one)


def _reference(pairing):
    """The reference's setup(A, mesh=) at 32^2 and its sharded solve."""
    if pairing not in _REFERENCE:
        A = jpf.adv_diff_2d(32)
        b = np.random.default_rng(3).standard_normal(A.shape[0])
        ref = jpf.PCAIR(jpf.AIROptions().replace(**BENCH))
        ref.setup(A, mesh=jpar.make_mesh(8))
        # the host levels, read before the solve's upload releases them
        levels = [(np.asarray(lv.fine), np.asarray(lv.coarse), lv.n,
                   lv.R.copy()) for lv in ref.hierarchy.levels]
        _, norms = ref.solve_device(jnp.asarray(b), max_it=8,
                                    mesh=jpar.make_mesh(8))
        _REFERENCE[pairing] = (A, b, levels, np.asarray(norms))
    return _REFERENCE[pairing]


def test_distributed_slice_matches_reference(host_kernels, split):
    """(c) setup(A, mesh=) and solve_device(b, mesh=) over the device
    groups against the reference's on 8 devices: markers, level sizes
    and nnz equal, R to 1e-12 of its largest entry, the residual history
    to 1e-10 of each norm."""
    A, b, levels, want = _reference(host_kernels)
    pc = tpf.PCAIR(tpf.AIROptions().replace(**BENCH), dtype=torch.float64,
                   device="cpu").setup(A, mesh=split)
    assert len(pc.hierarchy.levels) == len(levels)
    for lt, (fine, coarse, n, R) in zip(pc.hierarchy.levels, levels):
        np.testing.assert_array_equal(lt.fine, fine)
        np.testing.assert_array_equal(lt.coarse, coarse)
        assert lt.n == n and lt.R.nnz == R.nnz
        np.testing.assert_allclose(lt.R.toarray(), R.toarray(), rtol=0,
                                   atol=1e-12 * abs(R).max())
    _, norms = pc.solve_device(b, max_it=8, mesh=split)
    np.testing.assert_allclose(norms.numpy(), want, rtol=1e-10, atol=0)


def test_split_mesh_equals_one_device(split):
    """(d) At 64^2 the setup and the sharded solve over the device groups
    against the port's own 8-shard mesh on one device: markers and R bit
    for bit, histories to 1e-12, the same exchange calls and bytes, and
    bytes crossing devices only at group borders: each product of the
    top operator copies one block each way across each border."""
    A = tpf.adv_diff_2d(64)
    b = np.random.default_rng(4).standard_normal(A.shape[0])
    opts = tpf.AIROptions().replace(**BENCH)
    one = tpar.make_mesh(8, device="cpu")
    pcs = [tpf.PCAIR(opts, dtype=torch.float64, device="cpu").setup(
        A, mesh=m) for m in (one, split)]
    for l1, l2 in zip(pcs[0].hierarchy.levels, pcs[1].hierarchy.levels):
        np.testing.assert_array_equal(l1.fine, l2.fine)
        np.testing.assert_array_equal(l1.coarse, l2.coarse)
        assert (l1.R != l2.R).nnz == 0
    assert _exchanges(one) == _exchanges(split)
    pc = pcs[1]
    for ksp in ("richardson", "gmres"):
        one.reset_log()
        split.reset_log()
        x1, n1 = pc.solve_device(b, max_it=6, ksp=ksp, mesh=one)
        x2, n2 = pc.solve_device(b, max_it=6, ksp=ksp, mesh=split)
        np.testing.assert_allclose(n2.numpy(), n1.numpy(), rtol=1e-12)
        assert float((x2 - x1).norm() / x1.norm()) < 1e-12
        assert x2.device == torch.device("cpu")
        assert _exchanges(one) == _exchanges(split)
    st = pc._distributed_state(split)
    assert isinstance(st.top, tpar.HaloELL) and st.top.active == 8
    borders = len(split.groups) - 1
    calls = split.log[("top", "ppermute")][0]
    block = st.top.w * 8            # f64
    assert split.log[("top", "peer")] == [calls * borders,
                                          calls * borders * block]


def test_halo_products_split_equal_one_device(split):
    """The setup's neighbour-only product and extraction of row-sharded
    DELLs, each shard on its group's device, equal the one-device mesh's
    bit for bit, with the same exchanges."""
    from pflare_tpu_torch.sparse.dell import (DELL, ShardedDELL,
                                              extract_dell, spgemm_drop_dell)

    A = tpf.adv_diff_2d(48)
    n = A.shape[0]
    rng = np.random.default_rng(0)
    is_f = rng.random(n) < 0.6
    args = (torch.as_tensor(np.nonzero(is_f)[0].astype(np.int32)),
            torch.as_tensor(is_f),
            torch.as_tensor((np.cumsum(is_f) - 1).astype(np.int32)),
            int(is_f.sum()))
    one = tpar.make_mesh(8, device="cpu")
    out = []
    for mesh in (one, split):
        d = DELL.from_scipy(A, dtype=torch.float64, device="cpu")
        M = ShardedDELL(d.data, d.cols, d.n_cols, mesh)
        out.append([spgemm_drop_dell(M, M, 0.1, True, False).to_scipy()]
                   + [extract_dell(M, *args, ensure_diag=ed).to_scipy()
                      for ed in (True, False)])
    for a, b in zip(*out):
        assert (a != b).nnz == 0
    assert _exchanges(one) == _exchanges(split)
    assert set(one.traffic()) == {"ppermute"}


def test_cross_device_exchange_copies(split):
    """(e) A block sent to another group is a new buffer (its data_ptr is
    not the sender's), and a halo window holds the neighbour's values."""
    x = torch.arange(64, dtype=torch.float64)
    v = tpar.shard_vec(x, split)
    assert isinstance(v, Rows) and len(v.parts) == len(split.groups)
    sent = split.send(v.parts[0], split.groups[1].device, "test")
    assert sent.data_ptr() != v.parts[0].data_ptr()
    assert torch.equal(sent, v.parts[0])
    counts = [g.stop - g.start for g in split.groups]
    win = split.halo([p.view(-1, 8) for p in v.parts], "test")
    # the first shard of group 1 reads the last block of group 0
    s = split.groups[1].start
    assert torch.equal(win[1][0, :8], x[(s - 1) * 8:s * 8])
    assert [w.shape[0] for w in win] == counts
    assert torch.equal(tpar.mesh.gather(v), x)


def test_make_mesh_contiguous_runs():
    """(f) Shards spread over devices in contiguous runs; the first
    shard's device is the controller; a device in two runs is refused;
    without ``devices`` every shard sits on the one device."""
    cards = [torch.device("cuda", i) for i in range(4)]
    assert _spread(8, cards) == [c for c in cards for _ in range(2)]
    assert _spread(6, cards) == [cards[0], cards[0], cards[1], cards[1],
                                 cards[2], cards[3]]
    groups = [f"cpu:{g}" for g in range(4)]
    mesh = tpar.make_mesh(8, devices=groups)
    assert mesh.devices == tpar.make_mesh(devices=LAYOUTS["4 groups"]).devices
    assert [(g.start, g.stop) for g in mesh.groups] == [
        (0, 2), (2, 4), (4, 6), (6, 8)]
    assert mesh.device == torch.device("cpu", 0) and mesh.split
    assert [mesh.group_of(s) for s in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert [(g.start, g.stop) for g in tpar.make_mesh(
        6, devices=groups).groups] == [(0, 2), (2, 4), (4, 5), (5, 6)]
    with pytest.raises(ValueError):
        tpar.make_mesh(devices=["cpu:0", "cpu:1", "cpu:0"])
    assert not tpar.make_mesh(8, device="cpu").split


def _shard_ell_reference(case, A, x):
    """The JAX package's ``shard_ell`` of A on its 8 devices, given x
    plain and through its ``shard_vec``."""
    if case not in _SHARD_ELL:
        jmesh = jpar.make_mesh(8)
        E = jpar.shard_ell(jpf.ELL.from_scipy(A), jmesh)
        xj = jnp.asarray(x)
        _SHARD_ELL[case] = (np.asarray(E.matvec(xj)),
                            np.asarray(E.matvec(jpar.shard_vec(xj, jmesh))))
    return _SHARD_ELL[case]


def _peer(mesh):
    """The bytes that crossed devices, by label."""
    return {k[0]: v[1] for k, v in mesh.log.items() if k[1] == "peer"}


def _shard_ell_both(split, A, x, kind):
    """``shard_ell`` of A (as ``kind``) on the split mesh and on the
    one-device 8-shard mesh, each given x plain and through its
    ``shard_vec``: the products (a ``Rows`` gathered to one tensor), the
    operators and the split mesh's bytes across devices of each."""
    one = tpar.make_mesh(8, device="cpu")
    Es = tpar.shard_ell(CONTAINERS[kind](A), split)
    E1 = tpar.shard_ell(CONTAINERS[kind](A), one)
    xt = torch.as_tensor(x)
    split.reset_log()
    y_plain = Es.matvec(xt)
    peer_plain = _peer(split)
    want_plain = E1.matvec(xt)
    # the all-gather of the columns, as on one device
    assert _exchanges(split) == _exchanges(one) == {
        ("", "all_gather"): [1, Es.n_src * 8 * 7]}
    xs = tpar.shard_vec(xt, split)
    split.reset_log()
    y_rows = Es.matvec(xs)
    peer_rows = _peer(split)
    assert isinstance(xs, Rows) and isinstance(y_rows, Rows)
    for got, want in ((y_plain, want_plain),
                      (gather(y_rows), E1.matvec(tpar.shard_vec(xt, one)))):
        assert isinstance(got, torch.Tensor)
        assert got.shape == (E1.n_pad,) and torch.equal(got, want)
    return y_plain, gather(y_rows), Es, peer_plain, peer_rows


@pytest.mark.parametrize("grid", [16, 15], ids=["matches", "padded"])
def test_sharded_spmv_on_groups(split, grid):
    """The twins of the reference's ``test_sharded_spmv_matches`` (16^2)
    and ``test_sharded_spmv_padded`` (15^2, rows padded to 232) over the
    device groups, for each container ``shard_ell`` takes (ELL, TELL and
    DELL in turn): a plain x gives every one of the ``n_pad`` rows, zeros
    past n, and a ``shard_vec`` x a ``Rows``; both within 1e-12 of the
    JAX package's ``shard_ell`` product and bit for bit the one-device
    mesh's."""
    A = jpf.adv_diff_2d(grid)
    n = A.shape[0]
    # the reference tests' seeds
    x = np.random.default_rng({16: 0, 15: 1}[grid]).standard_normal(n)
    want_plain, want_rows = _shard_ell_reference(grid, A, x)
    for kind in CONTAINERS:
        y_plain, y_rows, _, _, _ = _shard_ell_both(split, A, x, kind)
        for got, want in ((y_plain, want_plain), (y_rows, want_rows)):
            np.testing.assert_allclose(got[:n].numpy(), want[:n], rtol=0,
                                       atol=1e-12, err_msg=kind)
            assert not got[n:].any(), kind
        np.testing.assert_allclose(y_plain[:n].numpy(), A @ x, rtol=0,
                                   atol=1e-12, err_msg=kind)


def test_halo_plain_vector_on_groups(split):
    """A ``HaloELL`` of DIA, banded and stacked TELL blocks in turn over
    the device groups, given a plain tensor: all ``n_pad`` rows, bit for
    bit the one-device mesh's, with its exchanges; a ``Rows`` still gives
    a ``Rows`` of the same values.  Each kind gets meshes of its own, so
    the exchange logs are its alone."""
    A = tpf.adv_diff_2d(30)
    n = A.shape[0]
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(n))
    for kind in ("dia", "banded", "tell"):
        mesh = tpar.make_mesh(devices=split.devices)
        one = tpar.make_mesh(8, device="cpu")
        Hs, H1 = (tpar.HaloELL.from_scipy(A, m, kind=kind)
                  for m in (mesh, one))
        got, want = Hs.matvec(x), H1.matvec(x)
        assert got.shape == (H1.n_pad,) and torch.equal(got, want), kind
        np.testing.assert_allclose(got[:n].numpy(), A @ x.numpy(), rtol=0,
                                   atol=1e-12, err_msg=kind)
        assert not got[n:].any() and _exchanges(mesh) == _exchanges(one)
        rows = Hs @ tpar.shard_vec(x, mesh)
        assert isinstance(rows, Rows) and torch.equal(gather(rows), want)


@pytest.mark.parametrize("shape", [(40, 24), (24, 40), (40, 25), (12, 9)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_rectangular_shard_ell_on_groups(split, shape):
    """``shard_ell`` of a rectangular ELL over the device groups (the
    columns 25 padded to 32 by ``shard_vec``; 12 rows leave the last
    shards, and on 8 groups the last groups, without rows), given x plain
    and sharded: within 1e-12 of the JAX package's ``shard_ell`` and of
    scipy, bit for bit the one-device mesh's, its matrix the padded A.
    The bytes across devices: a plain x goes whole to each other group
    with rows, and each other group's rows of y come back; a ``Rows`` of
    the padded columns is split from the controller by ``shard_vec``,
    then each group receives every other group's part."""
    m, n_cols = shape
    A = sp.csr_matrix(sp.random(m, n_cols, density=0.25, format="csr",
                                random_state=np.random.RandomState(m))
                      + sp.eye(m, n_cols))
    x = np.random.default_rng(n_cols).standard_normal(n_cols)
    want_plain, want_rows = _shard_ell_reference(shape, A, x)
    y_plain, y_rows, Es, peer_plain, peer_rows = _shard_ell_both(
        split, A, x, "ell")
    for got, want in ((y_plain, want_plain), (y_rows, want_rows)):
        np.testing.assert_allclose(got[:m].numpy(), want[:m], rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(got[:m].numpy(), A @ x, rtol=0,
                                   atol=1e-12)
        assert not got[m:].any()
    n_pad, w = Es.n_pad, Es.n_pad // 8
    own = split.groups[0].stop * w            # the controller's rows of y
    busy = sum(g.start < Es.active for g in split.groups)
    assert peer_plain == {"": (busy - 1) * n_cols * 8,
                          "gather": (n_pad - own) * 8}
    n_in = -(-n_cols // 8) * 8
    assert peer_rows == {"": (len(split.groups) - 1) * n_in * 8}
    M = Es.to_scipy()
    assert Es.shape == M.shape == (n_pad, n_cols)
    assert abs(M[:m] - A).max() == 0 and M[m:].nnz == 0
