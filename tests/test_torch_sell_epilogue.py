"""The gather kernel's epilogues and coarse maps, on the CPU.

``csrc/sell_spmv.cu`` can end a product with the V-cycle's vector work
(``u - A x``, ``m u - A x``, ``u + A x``), and R and P can run through
copies of their packed copies mapped to a level's coarse list, so that R
writes, and P reads, the coarse vector (``sparse/ell.py::Fused``,
``air/fullspace.py::coarse_maps``).  Here: the
kernel's arithmetic with each epilogue (``_emulate_sell_kernel`` plus the
epilogue rounded as the kernel rounds it) against the plain product
followed by PyTorch's op, bit for bit; the maps against ``index_select``
and ``_place_coarse``; and the fused V-cycle against today's sequence,
product for product.  The kernel itself runs only on a card
(tests/test_torch_cuda.py).
"""

import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pflare_tpu_torch as tpf
from pflare_tpu_torch.air import smooth
from pflare_tpu_torch.air.device_setup import solve_form_dells
from pflare_tpu_torch.air.fullspace import coarse_maps
from pflare_tpu_torch.sparse import DELL, ELL, TELL
from pflare_tpu_torch.sparse import dell as tdell
from pflare_tpu_torch.sparse import ell as tell
from test_torch_dell_sell import _empty_rows, _long_rows, _one_wide
from test_torch_sparse import _emulate_sell_kernel

torch.set_num_threads(1)


def _epilogue_numpy(kind, acc, u, m):
    """The kernel's epilogue on the row sums, each operation rounded in
    the value type (numpy contracts nothing into an FMA)."""
    if kind == "residual":
        return u - acc
    if kind == "masked":
        return m * u - acc
    return u + acc


def _torch_op(kind, y, u, m):
    """Today's sequence: PyTorch's elementwise op after the product."""
    if kind == "residual":
        return u - y
    if kind == "masked":
        return m * u - y
    return u + y


def _square(A):
    """A square operator from a rectangular case: its first min(n, m)
    columns, padded with empty ones."""
    n = A.shape[0]
    A = sp.csr_matrix(A)[:, :min(n, A.shape[1])]
    return sp.csr_matrix((A.data, A.indices, A.indptr), shape=(n, n))


def _masked(A, rng):
    """A_ff-like: A's slots kept, values zeroed outside a random F set
    (a ``nonzero_slots`` DELL packs the nonzeros alone)."""
    M = DELL.from_scipy(A, dtype=torch.float64, device="cpu")
    f = torch.as_tensor(rng.random(A.shape[0]) < 0.6)
    colf = f[M.cols.clamp(max=A.shape[0] - 1).long()] & (M.cols < tdell.PADCOL)
    return DELL(M.data * f[:, None] * colf, M.cols, A.shape[0],
                nonzero_slots=True)


def _level(R, P, coarse):
    """A full-space level dict with the keys ``coarse_maps`` reads."""
    return {"R": R, "P": P, "coarse": coarse,
            "mask_f": torch.zeros(R.shape[0], dtype=torch.float64)}


def _transfer_pair(n, rng):
    """Full-space R and P of a level of n rows: R with rows only at a
    shuffled coarse list, P with columns only there; and the list."""
    coarse = rng.permutation(np.flatnonzero(rng.random(n) < 0.4))
    R = sp.random(len(coarse), n, density=0.02, random_state=rng,
                  format="csr")
    R = sp.csr_matrix((R.data, R.indices, R.indptr), shape=(len(coarse), n))
    R_ext = sp.csr_matrix((R.data, (coarse[R.tocoo().row], R.tocoo().col)),
                          shape=(n, n))
    P = sp.random(n, len(coarse), density=0.01, random_state=rng,
                  format="coo")
    P_ext = sp.csr_matrix((P.data, (P.row, coarse[P.col])), shape=(n, n))
    return R_ext, P_ext, torch.as_tensor(coarse)


def _cpu_gathers(op, v):
    """``smooth._gathers`` without its CUDA condition: the fused route on
    the CPU, over the packed copies in the kernel's order."""
    return (isinstance(v, torch.Tensor)
            and isinstance(op, (TELL, ELL, DELL)) and op.packed is not None)


def test_gather_epilogues_and_coarse_maps(monkeypatch):
    """(1) Each epilogue over the packed layout, at every lane count, in
    f32 and f64, on operators with empty rows, one-slot rows, long rows
    and a masked (``nonzero_slots``) operator: the emulated kernel, the
    plain version with the epilogue and the ``Fused`` product all equal
    the plain product followed by PyTorch's op, bit for bit.  (2) The
    coarse maps: R's map gives the plain product's coarse rows in the
    list's order and P's the product of ``_place_coarse``'s vector, bit
    for bit, through ``Fused`` as through the plain version, and leave
    the operators' own packed copies and products as they were; an R
    with a nonempty F row still maps (the gather drops that row too), a
    P with a non-coarse column keeps no map, and a copy over another
    index is refused.  (3) On 64^2 ``setup_device`` forms (default and
    bench options, f64) every level's DELL R and P map, and equal
    ``index_select`` and ``_place_coarse`` around the plain product; the
    fused V-cycle (its route taken on the CPU) gives today's sequence's
    y bit for bit with the same products of each operator through a
    one-argument ``matvec`` wrapper, and gathers and scatters around no
    mapped R or P."""
    rng = np.random.default_rng(20)
    cases = [_square(_empty_rows()), _square(_one_wide()),
             _square(_long_rows())]
    for dtype in (torch.float32, torch.float64):
        ops = [DELL.from_scipy(A, dtype=dtype, device="cpu") for A in cases]
        M = _masked(cases[0], rng)
        ops.append(DELL(M.data.to(dtype), M.cols, M.n_cols, True))
        for D in ops:
            n = D.shape[0]
            x, u, m = (torch.as_tensor(rng.standard_normal(n), dtype=dtype)
                       for _ in range(3))
            m = (m > 0).to(dtype)
            for L in tell.LANES:
                P = tdell.DELL(D.data, D.cols, D.n_cols,
                               D.nonzero_slots).pack(L)
                y = tell.sell_spmv_plain(P, x)
                acc = _emulate_sell_kernel(P, x)
                np.testing.assert_array_equal(acc, y.numpy())
                for kind in ("residual", "masked", "correction"):
                    want = _torch_op(kind, y, u, m)
                    np.testing.assert_array_equal(
                        _epilogue_numpy(kind, acc, u.numpy(), m.numpy()),
                        want.numpy())
                    assert torch.equal(
                        tell.sell_spmv_plain(P, x, kind, u, m), want)
                    assert torch.equal(tell.fused_product(
                        P, tell.Fused(kind, x, u=u, m=m)), want)

    # (2) the maps on a random level, DELL and TELL, every lane count
    n = 1500
    R_ext, P_ext, coarse = _transfer_pair(n, rng)
    b = torch.as_tensor(rng.standard_normal(n))
    xc = torch.as_tensor(rng.standard_normal(coarse.shape[0]))
    for L in tell.LANES:
        for make in ("dell", "tell"):
            if make == "dell":
                R = DELL.from_scipy(R_ext, device="cpu")
                P = DELL.from_scipy(P_ext, device="cpu")
                R.pack(L), P.pack(L)
            else:
                R, P = TELL.from_scipy(R_ext), TELL.from_scipy(P_ext)
                R.packed, P.packed = tell.pack(R, L), tell.pack(P, L)
            plain_R, plain_P = R.packed, P.packed
            want_r = tell.sell_spmv_plain(plain_R, b).index_select(0, coarse)
            want_p = tell.sell_spmv_plain(
                plain_P, smooth._place_coarse(xc, coarse, n))
            [(R_map, P_map)] = coarse_maps([_level(R, P, coarse)])
            assert R_map.index is plain_R.index and R_map.data is plain_R.data
            assert P_map.index is plain_P.index and P_map.data is plain_P.data
            assert R.packed is plain_R and P.packed is plain_P
            assert torch.equal(tell.sell_spmv_plain(R_map, b), want_r)
            np.testing.assert_array_equal(_emulate_sell_kernel(R_map, b),
                                          want_r.numpy())
            assert torch.equal(R.matvec(tell.Fused("coarse_out", b,
                                                   packed=R_map)), want_r)
            assert torch.equal(tell.sell_spmv_plain(P_map, xc), want_p)
            np.testing.assert_array_equal(_emulate_sell_kernel(P_map, xc),
                                          want_p.numpy())
            assert torch.equal(P.matvec(tell.Fused("coarse_in", xc,
                                                   packed=P_map)), want_p)
    f_row = int(np.setdiff1d(np.arange(n), coarse.numpy())[0])
    bad_R = R_ext.tolil()
    bad_R[f_row, 0] = 1.0
    bad_P = P_ext.tolil()
    bad_P[0, f_row] = 1.0
    R = DELL.from_scipy(bad_R.tocsr(), device="cpu")
    P = DELL.from_scipy(bad_P.tocsr(), device="cpu")
    R.pack(), P.pack()
    [(R_map, P_map)] = coarse_maps([_level(R, P, coarse)])
    assert P_map is None
    assert torch.equal(
        tell.fused_product(R.packed, tell.Fused("coarse_out", b,
                                                packed=R_map)),
        tell.sell_spmv_plain(R.packed, b).index_select(0, coarse))
    other = DELL.from_scipy(bad_R.tocsr(), device="cpu")
    other.pack()
    with pytest.raises(ValueError, match="renumbered copy"):
        other.matvec(tell.Fused("coarse_out", b, packed=R_map))
    with pytest.raises(ValueError, match="needs"):
        tell.Fused("coarse_in", xc)

    # (3) device-built forms: the maps, then the fused V-cycle
    setups = {
        "default": dict(max_levels=5),
        "bench": dict(a_lump=True, a_drop=1e-5, strong_threshold=0.99,
                      max_levels=6, coarsest_inverse_type="NEWTON",
                      coarsest_poly_order=24,
                      coarsest_matrix_free_polys=True),
    }
    for name, opts in setups.items():
        pc = tpf.PCAIR(tpf.AIROptions().replace(**opts),
                       dtype=torch.float64, device="cpu")
        pc.setup_device(tpf.adv_diff_2d(64))
        dh = pc.upload()
        tdell.pack_dells(solve_form_dells(dh))
        maps = coarse_maps(dh.levels)
        n_dell = {k: sum(isinstance(lev[k], DELL) for lev in dh.levels)
                  for k in ("R", "P")}
        counts = {k: sum(pair[i] is not None for pair in maps)
                  for i, k in enumerate(("R", "P"))}
        assert counts == n_dell and n_dell["R"] > 0, name
        for lev, (R_map, P_map) in zip(dh.levels, maps):
            R, P, coarse = lev["R"], lev["P"], lev["coarse"]
            n = lev["mask_f"].shape[0]
            v = torch.as_tensor(rng.standard_normal(n))
            if R_map is not None:
                assert torch.equal(
                    tell.sell_spmv_plain(R_map, v),
                    tell.sell_spmv_plain(R.packed, v)
                    .index_select(0, coarse)), name
            if P_map is not None:
                vc = v[:coarse.shape[0]]
                assert torch.equal(
                    tell.sell_spmv_plain(P_map, vc),
                    tell.sell_spmv_plain(P.packed,
                                         smooth._place_coarse(vc, coarse,
                                                              n))), name
        # each product of each operator counted by a one-argument wrapper
        # (as the benchmark counts them); the plain products run over the
        # packed copies in the kernel's order, as on the card
        ops = {}
        for lev in dh.levels:
            for key, val in lev.items():
                op = val.mat if key.startswith("inv_") else val
                if isinstance(op, DELL):
                    ops[id(op)] = op
        calls = {}

        def wrap(op):
            inner = op.matvec

            def matvec(x):
                calls[id(op)] = calls.get(id(op), 0) + 1
                if isinstance(x, tell.Fused):
                    return inner(x)
                return tell.sell_spmv_plain(op.packed, x)
            op.matvec = matvec

        for op in ops.values():
            wrap(op)
        # the V-cycle's own gathers (R's output) and scatters
        # (``_place_coarse``), apart from those inside the products
        index_ops = []
        vcycle_code = smooth.vcycle_kaskade.__code__
        orig_select = torch.Tensor.index_select

        def select(self, *a, **k):
            if sys._getframe(1).f_code is vcycle_code:
                index_ops.append("index_select")
            return orig_select(self, *a, **k)

        orig_place = smooth._place_coarse

        def place(*a, **k):
            index_ops.append("_place_coarse")
            return orig_place(*a, **k)

        monkeypatch.setattr(torch.Tensor, "index_select", select)
        monkeypatch.setattr(smooth, "_place_coarse", place)
        r = torch.as_tensor(rng.standard_normal(dh.top.shape[0]))
        order = pc.options.smooth_arg
        want = smooth.vcycle_kaskade(dh.levels, dh.coarse_inv, r, order)
        today, today_index = dict(calls), len(index_ops)
        calls.clear()
        del index_ops[:]
        with monkeypatch.context() as mp:
            mp.setattr(smooth, "_gathers", _cpu_gathers)
            got = smooth.vcycle_kaskade(dh.levels, dh.coarse_inv, r, order,
                                        maps)
        assert torch.equal(got, want), name
        assert calls == today and sum(today.values()) > 0, name
        # today's cycle gathers R's output and scatters P's input at each
        # level; the fused one only where R or P is no DELL (a DIA)
        assert today_index == 2 * len(dh.levels), name
        assert len(index_ops) == today_index - sum(n_dell.values()), name
        monkeypatch.undo()
        for op in ops.values():
            del op.matvec


def test_slot_and_chunk_counters(monkeypatch):
    """The set-up's and the gather kernel's counters.  (1) On the device
    set-up of the benchmark's tetrahedra at m = 3 (f64), each launch adds
    its packed slots under its lanes to ``ell.SLOTS_BY_LANES`` (the
    kernel's launch site stood in for by ``count_launch`` before the plain
    product, as ``sell_spmv_cuda`` counts after its launch): a fused
    V-cycle adds the slots of its products' packed copies, some of them
    read with two or more lanes a row (the coarse rows are wide); a
    program of it (``graphs.Program``, the capture stood in for) adds as
    much at its warm-up and at each replay, none at its capture.  (2)
    ``dell.SETUP_CHUNKS`` counts a product's passes over row chunks,
    one where it fits its limit, ceil(rows / chunk) where the padded
    product (a lumped SpGEMM, a restriction plan) does not, fewer where
    a product over live candidates alone does not; only a product of
    several passes opens a ``dell.chunks`` span, tagged with the
    product.  (3) The recurrences on a restriction plan (``poly_dell``,
    ``newton_poly_dell``, the device set-up's Z improvement) past
    ``_RESTRICT_PLAN_LIMIT`` run over the plan's row chunks and give the
    whole plan's values bit for bit."""
    from collections import Counter

    from pflare_tpu_torch.utils import graphs, timers
    from solverbench import harness
    from test_torch_graphs import RecordingGraph

    A = harness.generator("dg1_upwind_tet_mesh")(m=3)
    pc = tpf.PCAIR(tpf.AIROptions(reorder="auto"), dtype=torch.float64,
                   device="cpu")
    pc.setup_device(A)
    dh = pc.upload()
    tdell.pack_dells(solve_form_dells(dh))
    maps = coarse_maps(dh.levels)
    products = []
    plain_matvec = DELL.matvec

    def matvec(self, x):
        fused = isinstance(x, tell.Fused)
        packed = x.packed if fused and x.kind in tell.MAPS else self.packed
        products.append((packed.lanes, packed.data.shape[0]))
        tell.count_launch(packed, x.kind if fused else None)
        return (plain_matvec(self, x) if fused
                else tell.sell_spmv_plain(self.packed, x))

    monkeypatch.setattr(DELL, "matvec", matvec)
    monkeypatch.setattr(smooth, "_gathers", _cpu_gathers)
    r = torch.as_tensor(np.random.default_rng(3).standard_normal(
        A.shape[0]))
    order = pc.options.smooth_arg

    def cycle(v):
        return smooth.vcycle_kaskade(dh.levels, dh.coarse_inv, v, order,
                                     maps)

    before = tell.SLOTS_BY_LANES.copy()
    want = cycle(r)
    one = tell.SLOTS_BY_LANES - before
    expected = Counter()
    for lanes, slots in products:
        expected[lanes] += slots
    assert one == expected and len(products) > 3 * len(dh.levels)
    assert sum(v for k, v in one.items() if k >= 2) > 0
    assert set(one) <= set(tell.LANES)
    monkeypatch.setattr(graphs, "enabled", lambda device: True)
    monkeypatch.setattr(graphs, "GRAPH", RecordingGraph)
    RecordingGraph.captures = RecordingGraph.replays = 0
    prog = graphs.Program(cycle, None, "cpu")
    before = tell.SLOTS_BY_LANES.copy()
    for _ in range(4):          # warm-up and capture, three replays
        assert torch.equal(prog(r), want)
    assert RecordingGraph.replays == 3
    assert tell.SLOTS_BY_LANES - before == Counter(
        {k: 4 * v for k, v in one.items()})

    # (2) the passes over row chunks
    M = DELL.from_scipy(A, device="cpu")
    n = M.shape[0]
    whole_c = tdell.SETUP_CHUNKS.copy()
    with timers.collect() as spans:
        whole = tdell.spgemm_drop_dell(M, M, 0.0, True, False)
        lumped = tdell.spgemm_drop_dell(M, M, 0.1, True, True)
        plan = tdell.restrict_plan(M.cols, M)
    assert tdell.SETUP_CHUNKS - whole_c == Counter(spgemm=2, restrict=1)
    assert not [s for s in spans if s[0] == "dell.chunks"]
    monkeypatch.setattr(tdell, "_SPGEMM_CHUNK_LIMIT", M.K * M.K * 100)
    monkeypatch.setattr(tdell, "_RESTRICT_CHUNK_LIMIT", M.K * M.K * 60)
    cut_c = tdell.SETUP_CHUNKS.copy()
    with timers.collect() as spans:
        cut_lumped = tdell.spgemm_drop_dell(M, M, 0.1, True, True)
        cut_plan = tdell.restrict_plan(M.cols, M)
        live_c = tdell.SETUP_CHUNKS.copy()
        cut = tdell.spgemm_drop_dell(M, M, 0.0, True, False)
    assert live_c - cut_c == Counter(spgemm=-(-n // 100),
                                     restrict=-(-n // 60))
    live = (tdell.SETUP_CHUNKS - live_c)["spgemm"]
    assert 1 < live < -(-n // 100)
    assert [s[1] for s in spans if s[0] == "dell.chunks"] == [
        "spgemm", "restrict", "spgemm"]
    assert (cut.to_scipy() != whole.to_scipy()).nnz == 0
    assert (cut_lumped.to_scipy() != lumped.to_scipy()).nnz == 0
    assert torch.equal(cut_plan, plan)

    # (3) each recurrence on a restriction plan (the polynomial's powers,
    # the Newton basis, Z's Richardson steps) runs over the plan's row
    # chunks past ``_RESTRICT_PLAN_LIMIT``, each row as on the whole plan
    from pflare_tpu_torch.air.device_setup import _improve_z_device

    inv_diag = 1.0 / torch.as_tensor(A.diagonal())
    coeffs = torch.tensor([0.5, -0.25, 0.125, -0.0625], dtype=torch.float64)
    wr, wi = np.array([2.0, 1.0, 1.0, 3.0]), np.array([0.0, 0.5, -0.5, 0.0])

    def recurrences():
        return (tdell.poly_dell(M, coeffs).data,
                tdell.newton_poly_dell(M, wr, wi, 1e-14).data,
                _improve_z_device(M, M, M, inv_diag, 2).data)

    on_whole = recurrences()
    monkeypatch.setattr(tdell, "_RESTRICT_PLAN_LIMIT", M.K * M.K * 60)
    before = tdell.SETUP_CHUNKS.copy()
    on_chunks = recurrences()
    assert tdell.SETUP_CHUNKS - before == Counter(restrict=3 * -(-n // 60))
    for got, want in zip(on_chunks, on_whole):
        assert torch.equal(got, want)
