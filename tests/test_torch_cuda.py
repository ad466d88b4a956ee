"""The CUDA kernels on the card (marker ``cuda``; each test skips without a
CUDA device).  This file imports neither jax nor pflare_tpu, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pflare_tpu_torch as tpf
from pflare_tpu_torch.sparse import DIA, BandedSpMV
from pflare_tpu_torch.sparse import banded as tbanded
from pflare_tpu_torch.sparse import dia as tdia
from torch_cases import (LEVEL0_OPERATORS, coarse_ell64, dia_odd_rows,
                         fullspace_R64, masked_level0, masked_level1)

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _dia_cases():
    rng = np.random.default_rng(0)
    out = []
    for n in (8192, 4224):
        offs = [-64, -1, 0, 1, 64]
        out.append(sp.diags([rng.random(n - abs(o)) + 0.1 for o in offs],
                            offs, format="csr"))
    out.append(tpf.adv_diff_2d(64))
    # rectangular, with offsets reaching past both ends of the rows
    out.append(sp.csr_matrix(sp.eye(700, 2100, k=1400)
                             + sp.eye(700, 2100, k=-5)
                             + 2.0 * sp.eye(700, 2100)))
    return out


def _random_band(n, w, seed):
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(n):
        c = np.clip(i + rng.integers(-w, w + 1, size=rng.integers(1, 9)),
                    0, n - 1)
        rows += [i] * len(c)
        cols += c.tolist()
    B = sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                      shape=(n, n))
    B.sum_duplicates()
    return B


def _band_cases():
    """adv 64^2, a random band, the masked level-1 A_ff of the 128^2 main
    path (10,281 rows) and a random band of 1,203 rows: the last two have
    n not a multiple of the kernel's four rows per thread."""
    return [tpf.adv_diff_2d(64), _random_band(1200, 37, 1), masked_level1(),
            _random_band(1203, 150, 4)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-13)])
def test_kernels_match_plain_on_card(dtype, tol):
    """Each kernel against its plain version on the same inputs: the sums
    run in the same order, only FMA contraction differs."""
    dev = _card()
    rng = np.random.default_rng(2)
    for A in _dia_cases():
        D = DIA.from_scipy(A, dtype=dtype).to(dev)
        x = torch.as_tensor(rng.standard_normal(A.shape[1]), dtype=dtype,
                            device=dev)
        ref = tdia.dia_spmv_plain(D.data, D.offsets, x, *D.shape)
        y = D.matvec(x)
        torch.cuda.synchronize()
        assert float((y - ref).norm() / ref.norm()) < tol
    for A in _band_cases():
        M = BandedSpMV.from_scipy(A, dtype=dtype).to(dev)
        x = torch.as_tensor(rng.standard_normal(A.shape[1]), dtype=dtype,
                            device=dev)
        ref = tbanded.banded_spmv_plain(M.data, M.lcols, x, M.n, M.w, M.W)
        y = M.matvec(x)
        torch.cuda.synchronize()
        assert float((y - ref).norm() / ref.norm()) < tol


def _new_dia_cases():
    """n_rows = 3001, 3002, 3003 (1, 2 and 3 mod 4: the scalar
    instantiation) and the masked level-0 operators of the 128^2 main path
    (16,384 rows: the vector instantiation)."""
    return ([dia_odd_rows(n, seed=n) for n in (3001, 3002, 3003)]
            + [masked_level0(name) for name in LEVEL0_OPERATORS])


@pytest.mark.parametrize("view", [False, True],
                         ids=["own_storage", "view_off_16_bytes"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-13)])
def test_dia_kernel_any_rows_and_base_on_card(dtype, tol, view):
    """The DIA kernel takes any n_rows and any base: data in its own
    storage goes to the vector instantiation when n_rows is a multiple of
    the rows a thread owns, and to the scalar one otherwise; data in a view
    that starts one element past a 16-byte boundary always goes to the
    scalar one.  Every call launches the kernel (no ValueError, no plain
    fallback) and agrees with the plain version."""
    dev = _card()
    rng = np.random.default_rng(3)
    for A in _new_dia_cases():
        D = DIA.from_scipy(A, dtype=dtype).to(dev)
        K, n = D.data.shape
        if view:
            buf = torch.zeros(K * n + 1, dtype=dtype, device=dev)
            data = buf[1:].view(K, n)
            data.copy_(D.data)
            assert data.is_contiguous() and data.data_ptr() % 16
            D = DIA(D.offsets, data, D.shape)
        else:
            assert D.data.data_ptr() % 16 == 0
        x = torch.as_tensor(rng.standard_normal(A.shape[1]), dtype=dtype,
                            device=dev)
        launches = tdia.KERNEL_LAUNCHES
        y = D.matvec(x)
        assert tdia.KERNEL_LAUNCHES == launches + 1
        ref = tdia.dia_spmv_plain(D.data, D.offsets, x, *D.shape)
        torch.cuda.synchronize()
        assert float((y - ref).norm() / ref.norm()) < tol


def test_dia_kernel_64bit_indices_on_card():
    """An offset of 2^31 does not fit the kernel's 32-bit indices, so it
    takes the 64-bit instantiation; the offset lies past every column, so
    it adds nothing, and the product is the plain one of the others."""
    dev = _card()
    rng = np.random.default_rng(4)
    n = 5000
    data = torch.as_tensor(rng.standard_normal((3, n)), device=dev)
    x = torch.as_tensor(rng.standard_normal(n), device=dev)
    D = DIA((-1, 0, 2 ** 31), data, (n, n))
    launches = tdia.KERNEL_LAUNCHES
    y = D.matvec(x)
    assert tdia.KERNEL_LAUNCHES == launches + 1
    ref = tdia.dia_spmv_plain(data[:2], (-1, 0), x, n, n)
    torch.cuda.synchronize()
    assert float((y - ref).norm() / ref.norm()) < 1e-13


def test_wrappers_refuse_bad_input_on_card():
    dev = _card()
    D = DIA.from_scipy(tpf.adv_diff_2d(32), dtype=torch.float32).to(dev)
    with pytest.raises(ValueError):
        D.matvec(torch.zeros(32 * 32, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):
        D.matvec(torch.zeros(7, dtype=torch.float32, device=dev))


def test_banded_wrapper_refuses_misaligned_views():
    """The banded kernel reads four rows at a time in 16-byte pieces, so
    its wrapper refuses data or lcols that start off a 16-byte boundary."""
    dev = _card()
    M = BandedSpMV.from_scipy(_random_band(1200, 37, 1),
                              dtype=torch.float32).to(dev)
    x = torch.zeros(M.n_cols, dtype=torch.float32, device=dev)
    K, n_pad = M.data.shape
    for name in ("data", "lcols"):
        t = getattr(M, name)
        buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(K, n_pad)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16
        B = BandedSpMV(view if name == "data" else M.data,
                       view if name == "lcols" else M.lcols,
                       M.n, M.n_cols, M.w, M.W)
        launches = tbanded.KERNEL_LAUNCHES
        with pytest.raises(ValueError, match="aligned"):
            B.matvec(x)
        assert tbanded.KERNEL_LAUNCHES == launches


def test_solve_goes_through_both_kernels():
    """The main path at 64^2 on the card launches both kernels and
    converges like the CPU run."""
    dev = _card()
    A = tpf.adv_diff_2d(64).astype(np.float32)
    opts = tpf.AIROptions(a_lump=True, a_drop=1e-5, strong_threshold=0.99,
                          max_levels=6,
                          coarsest_inverse_type=tpf.InverseType.NEWTON,
                          coarsest_poly_order=24,
                          coarsest_matrix_free_polys=True)
    pc = tpf.PCAIR(opts, dtype=torch.float32, device=dev).setup(A)
    pc.upload()
    tdia.KERNEL_LAUNCHES = tbanded.KERNEL_LAUNCHES = 0
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    x, norms = pc.solve_device(b, max_it=10)
    norms = norms.cpu().numpy()
    assert tdia.KERNEL_LAUNCHES > 0 and tbanded.KERNEL_LAUNCHES > 0
    assert norms[-1] <= 1e-5 * norms[0]
    r = A.astype(np.float64) @ x.double().cpu().numpy() - b
    assert np.linalg.norm(r) <= 1e-4 * np.linalg.norm(b)


@pytest.mark.parametrize("kw", [dict(), dict(inverse_sparsity_order=2),
                                dict(inverse_type="NEWTON", matrix_free=True),
                                dict(inverse_type="SAI"),
                                dict(inverse_type="LU")],
                         ids=["arnoldi", "arnoldi-order-2", "newton-mf", "sai",
                              "lu"])
def test_pcpflareinv_card_matches_cpu(kw):
    """PCPFLAREINV on the card: the GMRES history equals the CPU run's
    (the plain versions) to 1e-8 of the initial residual norm (LU ends
    at rounding level in one iteration), and every iteration launches
    the DIA kernel (the Krylov operator of adv_diff_2d is DIA)."""
    dev = _card()
    A = tpf.adv_diff_2d(64)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    pc = tpf.PCPFLAREINV(**kw, dtype=torch.float64, device=dev).setup(A)
    pc.upload()
    tdia.KERNEL_LAUNCHES = 0
    res = pc.solve(b, max_it=30)
    assert tdia.KERNEL_LAUNCHES >= res.iterations
    ref = tpf.PCPFLAREINV(**kw, dtype=torch.float64, device="cpu").setup(
        A).solve(b, max_it=30)
    assert res.iterations == ref.iterations
    assert np.max(np.abs(res.history - ref.history)) <= 1e-8 * ref.history[0]


@pytest.mark.parametrize("kw", [
    dict(z_type="LAIR", smooth_order="fcf"),
    dict(full_smoothing_up_and_down=True, inverse_type="ARNOLDI"),
    dict(symmetric=True, one_point_classical_prolong=False),
    dict(reorder="rcm", cf_splitting_type="PMIS_AGG")],
    ids=["lair-fcf", "full-smoothing", "symmetric", "rcm-pmis-agg"])
def test_air_options_card_match_cpu(kw):
    """The AIR option paths on the card: right GMRES and the device GMRES
    give the CPU run's histories (one host setup, ``PCAIR.on``) to 1e-8
    of each norm or 1e-12 of the first, x in the caller's order."""
    dev = _card()
    diffusion = kw.get("symmetric") or kw.get("full_smoothing_up_and_down")
    A = tpf.adv_diff_2d(48, alpha=1.0 if diffusion else 0.0)
    if kw.get("reorder"):
        p = np.random.default_rng(8).permutation(A.shape[0])
        A = sp.csr_matrix(A[p][:, p])
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    pc = tpf.PCAIR(tpf.AIROptions().replace(**kw), dtype=torch.float64,
                   device=dev).setup(A)
    cpu = pc.on("cpu")
    res = pc.solve(b, side="right", rtol=1e-10, max_it=60)
    ref = cpu.solve(b, side="right", rtol=1e-10, max_it=60)
    assert res.iterations == ref.iterations and res.converged
    h, hr = res.history, ref.history
    assert np.all(np.abs(h - hr) <= 1e-8 * hr + 1e-12 * hr[0])
    x, norms = pc.solve_device(b, max_it=6, ksp="gmres")
    _, ref_norms = cpu.solve_device(b, max_it=6, ksp="gmres")
    assert torch.allclose(norms.cpu(), ref_norms, rtol=1e-8,
                          atol=1e-12 * float(ref_norms[0]))
    true = np.linalg.norm(A @ x.cpu().numpy() - b) / np.linalg.norm(b)
    assert abs(true - float(norms[-1] / norms[0])) <= 1e-8 + 1e-6 * true


@pytest.mark.parametrize("side", ["left", "right"])
def test_stationary_gmres_card_matches_eager_and_cpu(side):
    """The default GMRES (gmres_stationary) on the card: the history of
    the host-driven GMRES on the card and of the default GMRES on the CPU
    (one host setup, ``PCAIR.on``) to 1e-8 of each norm or 1e-12 of the
    first, with one host read an iteration and a cycle."""
    from pflare_tpu_torch.solvers import jitted

    dev = _card()
    A = tpf.adv_diff_2d(48)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    pc = tpf.PCAIR(dtype=torch.float64, device=dev).setup(A)
    cpu = pc.on("cpu")        # before the upload, which compacts the host
    kw = dict(side=side, rtol=1e-10, max_it=60, restart=4)
    reads = jitted.HOST_READS
    tdia.KERNEL_LAUNCHES = 0
    res = pc.solve(b, **kw)
    reads = jitted.HOST_READS - reads
    assert tdia.KERNEL_LAUNCHES > 0 and res.converged
    assert reads <= res.iterations + 2 * (-(-res.iterations // 4)) + 2
    for ref in (pc.solve(b, eager=True, **kw), cpu.solve(b, **kw)):
        assert res.iterations == ref.iterations
        h, hr = res.history, ref.history
        assert np.all(np.abs(h - hr) <= 1e-8 * hr + 1e-12 * hr[0])


def test_resetup_card_matches_cpu():
    """A same-pattern re-setup (``setup(A2, "same")``) uploads the new
    values, for each ``reuse_amount`` 1-3: the card's history equals a
    CPU twin's made after the re-setup, and the DIA kernel runs."""
    dev = _card()
    A = tpf.adv_diff_2d(48)
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 0.01 * np.random.default_rng(4)
                         .standard_normal(A.nnz))
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    for amount in (1, 2, 3):
        pc = tpf.PCAIR(tpf.AIROptions(a_lump=True, a_drop=1e-5,
                                      strong_threshold=0.99,
                                      reuse_sparsity=True,
                                      reuse_amount=amount),
                       dtype=torch.float64, device=dev).setup(A)
        first = pc.upload()
        pc.setup(A2, "same")
        assert pc.upload() is not first, amount
        tdia.KERNEL_LAUNCHES = 0
        res = pc.solve(b, side="right", rtol=1e-10, max_it=60)
        assert tdia.KERNEL_LAUNCHES > 0 and res.converged, amount
        ref = pc.on("cpu").solve(b, side="right", rtol=1e-10, max_it=60)
        assert res.iterations == ref.iterations, amount
        h, hr = res.history, ref.history
        assert np.all(np.abs(h - hr) <= 1e-8 * hr + 1e-12 * hr[0]), amount
        x = res.x.cpu().numpy()
        assert np.linalg.norm(A2 @ x - b) <= 1e-8 * np.linalg.norm(b), amount


_BENCH = dict(a_lump=True, a_drop=1e-5, strong_threshold=0.99, max_levels=6,
              coarsest_inverse_type="NEWTON", coarsest_poly_order=24,
              coarsest_matrix_free_polys=True)


@pytest.mark.parametrize("kw,syncs", [
    (_BENCH, 0),
    (dict(auto_truncate_start_level=2, auto_truncate_tol=0.5,
          coarsest_poly_order=12), 1),
    (dict(z_type="LAIR", smooth_order="fcf", max_levels=6), None),
    (dict(one_point_classical_prolong=False, constrain_w=True,
          constrain_z=True, coarsest_inverse_type="LU", max_levels=6),
     None)],
    ids=["bench", "auto-truncated", "lair-fcf", "constrained-lu"])
def test_device_resetup_card_matches_cpu(kw, syncs):
    """``install`` on the card: every rebuilt operator equals the same
    plan's on the CPU (a twin's own plan, one host hierarchy) within
    1e-12 of its largest entry in f64, at the bench's depth of 6 levels
    (the segment sums add in the CPU's order on the card, so only the
    card's other reductions can part the two); the install
    synchronises only for the truncation probe's read (the SVDs of lAIR
    and the constraints read a flag each, not counted); the solve
    converges through the DIA kernel."""
    from pflare_tpu_torch.utils.timers import count_syncs

    dev = _card()
    A = tpf.adv_diff_2d(48)
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 0.05 * np.random.default_rng(3)
                         .standard_normal(A.nnz))
    opts = tpf.AIROptions().replace(reuse_sparsity=True, reuse_amount=3,
                                    reuse_poly_coeffs=True, **kw)
    pc = tpf.PCAIR(opts, dtype=torch.float64, device=dev).setup(A)
    cpu = pc.on("cpu")
    plan = pc.build_device_resetup()
    plan.install(pc, A2)                       # first call: warm-up
    _, n_sync = count_syncs(plan.install, pc, A2)
    if syncs is not None:
        assert n_sync == syncs
    cpu_plan = cpu.build_device_resetup()
    cpu_plan.install(cpu, A2)
    got, want = pc.upload().to_scipy(), cpu.upload().to_scipy()
    assert got.keys() == want.keys()
    for name in want:
        diff = abs(got[name] - want[name]).max()
        assert diff <= 1e-12 * max(abs(want[name]).max(), 1e-300), name
    if syncs:
        assert abs(plan.probe_quality - cpu_plan.probe_quality) <= \
            1e-12 * cpu_plan.probe_quality
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    tdia.KERNEL_LAUNCHES = 0
    res = pc.solve(b, side="right", rtol=1e-10, max_it=60)
    assert tdia.KERNEL_LAUNCHES > 0 and res.converged
    assert (np.linalg.norm(A2 @ res.x.cpu().numpy() - b)
            <= 1e-8 * np.linalg.norm(b))


def test_dense_inverse_card_equals_cpu():
    """The device re-setup's Gauss-Jordan coarse inverse computes the
    same bits on the card as on the CPU, with no synchronisation."""
    from pflare_tpu_torch.air.device_resetup import dense_inverse
    from pflare_tpu_torch.utils.timers import count_syncs

    dev = _card()
    rng = np.random.default_rng(7)
    D = torch.as_tensor(rng.standard_normal((300, 300))
                        + 30.0 * np.eye(300))
    got, n_sync = count_syncs(dense_inverse, D.to(dev))
    assert n_sync == 0
    assert torch.equal(got.cpu(), dense_inverse(D))


def test_setup_device_card_matches_cpu():
    """``setup_device`` on the card against the same on the CPU, at 48^2
    in f64 with the bench's options: markers equal and every operator
    within 1e-12 of its largest entry (inverses applied to a probe too),
    level by level, up to a decision both sides take on a tie (their
    sums round otherwise; ``air/setup_compare.py::compare_setups``
    checks it is one); no level holds a host matrix; the solve converges
    through the DIA kernel.  The same on the benchmark's tetrahedra at
    m = 8, with the graphed ``solve_device`` against the eager one."""
    from pflare_tpu_torch.air.device_setup import DeviceSetupHierarchy
    from pflare_tpu_torch.sparse import DELL
    from pflare_tpu_torch.air.setup_compare import (
        LevelMatrices, compare_setups, setup_levels)

    dev = _card()
    A = tpf.adv_diff_2d(48)
    opts = tpf.AIROptions().replace(**_BENCH)
    with LevelMatrices() as seen_card:
        pc = tpf.PCAIR(opts, dtype=torch.float64, device=dev)
        pc.setup_device(A)
    with LevelMatrices() as seen_cpu:
        cpu = tpf.PCAIR(opts, dtype=torch.float64, device="cpu")
        cpu.setup_device(A)
    assert isinstance(pc.hierarchy, DeviceSetupHierarchy)
    dh = pc.upload()
    for lev in dh.levels:
        for key, op in lev.items():
            if isinstance(op, (DIA, DELL)):
                assert op.data.is_cuda, key
    notes, diverged, worst, _ = compare_setups(
        setup_levels(pc.hierarchy), setup_levels(cpu.hierarchy), seen_card,
        seen_cpu, opts, rtol=1e-12, coeff_rtol=None)
    assert worst <= 1e-12
    assert isinstance(dh.top, DIA) and isinstance(dh.levels[0]["A_ff"], DIA)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    tdia.KERNEL_LAUNCHES = 0
    res = pc.solve(b, side="right", rtol=1e-10, max_it=60)
    assert tdia.KERNEL_LAUNCHES > 0 and res.converged
    if not diverged:
        assert res.iterations == cpu.solve(b, side="right", rtol=1e-10,
                                           max_it=60).iterations

    # 3-D DG(1) upwind advection on the benchmark's tetrahedra (m = 8,
    # 14,088 DoF, f64, the default options with reorder "auto"), whose
    # coarse rows hold hundreds of entries: the same comparison, and a
    # graphed solve_device equal to the eager one bit for bit
    from solverbench import harness

    T = harness.generator("dg1_upwind_tet_mesh")(m=8)
    topts = tpf.AIROptions(reorder="auto")
    with LevelMatrices() as seen_card:
        pt = tpf.PCAIR(topts, dtype=torch.float64, device=dev)
        pt.setup_device(T)
    with LevelMatrices() as seen_cpu:
        ct = tpf.PCAIR(topts, dtype=torch.float64, device="cpu")
        ct.setup_device(T)
    notes, diverged, worst, _ = compare_setups(
        setup_levels(pt.hierarchy), setup_levels(ct.hierarchy), seen_card,
        seen_cpu, topts, rtol=1e-12, coeff_rtol=None)
    assert worst <= 1e-12
    assert max(lvl.device["A_ff"].K for lvl in pt.hierarchy.levels) >= 200
    b = np.random.default_rng(2).standard_normal(T.shape[0])
    for _ in range(3):
        x, norms = pt.solve_device(b, max_it=6)
    xe, ne = _eager(pt, lambda: pt.solve_device(b, max_it=6))
    assert torch.equal(x, xe) and torch.equal(norms, ne)
    res = pt.solve(b, ksp="gmres", side="right", rtol=1e-8, max_it=100)
    assert res.converged
    assert (np.linalg.norm(T @ res.x.cpu().numpy() - b)
            <= 1e-7 * np.linalg.norm(b))
    if not diverged:
        assert res.iterations == ct.solve(b, ksp="gmres", side="right",
                                          rtol=1e-8, max_it=100).iterations


def test_dg1_mesh_card_matches_cpu(tmp_path):
    """The unstructured slice on the card: a seeded Delaunay mesh written
    as Gmsh, read back, assembled as DG(1), set up on the host with the
    RCM reorder and solved on the card and by its CPU twin (one host
    setup, ``PCAIR.on`` before the upload): Richardson histories to 1e-8
    of each norm or 1e-12 of the first, the host hierarchy compacted
    after the twin's upload; the FV operator of the same mesh runs its
    top level on the banded kernel."""
    from torch_cases import tri_mesh, write_gmsh

    dev = _card()
    pts, cells = tri_mesh(16, seed=3)
    path = write_gmsh(str(tmp_path / "tri.msh"), pts, [(2, cells)])
    A = tpf.dg1_advection_from_gmsh(path)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    pc = tpf.PCAIR(tpf.AIROptions(reorder="auto"), dtype=torch.float64,
                   device=dev).setup(A)
    cpu = pc.on("cpu")
    res = pc.solve(b, ksp="richardson", rtol=1e-5, max_it=10)
    ref = cpu.solve(b, ksp="richardson", rtol=1e-5, max_it=10)
    assert res.converged and res.iterations == ref.iterations
    h, hr = np.asarray(res.history), np.asarray(ref.history)
    assert np.all(np.abs(h - hr) <= 1e-8 * hr + 1e-12 * hr[0])
    assert pc.hierarchy.compacted
    fv = tpf.PCAIR(tpf.AIROptions(a_lump=True, reorder="auto"),
                   dtype=torch.float64, device=dev).setup(
        tpf.advection_from_gmsh(path))
    assert isinstance(fv.upload().top, BandedSpMV)
    tbanded.KERNEL_LAUNCHES = 0
    x, norms = fv.solve_device(b[:fv.upload().top.n], max_it=6)
    assert tbanded.KERNEL_LAUNCHES >= 6
    assert float(norms[-1]) <= 1e-5 * float(norms[0])


def _plain(blk, x):
    """A shard container's plain version, at its column base."""
    if isinstance(blk, DIA):
        return tdia.dia_spmv_plain(blk.data, blk.offsets, x, *blk.shape,
                                   blk.col_base)
    return tbanded.banded_spmv_plain(blk.data, blk.lcols, x, blk.n, blk.w,
                                     blk.W, blk.col_base)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-13)])
def test_sharded_kernels_match_plain_on_card(dtype, tol):
    """The DIA and banded kernels on the shard blocks of a row-sharded
    operator (4 shards on the card, each block read from its extended
    window at column base w) against their plain versions, and the
    sharded product against the whole operator's kernel."""
    from pflare_tpu_torch.parallel import HaloELL, make_mesh

    dev = _card()
    mesh = make_mesh(4)
    rng = np.random.default_rng(5)
    for kind, A in (("dia", tpf.adv_diff_2d(64)),
                    ("banded", masked_level1()),
                    ("banded", _random_band(4096, 150, 5))):
        E = HaloELL.from_scipy(A, mesh, dtype=dtype, kind=kind)
        x = torch.as_tensor(rng.standard_normal(E.n_pad), dtype=dtype,
                            device=dev)
        ext = mesh.halo(x.view(mesh.size, E.w)[:E.active])
        for s, blk in enumerate(E.blocks):
            assert type(blk).__name__ == {"dia": "DIA",
                                          "banded": "BandedSpMV"}[kind]
            y, ref = blk.matvec(ext[s]), _plain(blk, ext[s])
            torch.cuda.synchronize()
            assert float((y - ref).norm() / ref.norm()) < tol
        whole = (DIA if kind == "dia" else BandedSpMV).from_scipy(
            A, dtype=dtype).to(dev)
        want = whole.matvec(x[:A.shape[0]])
        got = E.matvec(x)
        assert float((got[:A.shape[0]] - want).norm() / want.norm()) < tol
        assert not got[A.shape[0]:].any()


def test_mesh_over_two_cards_matches_one_card():
    """A 4-shard 256^2 f32 solve over two cards (two shards a card)
    against the same 4 shards on one card: norms within 1e-5 of each,
    x back on the first card, each DIA and banded shard block on its
    own card and launched there, the bytes that crossed the cards
    counted; jit=True over two cards raises NotImplementedError."""
    from pflare_tpu_torch.parallel import make_mesh

    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    A = tpf.adv_diff_2d(256)
    opts = tpf.AIROptions(a_lump=True, a_drop=1e-5, strong_threshold=0.99)
    pc = tpf.PCAIR(opts, dtype=torch.float32, device=cards[0], jit=False)
    pc.setup(A.astype(np.float32))
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    one = make_mesh(devices=[cards[0]] * 4)
    two = make_mesh(devices=[cards[0], cards[0], cards[1], cards[1]])
    _, n1 = pc.solve_device(b, max_it=10, mesh=one)
    for mod in (tdia, tbanded):
        mod.LAUNCHES_BY_DEVICE.clear()
    x2, n2 = pc.solve_device(b, max_it=10, mesh=two)
    torch.cuda.synchronize()
    np.testing.assert_allclose(n2.cpu().numpy(), n1.cpu().numpy(),
                               rtol=1e-5)
    assert x2.device == cards[0]
    st = pc._distributed_state(two)
    on_card1 = 0
    for op in [st.top] + [v for lev in st.levels for v in lev.values()]:
        for s, blk in enumerate(getattr(op, "blocks", [])):
            if isinstance(blk, (DIA, BandedSpMV)):
                assert blk.data.device == two.devices[s]
                on_card1 += two.devices[s] == cards[1]
    assert on_card1 and (tdia.LAUNCHES_BY_DEVICE[1]
                         + tbanded.LAUNCHES_BY_DEVICE[1]) > 0
    assert two.traffic()["peer"][1] > 0
    with pytest.raises(NotImplementedError):
        tpf.PCAIR(opts, dtype=torch.float32, device=cards[0]).setup(
            A.astype(np.float32)).solve_device(b, mesh=two)


def test_shard_ell_over_two_cards_matches_one_card():
    """``shard_ell`` of a square and of a rectangular f64 operator (96^2
    and its first n/2 + 5 columns, which pad to 4 shards) as ELL, TELL
    and DELL in turn, on 4 shards over two cards against the same 4
    shards on one card, each given a plain x and a ``shard_vec`` x: y bit
    for bit, within 1e-12 of scipy, the gather kernel launched once a
    product on each card that holds shards."""
    from pflare_tpu_torch.parallel import make_mesh, shard_ell, shard_vec
    from pflare_tpu_torch.parallel.mesh import gather
    from pflare_tpu_torch.sparse import ELL, TELL
    from pflare_tpu_torch.sparse import ell as sell
    from pflare_tpu_torch.sparse.dell import DELL

    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    makers = {"ell": lambda M: ELL.from_scipy(M).to(cards[0]),
              "tell": lambda M: TELL.from_scipy(M).to(cards[0]),
              "dell": lambda M: DELL.from_scipy(M, dtype=torch.float64,
                                                device=cards[0])}
    meshes = {(0,): make_mesh(devices=[cards[0]] * 4),
              (0, 1): make_mesh(devices=[cards[0], cards[0], cards[1],
                                         cards[1]])}
    A = sp.csr_matrix(tpf.adv_diff_2d(96))
    for kind, make in makers.items():
        rng = np.random.default_rng(13)
        for M in (A, sp.csr_matrix(A[:, :A.shape[0] // 2 + 5])):
            x = torch.as_tensor(rng.standard_normal(M.shape[1]),
                                device=cards[0])
            ys = []
            for on, mesh in meshes.items():
                op = shard_ell(make(M), mesh)
                for xin in (x, shard_vec(x, mesh)):
                    sell.LAUNCHES_BY_DEVICE.clear()
                    ys.append(gather(op.matvec(xin)))
                    assert dict(sell.LAUNCHES_BY_DEVICE) == {
                        i: 1 for i in on}, kind
            torch.cuda.synchronize()
            assert all(torch.equal(y, ys[0]) for y in ys[1:]), kind
            got = ys[0].cpu().numpy()
            np.testing.assert_allclose(got[:M.shape[0]],
                                       M @ x.cpu().numpy(), rtol=0,
                                       atol=1e-12, err_msg=kind)
            assert not got[M.shape[0]:].any(), kind


def test_segment_sum_card_equals_cpu():
    """``segment_sum`` on the card equals the CPU's ``index_add_`` into
    zeros bit for bit, on values of many magnitudes in runs of up to
    4,000 terms, and a product plan's values equal the CPU's."""
    from pflare_tpu_torch.sparse.pattern import SparsityPattern
    from pflare_tpu_torch.sparse.spgemm import build_spgemm_plan, segment_sum

    dev = _card()
    rng = np.random.default_rng(7)
    lengths = rng.integers(0, 300, size=5000)
    lengths[::97] = 4000
    total = int(lengths.sum())
    vals = rng.standard_normal(total) * 10.0 ** rng.integers(-8, 8, total)
    out = torch.as_tensor(np.repeat(np.arange(len(lengths)), lengths))
    want = torch.zeros(len(lengths), dtype=torch.float64).index_add_(
        0, out, torch.as_tensor(vals))
    got = segment_sum(torch.as_tensor(vals, device=dev),
                      torch.as_tensor(lengths, device=dev))
    assert torch.equal(got.cpu(), want)
    A = sp.csr_matrix(tpf.adv_diff_2d(64))
    A.data = A.data * (1 + rng.standard_normal(A.nnz))
    C = sp.csr_matrix(A @ A)
    C.sort_indices()
    plan = build_spgemm_plan(*(SparsityPattern(M.indptr, M.indices, M.shape)
                               for M in (A, A, C)))
    a = torch.as_tensor(A.data)
    assert torch.equal(plan.execute(a.to(dev), a.to(dev)).cpu(),
                       plan.execute(a, a))


def test_ell_transpose_and_flat_values_card_equal_cpu():
    """ELL's transpose product (summed in row order) and diagonal, and
    the ELL/TELL ``from_flat``/``flat_values`` round trip, give the
    CPU's bits on the card."""
    from pflare_tpu_torch.sparse import ELL, TELL

    dev = _card()
    rng = np.random.default_rng(11)
    A = sp.csr_matrix(sp.random(3000, 2500, density=0.004, random_state=5))
    A.data = A.data * 10.0 ** rng.integers(-6, 6, A.nnz)
    x = torch.as_tensor(rng.standard_normal(A.shape[0]))
    E = ELL.from_scipy(A)
    Ed = E.to(dev)
    assert torch.equal(Ed.matvec_t(x.to(dev)).cpu(), E.matvec_t(x))
    assert torch.equal(Ed.diagonal().cpu(), E.diagonal())
    flat = torch.as_tensor(A.data, device=dev)
    for cls in (ELL, TELL):
        M = cls.from_flat(E.pattern, flat)
        assert M.data.device == flat.device
        assert torch.equal(M.flat_values(), flat)
        assert torch.equal(M.data.cpu(), cls.from_scipy(A).data)


# ~~~~~~~~~~ the gather kernel and the one-program solve ~~~~~~~~~~

def _gather_cases():
    """Host operators for the gather kernel: random ones with 1, 3, 36 and
    112 slots a row at most, n not a multiple of a slice, more columns
    than rows and fewer, empty rows; the 64^2 main path's full-space R and
    coarse ELL; a band with long rows."""
    rng = np.random.default_rng(12)
    out = [fullspace_R64(), coarse_ell64(), _random_band(4096, 900, 6)]
    for K, n, n_cols in ((1, 5, 5), (3, 1001, 500), (36, 20_003, 30_000),
                         (112, 70_001, 70_001)):
        lens = rng.integers(0, K + 1, n)
        rows = np.repeat(np.arange(n), lens)
        cols = np.concatenate([rng.choice(n_cols, k, replace=False)
                               for k in lens])
        out.append(sp.csr_matrix((rng.standard_normal(rows.size),
                                  (rows, cols)), shape=(n, n_cols)))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tell_kernel_equals_plain_on_card(dtype):
    """The gather kernel over the packed layout sums in the plain
    version's order with the product and sum rounded apart, so it gives
    ``sell_spmv_plain``'s bits: for TELL and ELL containers at the lanes
    each takes and at every lane count, on the stacked TELL and ELL blocks
    of a 4-shard operator, and after ``with_data``; at one lane a row it
    also equals the TELL slot loop.  Each product is one launch."""
    from pflare_tpu_torch.parallel import HaloELL, make_mesh
    from pflare_tpu_torch.sparse import ELL, TELL
    from pflare_tpu_torch.sparse import ell as tell

    dev = _card()
    rng = np.random.default_rng(12)
    for A in _gather_cases():
        x = torch.as_tensor(rng.standard_normal(A.shape[1]), dtype=dtype,
                            device=dev)
        for cls in (TELL, ELL):
            M = cls.from_scipy(A, dtype=dtype).to(dev)
            for P in (M.packed, *(tell.pack(M, L) for L in tell.LANES)):
                launches = tell.KERNEL_LAUNCHES
                y = tell.sell_spmv_cuda(P, x)
                assert tell.KERNEL_LAUNCHES == launches + 1
                assert torch.equal(y, tell.sell_spmv_plain(P, x)), P.lanes
            if cls is TELL and M.packed.lanes == 1:
                assert torch.equal(M.matvec(x),
                                   tell.tell_spmv_plain(M.data, M.cols, x))
            new = M.with_data(M.data * 2)
            assert torch.equal(new.matvec(x), 2 * M.matvec(x))
    A = _random_band(4096, 900, 6)
    mesh = make_mesh(4)
    x = torch.as_tensor(rng.standard_normal(A.shape[1]), dtype=dtype,
                        device=dev)
    for kind, cls in (("tell", TELL), ("ell", ELL)):
        M = cls.from_scipy(A, dtype=dtype).to(dev)
        E = HaloELL.from_scipy(A, mesh, dtype=dtype, kind=kind)
        blk = E.blocks[0]
        assert isinstance(blk, cls) and blk.packed is not None
        xs = torch.as_tensor(rng.standard_normal(blk.shape[1]), dtype=dtype,
                             device=dev)
        assert torch.equal(blk.matvec(xs),
                           tell.sell_spmv_plain(blk.packed, xs))
        want = M.matvec(x)
        got = E.matvec(torch.nn.functional.pad(x, (0, E.n_pad - A.shape[0])))
        torch.cuda.synchronize()
        assert float((got[:A.shape[0]] - want).norm() / want.norm()) < (
            1e-6 if dtype == torch.float32 else 1e-13)


def test_tell_wrapper_refuses_bad_input_on_card():
    from pflare_tpu_torch.sparse import TELL
    from pflare_tpu_torch.sparse import ell as tell

    dev = _card()
    M = TELL.from_scipy(sp.random(8, 4, density=0.5, random_state=1),
                        dtype=torch.float32).to(dev)
    for P, x in ((M.packed, torch.ones(4, dtype=torch.float64, device=dev)),
                 (M.packed, torch.ones(5, device=dev)),
                 (M.packed, torch.ones(8, device=dev)[::2]),
                 (M.packed, torch.ones(4)),
                 (None, torch.ones(4, device=dev))):
        with pytest.raises(ValueError):
            tell.sell_spmv_cuda(P, x)
    cpu = TELL.from_scipy(sp.random(8, 4, density=0.5, random_state=1))
    with pytest.raises(ValueError):
        cpu.matvec(torch.ones(4, dtype=torch.float64, device=dev))


def _counts():
    from pflare_tpu_torch.sparse import ell as tell

    return (tdia.KERNEL_LAUNCHES, tbanded.KERNEL_LAUNCHES,
            tell.KERNEL_LAUNCHES)


def _eager(pc, fn):
    """``fn()`` with ``pc.jit`` off."""
    pc.jit = False
    try:
        return fn()
    finally:
        pc.jit = True


def _main_path_pc(dev, n=64):
    A = tpf.adv_diff_2d(n).astype(np.float32)
    opts = tpf.AIROptions(a_lump=True, a_drop=1e-5, strong_threshold=0.99,
                          max_levels=6,
                          coarsest_inverse_type=tpf.InverseType.NEWTON,
                          coarsest_poly_order=24,
                          coarsest_matrix_free_polys=True)
    return A, tpf.PCAIR(opts, dtype=torch.float32, device=dev).setup(A)


def test_graphs_equal_eager_on_card():
    """``jit=True`` on the card: apply, solve_device (Richardson and GMRES,
    with and without x0, serial and on a 2-shard mesh) replay CUDA graphs
    whose results equal the eager path's bit for bit, with the same launch
    counts and exchange log; solve's GMRES through graphs equals the
    stationary GMRES run eagerly bit for bit, in jit=False's iterations."""
    from pflare_tpu_torch.parallel import make_mesh
    from pflare_tpu_torch.solvers.jitted import gmres_stationary

    dev = _card()
    A, pc = _main_path_pc(dev)
    n = A.shape[0]
    rng = np.random.default_rng(1)
    b, x0 = rng.standard_normal(n), rng.standard_normal(n)
    r = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                        device=dev)
    for _ in range(3):
        y = pc.apply(r)
    assert torch.equal(y, _eager(pc, lambda: pc.apply(r)))
    mesh = make_mesh(2)
    for kw in ({}, {"x0": x0}, {"ksp": "gmres"}, {"mesh": mesh},
               {"mesh": mesh, "x0": x0}):
        for _ in range(2):
            mesh.reset_log()
            before = _counts()
            x, norms = pc.solve_device(b, max_it=6, **kw)
            launches = np.subtract(_counts(), before)
            log = {k: tuple(v) for k, v in mesh.log.items()}
        mesh.reset_log()
        before = _counts()
        xe, ne = _eager(pc, lambda: pc.solve_device(b, max_it=6, **kw))
        assert (launches == np.subtract(_counts(), before)).all()
        assert launches[0] > 0          # the DIA kernel, at least
        assert log == {k: tuple(v) for k, v in mesh.log.items()}
        assert torch.equal(x, xe) and torch.equal(norms, ne)
    res = pc.solve(b, rtol=1e-5, side="right")
    dh = pc.upload()
    bi = torch.as_tensor(b, dtype=torch.float32, device=dev)
    _, its, hist, _ = gmres_stationary(dh.top.matvec, pc._precond(dh), bi,
                                       None, 1e-5, 1e-50, 10000, 30, "right")
    assert res.converged and res.iterations == its
    np.testing.assert_array_equal(res.history, hist[:its + 1])
    assert _eager(pc, lambda: pc.solve(b, rtol=1e-5,
                                       side="right")).iterations == its


def test_install_replays_the_new_operators_on_card():
    """After a device re-setup's ``install`` the graphs of the old
    operators are gone: the next replay equals an eager solve on the new
    ones bit for bit, and differs from the old solve."""
    dev = _card()
    A = tpf.adv_diff_2d(48)
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 0.05 * np.random.default_rng(4)
                         .standard_normal(A.nnz))
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    opts = tpf.AIROptions().replace(reuse_sparsity=True, reuse_amount=3,
                                    reuse_poly_coeffs=True)
    pc = tpf.PCAIR(opts, dtype=torch.float64, device=dev).setup(A)
    for _ in range(2):
        _, old = pc.solve_device(b, max_it=5)
    pc.build_device_resetup().install(pc, A2)
    assert len(pc._programs) == 0
    for _ in range(2):
        x, norms = pc.solve_device(b, max_it=5)
    xe, ne = _eager(pc, lambda: pc.solve_device(b, max_it=5))
    assert torch.equal(x, xe) and torch.equal(norms, ne)
    assert not torch.equal(norms, old)


def test_failed_capture_raises_on_card():
    """A program that reads the host cannot be captured: the capture
    raises (no eager fallback), and the card works after it."""
    from pflare_tpu_torch.utils import graphs

    dev = _card()
    prog = graphs.Programs(dev).get(None, ("sync",),
                                    lambda v: v * float(v.sum()))
    with pytest.raises(RuntimeError, match="CUDA graph capture of"):
        prog(torch.ones(4, device=dev))
    torch.cuda.synchronize()
    assert float((torch.ones(4, device=dev) * 2).sum()) == 8.0


def test_graph_kernel_nodes_equal_counted_on_card(monkeypatch):
    """Read back from each kept graph, the kernel nodes of each of our
    kernels (what every replay launches) equal what a replay adds to the
    launch counters: for apply, solve_device (serial and on a 2-shard
    mesh) and the GMRES programs of solve."""
    from pflare_tpu_torch.parallel import make_mesh
    from pflare_tpu_torch.utils import graphs

    dev = _card()
    monkeypatch.setattr(graphs, "KEEP_GRAPHS", True)
    A, pc = _main_path_pc(dev)
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    mesh = make_mesh(2)
    for _ in range(2):
        pc.apply(b)
        pc.solve_device(b, max_it=4)
        pc.solve_device(b, max_it=4, mesh=mesh)
    pc.solve(b, rtol=1e-5, side="right")
    assert len(pc._programs) == 6
    for key, prog in pc._programs.items():
        assert prog.graph_kernels() == prog.counted(), key[:4]
        assert prog.counted()["dia_spmv_kernel"] > 0, key[:4]


# ~~~~~~~~~~ the device-built hierarchies' DELL on the gather kernel ~~~~~~~~~~

def _device_built(dev, kind, dtype=torch.float32):
    """(matrix, PCAIR set up on the card by ``setup_device``): the bench's
    options on adv_diff_2d(256), FV upwind advection on a 2 x 32^2
    triangle mesh (every operator a DELL), or DG(1) upwind advection on
    it with the default options, reordered as the benchmark's DG cell."""
    from torch_cases import tri_mesh

    if kind == "256^2":
        A = tpf.adv_diff_2d(256)
        opts = tpf.AIROptions().replace(**_BENCH)
    elif kind == "DG1":
        A = tpf.dg1_upwind_advection(*tri_mesh(32, seed=2))
        opts = tpf.AIROptions(reorder="auto")
    else:
        A = tpf.fv_upwind_advection(*tri_mesh(32, seed=2))
        opts = tpf.AIROptions(a_lump=True)
    pc = tpf.PCAIR(opts, dtype=dtype, device=dev)
    pc.setup_device(A)
    return A, pc


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-14)])
def test_dell_kernel_equals_plain_on_card(dtype, tol):
    """Every DELL of a device-built solve form is packed by the setup,
    and each product launches the gather kernel once, equal to
    ``sell_spmv_plain`` over the packed copy bit for bit and within
    ``tol`` of max |y| of the DELL's plain gather and row sum: on the
    256^2 bench form and on an FV mesh's, in f32 and f64 (a copy on the
    same cols shares the index, unless it packs its nonzeros alone)."""
    from pflare_tpu_torch.air.device_setup import solve_form_dells
    from pflare_tpu_torch.sparse import DELL
    from pflare_tpu_torch.sparse import ell as tell
    from pflare_tpu_torch.sparse.dell import dell_spmv_plain

    dev = _card()
    rng = np.random.default_rng(14)
    for kind in ("256^2", "FV"):
        _, pc = _device_built(dev, kind)
        dells = solve_form_dells(pc.upload())
        assert dells and all(M._packed is not None for M in dells), kind
        for M in dells:
            D = DELL(M.data.to(dtype), M.cols, M.n_cols, M.nonzero_slots)
            x = torch.as_tensor(rng.standard_normal(M.n_cols), dtype=dtype,
                                device=dev)
            D.pack()
            launches = tell.KERNEL_LAUNCHES
            y = D.matvec(x)
            assert tell.KERNEL_LAUNCHES == launches + 1
            assert (D.packed.index is M.packed.index) != M.nonzero_slots
            assert torch.equal(y, tell.sell_spmv_plain(D.packed, x)), kind
            ref = dell_spmv_plain(D, x)
            assert float((y - ref).abs().max()) <= tol * float(
                ref.abs().max()), kind
    for kind in ("256^2", "DG1"):
        _fused_cycle_equals_today(dev, kind, dtype)


def _fused_cycle_equals_today(dev, kind, dtype):
    """On a device-built form in ``dtype``: the fused V-cycle (epilogues,
    R and P through their coarse maps) gives the x of the test's own copy
    of today's sequence (the V-cycle with its fused route off and no
    maps: each plain product, then PyTorch's ops) bit for bit, with every
    DELL R and P mapped and one gather launch a product; a graphed
    ``solve_device`` gives the residual norms and x of today's sequence
    run eagerly, bit for bit."""
    from collections import Counter

    from pflare_tpu_torch.air import smooth
    from pflare_tpu_torch.sparse import DELL
    from pflare_tpu_torch.sparse import ell as tell

    A, pc = _device_built(dev, kind, dtype)
    dh = pc.upload()
    n_R = sum(isinstance(lev["R"], DELL) for lev in dh.levels)
    n_P = sum(isinstance(lev["P"], DELL) for lev in dh.levels)
    assert n_R > 0 and n_P > 0, kind
    assert sum(p[0] is not None for p in dh.coarse_maps) == n_R, kind
    assert sum(p[1] is not None for p in dh.coarse_maps) == n_P, kind
    rng = np.random.default_rng(20)
    r = torch.as_tensor(rng.standard_normal(A.shape[0]), dtype=dtype,
                        device=dev)
    order = pc.options.smooth_arg
    kinds, launches = Counter(tell.EPILOGUE_LAUNCHES), tell.KERNEL_LAUNCHES
    y = smooth.vcycle_kaskade(dh.levels, dh.coarse_inv, r, order,
                              dh.coarse_maps)
    fused = tell.EPILOGUE_LAUNCHES - kinds
    gathered = tell.KERNEL_LAUNCHES - launches
    gathers, maps = smooth._gathers, dh.coarse_maps
    smooth._gathers = lambda op, v: False
    dh.coarse_maps = None
    try:
        want = smooth.vcycle_kaskade(dh.levels, dh.coarse_inv, r, order)
        b = rng.standard_normal(A.shape[0])
        xe, ne = _eager(pc, lambda: pc.solve_device(b, max_it=6))
    finally:
        smooth._gathers, dh.coarse_maps = gathers, maps
    torch.cuda.synchronize()
    assert torch.equal(y, want), (kind, dtype)
    assert fused["coarse_out"] == n_R and fused["coarse_in"] == n_P, kind
    assert min(fused[k] for k in ("masked", "residual", "correction")) > 0
    assert sum(fused.values()) <= gathered, kind
    for _ in range(3):
        x, norms = pc.solve_device(b, max_it=6)
    assert torch.equal(norms, ne) and torch.equal(x, xe), (kind, dtype)


def test_device_built_graphs_pack_nothing_on_card(monkeypatch):
    """A ``jit=True`` ``solve_device`` of a device-built FV form captures
    and replays with no DELL packed in the capture; the replay equals the
    eager solve bit for bit; each captured graph's gather-kernel nodes
    equal what a replay adds to ``ell.KERNEL_LAUNCHES``; a pack inside a
    capture raises."""
    from pflare_tpu_torch.sparse import DELL
    from pflare_tpu_torch.sparse import dell as tdell
    from pflare_tpu_torch.sparse import ell as tell
    from pflare_tpu_torch.utils import graphs

    dev = _card()
    monkeypatch.setattr(graphs, "KEEP_GRAPHS", True)
    A, pc = _device_built(dev, "FV")
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    packs = tdell.PACKS
    for _ in range(3):
        x, norms = pc.solve_device(b, max_it=6)
    assert tdell.PACKS == packs
    xe, ne = _eager(pc, lambda: pc.solve_device(b, max_it=6))
    assert torch.equal(x, xe) and torch.equal(norms, ne)
    assert len(pc._programs) == 1
    for _, prog in pc._programs.items():
        counted = prog.counted()
        assert prog.graph_kernels() == counted
        assert counted["sell_spmv_kernel"] > 0
    before = tell.KERNEL_LAUNCHES
    kinds = tell.EPILOGUE_LAUNCHES.copy()
    pc.solve_device(b, max_it=6)
    assert tell.KERNEL_LAUNCHES - before == counted["sell_spmv_kernel"]
    # the fused launches a replay adds: what its capture counted, each
    # one of the graph's gather-kernel nodes
    fused = tell.EPILOGUE_LAUNCHES - kinds
    assert fused == prog._delta[2][0]
    assert 0 < sum(fused.values()) <= counted["sell_spmv_kernel"]
    M = DELL.from_scipy(A, dtype=torch.float32, device=dev)
    ones = torch.ones(A.shape[1], device=dev)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            M.matvec(ones)
    torch.cuda.synchronize()
    assert M._packed is None
    assert torch.equal(M.matvec(ones), tell.sell_spmv_plain(M.packed, ones))


def test_device_built_sharded_solve_on_card():
    """A 4-shard ``solve_device(mesh=)`` of a device-built FV form: the
    stacked DELL blocks are packed where they are built (before any
    capture), the replay equals the eager sharded solve bit for bit with
    the same launches, and both agree with the serial solve to 1e-5 of
    each norm."""
    from pflare_tpu_torch.parallel import make_mesh
    from pflare_tpu_torch.sparse import dell as tdell

    dev = _card()
    A, pc = _device_built(dev, "FV")
    b = np.random.default_rng(4).standard_normal(A.shape[0])
    mesh = make_mesh(4)
    _, serial = pc.solve_device(b, max_it=6)
    pc.solve_device(b, max_it=6, mesh=mesh)
    packs = tdell.PACKS
    before = _counts()
    x, norms = pc.solve_device(b, max_it=6, mesh=mesh)
    launches = np.subtract(_counts(), before)
    assert tdell.PACKS == packs
    before = _counts()
    xe, ne = _eager(pc, lambda: pc.solve_device(b, max_it=6, mesh=mesh))
    assert (launches == np.subtract(_counts(), before)).all()
    assert launches[2] > 0
    assert torch.equal(x, xe) and torch.equal(norms, ne)
    assert torch.allclose(norms, serial, rtol=1e-5, atol=0)
