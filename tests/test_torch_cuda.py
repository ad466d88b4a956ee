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
from torch_cases import (LEVEL0_OPERATORS, dia_odd_rows, masked_level0,
                         masked_level1)

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


@pytest.mark.parametrize("amount", [1, 2, 3])
def test_resetup_card_matches_cpu(amount):
    """A same-pattern re-setup (``setup(A2, "same")``) uploads the new
    values: the card's history equals a CPU twin's made after the
    re-setup, and the DIA kernel runs."""
    dev = _card()
    A = tpf.adv_diff_2d(48)
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 0.01 * np.random.default_rng(4)
                         .standard_normal(A.nnz))
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    pc = tpf.PCAIR(tpf.AIROptions(a_lump=True, a_drop=1e-5,
                                  strong_threshold=0.99, reuse_sparsity=True,
                                  reuse_amount=amount),
                   dtype=torch.float64, device=dev).setup(A)
    first = pc.upload()
    pc.setup(A2, "same")
    assert pc.upload() is not first
    tdia.KERNEL_LAUNCHES = 0
    res = pc.solve(b, side="right", rtol=1e-10, max_it=60)
    assert tdia.KERNEL_LAUNCHES > 0 and res.converged
    ref = pc.on("cpu").solve(b, side="right", rtol=1e-10, max_it=60)
    assert res.iterations == ref.iterations
    h, hr = res.history, ref.history
    assert np.all(np.abs(h - hr) <= 1e-8 * hr + 1e-12 * hr[0])
    x = res.x.cpu().numpy()
    assert np.linalg.norm(A2 @ x - b) <= 1e-8 * np.linalg.norm(b)


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
    (the card's atomic sums round otherwise, and the difference grows
    down the levels: 3e-14 at level 2 to 5.6e-12 at level 7 of the
    12-level constrained hierarchy, on an H100); the install
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


def test_setup_device_card_matches_cpu():
    """``setup_device`` on the card against the same on the CPU, at 48^2
    in f64 with the bench's options: markers equal and every operator
    within 1e-12 of its largest entry (inverses applied to a probe too),
    level by level, up to a decision both sides take on a tie (their
    sums round otherwise; ``air/setup_compare.py::compare_setups``
    checks it is one); no level holds a host matrix; the solve converges
    through the DIA kernel."""
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
