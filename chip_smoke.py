#!/usr/bin/env python3
"""Drive the pflare_tpu_torch main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises, exits non-zero and prints no ``ok`` line):

1. identify the card (nvidia-smi name and power limit, torch and CUDA
   versions); TF32 off;
2. build the CUDA kernels (csrc/*.cu, nvcc) and the host C++ kernels;
3. main path at 512^2, f32: ``PCAIR.setup`` on the host, upload;
4. each kernel against its plain PyTorch version on the card, at the
   main path's shapes (the 512^2 hierarchy's own DIA and banded
   operators) and on the test cases, in f32 and f64; the per-launch
   floor (graph replay of a one-element add); then kernel, plain
   version and the one PyTorch call of the same product (a cuSPARSE CSR
   ``A @ x``, the yardstick ``library_ms``) timed at the 512^2 shapes:
   the top A, the DIA operators of level 0 and the banded ones (see
   ``measure``);
5. ``solve_device(b, max_it=10, ksp="richardson")`` with every kernel
   launch counter at 0 before it: convergence to rtol 1e-5, the true
   residual against scipy, and both kernels launched;
6. the f64 parity configuration at 512^2: full depth, right GMRES from
   x0 = 1 with a zero RHS, rtol 1e-10, <= 6 iterations, by the default
   (stationary) GMRES and by the host-driven one (``eager=True``), twice
   each in the order stationary, eager, eager, stationary: equal
   iterations, histories equal to 1e-8 of each norm (or 1e-12 of the
   first), each solve's seconds and host reads (counted by the solvers);
7. the main path at 2048^2, with 10 levels so that its coarsest grid
   stays near the 512^2 path's size, with the launch counters at 0
   before it and both kernels launched; right GMRES to rtol 1e-5 by
   both GMRES paths as in phase 6, with the counters at 0 before each:
   equal iterations, the true residual by scipy <= 1e-4, both kernels
   launched; then, after every timed solve, one more 512^2 and one more
   2048^2 solve under torch.profiler for each kernel's device time per
   call in the solve;
8. each kernel against its plain version (f32 and f64) on every DIA and
   banded operator of the 2048^2 hierarchy, and the timings of phase 4
   at the 2048^2 shapes;
9. PCPFLAREINV, the one-level approximate inverses: (a) at 512^2, f64,
   GMRES(30) with max_it=60 for every inverse type (POWER, ARNOLDI,
   NEWTON and NEUMANN assembled and matrix-free, NEWTON_NO_EXTRA
   matrix-free, ARNOLDI with sparsity order 2, JACOBI, WJACOBI, SAI,
   ISAI) on the card and on the CPU (the plain versions): residual
   histories equal to 1e-8 at every iteration; (b) at 2048^2, f32, the
   default (ARNOLDI order 6, assembled) and NEWTON order 6 matrix-free,
   right GMRES to rtol 1e-5 or 300 iterations, with the launch counters
   at 0 before each solve: at least 2 (assembled) and 1 (matrix-free)
   DIA launches an iteration, the true residual by scipy within 10% of
   the reported one; the DIA kernel against its plain version on the
   2048^2 assembled inverses and the sparsity-order-2 inverse (K = 6),
   which ``measure`` also times at 2048^2; (c) LU as a one-level PC on
   adv_diff_2d(64): GMRES converges in at most 2 iterations;
10. the AIR options: (a) at 512^2, f64, right GMRES(30) to rtol 1e-10
    with max_it=60 (or the set's own ksp), every option set of
    ``PHASE10_SETS`` (lAIR and SAI-lAIR with and without strong-R
    dropping, the ideal W, improvement and constraints, symmetric PtAP,
    full smoothing, C-point smoothing and per-level orders, anisotropic
    diffusion with ffc, auto-truncation, every CF splitting, the RCM
    reorder of a scrambled matrix, FGMRES, Richardson, right GMRES with
    ``solve_device``, adv_diff_3d(64)), each set up once on the host
    (sets with the same options share it) and solved on the card and on
    the CPU (the plain versions, in a worker thread): residual histories
    equal to 1e-8 of each norm (or 1e-12 of the initial norm) at every
    iteration, the DIA kernel launched in every run but the RCM one and
    the banded kernel in that one; ``compute_diag_dom_submatrix`` on the
    512^2 matrix; the DIA kernel against its plain version on the
    adv_diff_3d(64) top A, which ``measure`` also times; (b) at 2048^2,
    f32, 10 levels, the phase-7 options with lAIR, strong-R dropping and
    fcf smoothing: solve_device with max_it=10, Richardson and right
    GMRES, each with the launch counters at 0 before it, more DIA
    launches a Richardson iteration than phase 7, the true residual by
    scipy within 10% of the reported one, then one more Richardson solve
    under torch.profiler;
11. same-pattern re-setup: (a) at 512^2, f64, the bench's options and
    depth with ``reuse_sparsity``: every ``reuse_amount`` with and
    without ``reuse_poly_coeffs`` (``PHASE11_SETS``), the generic reuse
    path (plans popped) against the plan re-setup (operators within
    1e-11), ``set_poly_coefficients`` (a fresh setup reproduces the
    history to 1e-12) and ``freeze``; each set up on A512, re-set up on
    its seeded perturbation (``setup(A2, "same")``) and solved by right
    GMRES to rtol 1e-10 on the card and on a CPU twin made after the
    re-setup (phase 10's rule, the DIA kernel launched); (b) at 2048^2,
    the phase-7 options with ``reuse_amount=3`` (so that phase 12 (b)
    shares the first setup), set up from the f64 matrix for an f32 solve
    (the plan re-setup computes in f64, as the reference's does), re-set
    up by its plans: first setup, re-setup, their ratio and the
    ``resetup_*`` split, the upload, and ``solve_device`` with 10
    Richardson iterations and the counters at 0: rtol 1e-5, the true
    residual <= 1e-4, both kernels launched;
12. the device re-setup (``build_device_resetup``, ``install``): (a) at
    512^2, f64, the bench's options and depth with ``reuse_amount=3``
    and ``reuse_poly_coeffs``: first setup, plan build, first and warm
    install against ``setup(A2, "same")`` + ``upload`` of a second
    PCAIR, each to completion; every rebuilt operator (``top`` and the
    coarse inverse too) within 1e-10 of the host's largest entry; the
    synchronisations of one install (``count_syncs``: none); right GMRES
    to rtol 1e-10 with the host re-setup's iterations, and a CPU twin
    (its own plan, the same install) within phase 10's rule; three
    installs on drifting seeded matrices, each converging with its true
    residual by scipy; the plan alone card against CPU (1e-12) on
    ``PHASE12_SETS`` at 128^2; (b) at 2048^2, f32, phase 11 (b)'s
    PCAIR: plan build, first and warm install of phase 11's matrix
    against its host re-setup + upload, the plan's device bytes and the
    peak device memory, ``solve_device`` with 10 Richardson iterations
    (rtol 1e-5, true residual <= 1e-4, both kernels launched), one
    install under torch.profiler.

Kernel times are device times: ``R`` calls captured in one CUDA graph,
replayed and timed by CUDA events (``graph_ms``).  The eager
back-to-back time is printed beside them as the host's launch rate.
The last two lines of standard output are the kernels' JSON line and the
``{"ok": true, "device": ...}`` line.  Without a CUDA device, or without
the package beside it, the script fails.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

DIA_SITES = {"aligned": "pflare_tpu/sparse/dia.py:311",
             "padded": "pflare_tpu/sparse/dia.py:367"}
BANDED_SITE = "pflare_tpu/sparse/banded.py:238"
TOL = {"float32": 1e-6, "float64": 1e-13}
HISTORY_RTOL = 1e-8  # phase 9 (a): card against CPU residual histories
R = 50               # calls captured in one CUDA graph
REPLAYS = 4          # timed replays of that graph
L2_BYTES = 50e6      # the H100's L2 cache
HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
FP32_FLOPS = 67e12   # H100 SXM float32 outside the tensor cores


def host_gib() -> str:
    """The process's resident host memory, from /proc/self/status."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return (f"host memory {int(line.split()[1]) / 2**20:.2f} "
                        "GiB resident")
    return "host memory not read"


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def bench_options(pkg, max_levels=6):
    """The main path's options (bench.py:430-436)."""
    return pkg.AIROptions(
        a_lump=True, a_drop=1e-5, strong_threshold=0.99,
        max_levels=max_levels,
        coarsest_inverse_type=pkg.InverseType.NEWTON,
        coarsest_poly_order=24, coarsest_matrix_free_polys=True)


def eager_ms(torch, fn, reps=50, warmup=5):
    """Mean time of ``fn`` over ``reps`` eager back-to-back calls by CUDA
    events: for a short kernel this is the host's launch rate, not the
    kernel's time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fns):
    """Device time of one call: ``R`` calls, taking ``fns`` in turn,
    captured in one CUDA graph and replayed ``REPLAYS`` times between two
    CUDA events, after a warm-up outside the capture and one replay whose
    last output must equal an eager call's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(R):
            out = fns[i % len(fns)]()
    graph.replay()
    ref = fns[(R - 1) % len(fns)]()
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    require(err <= 1e-6 * float(ref.abs().max()),
            f"graph replay differs from an eager call by {err:.3e}")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (R * REPLAYS)


def gmres_paths(pcx, b, **kw):
    """Two ``pcx.solve`` by each GMRES path, the stationary default and
    the host-driven ``eager=True``, in the order stationary, eager, eager,
    stationary (the first solve pays first-call costs), with the kernel
    launch counters at 0 before each: {path: (result, "s1 / s2" seconds
    to completion, the solver's host reads, {"dia", "banded"} launches),
    the last three of the path's second solve}."""
    from pflare_tpu_torch.solvers import jitted, krylov
    from pflare_tpu_torch.sparse import banded as tbanded
    from pflare_tpu_torch.sparse import dia as tdia
    from pflare_tpu_torch.utils.timers import device_sync_read

    out, seconds = {}, {}
    stationary, eager = ("stationary", False, jitted), ("eager", True, krylov)
    for path, is_eager, solver in (stationary, eager, eager, stationary):
        tdia.KERNEL_LAUNCHES = 0
        tbanded.KERNEL_LAUNCHES = 0
        reads = solver.HOST_READS
        t0 = time.perf_counter()
        res = pcx.solve(b, eager=is_eager, **kw)
        device_sync_read(res.x)
        seconds.setdefault(path, []).append(time.perf_counter() - t0)
        out[path] = (res, " / ".join(f"{t:.4f}" for t in seconds[path]),
                     solver.HOST_READS - reads,
                     {"dia": tdia.KERNEL_LAUNCHES,
                      "banded": tbanded.KERNEL_LAUNCHES})
    return out


def band_matrix(np, sp, n, w, seed):
    """The random band of tests/test_banded.py:18-30."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n):
        c = np.clip(i + rng.integers(-w, w + 1, size=rng.integers(1, 9)),
                    0, n - 1)
        rows += [i] * len(c)
        cols += c.tolist()
        vals += rng.standard_normal(len(c)).tolist()
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    A.sum_duplicates()
    return A


def main() -> int:
    import numpy as np
    import scipy.sparse as sp
    import torch

    require(torch.cuda.is_available(), "no CUDA device: this script only "
            "runs on a GPU")
    sys.path.insert(0, HERE)
    import pflare_tpu_torch as tpf
    from pflare_tpu_torch import cuda, native
    from pflare_tpu_torch.sparse import DIA, TELL, BandedSpMV
    from pflare_tpu_torch.sparse import banded as tbanded
    from pflare_tpu_torch.sparse import dia as tdia
    from pflare_tpu_torch.utils.timers import (device_sync_read, get_timers,
                                               reset_timers)

    def setup_breakdown():
        return ", ".join(f"{k} {v:.3f} s" for k, v in get_timers().items())

    # ~~~~~~~~~~ 1. the card ~~~~~~~~~~
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}, host: {os.cpu_count()} CPUs, "
          f"{torch.get_num_threads()} torch threads")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ~~~~~~~~~~ 2. build ~~~~~~~~~~
    t_cuda = cuda.build_all()
    t0 = time.perf_counter()
    require(native.get_lib() is not None, "host C++ kernels failed to build")
    t_host = time.perf_counter() - t0
    print(f"# build: CUDA kernels {t_cuda:.3f} s (in parallel), host C++ "
          f"kernels {t_host:.3f} s")

    # ~~~~~~~~~~ 3. main path setup at 512^2 ~~~~~~~~~~
    A512 = tpf.adv_diff_2d(512)
    A512_32 = A512.astype(np.float32)
    pc = tpf.PCAIR(bench_options(tpf), dtype=torch.float32, device=dev)
    reset_timers()
    t0 = time.perf_counter()
    pc.setup(A512_32)
    t_setup = time.perf_counter() - t0
    print(f"# 512^2 f32 setup phases: {setup_breakdown()}")
    t0 = time.perf_counter()
    dh = pc.upload()
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t0
    print(f"# 512^2 f32: setup {t_setup:.3f} s (host), upload "
          f"{t_upload:.3f} s, levels {pc.n_levels} "
          f"{[lv.n for lv in pc.hierarchy.levels]}")

    # ~~~~~~~~~~ 4. kernels against their plain versions ~~~~~~~~~~
    rng = np.random.default_rng(0)
    err = {"aligned": 0.0, "padded": 0.0, "banded": 0.0}

    def check(op, group, label):
        """Kernel vs plain on one operator, in f32 and f64."""
        host = op.to_scipy()
        for dtype in (torch.float32, torch.float64):
            cls = type(op)
            M = cls.from_scipy(host, dtype=dtype).to(dev)
            x = torch.as_tensor(rng.standard_normal(host.shape[1]),
                                dtype=dtype, device=dev)
            y = M.matvec(x)
            if cls is DIA:
                ref = tdia.dia_spmv_plain(M.data, M.offsets, x, *M.shape)
            else:
                ref = tbanded.banded_spmv_plain(M.data, M.lcols, x, M.n, M.w,
                                                M.W)
            torch.cuda.synchronize()
            rel = float((y - ref).norm() / ref.norm())
            name = str(dtype).split(".")[-1]
            require(rel <= TOL[name], f"{label} {name}: kernel vs plain "
                    f"relative error {rel:.3e} > {TOL[name]}")
            err[group] = max(err[group], float((y - ref).abs().max()))
            print(f"# check {label} {name} shape {host.shape} "
                  f"rel err {rel:.3e}")

    ops = [("top A", dh.top)]
    for i, lev in enumerate(dh.levels):
        ops += [(f"level {i} {k}", lev[k]) for k in ("A_ff", "A_fc", "R",
                                                       "P")]
        if lev["inv_Aff"].kind == "assembled":
            ops.append((f"level {i} inv_Aff", lev["inv_Aff"].mat))
    n_dia = n_band = 0
    for label, op in ops:
        if isinstance(op, DIA):
            check(op, "aligned", label + f" DIA K={len(op.offsets)}")
            n_dia += 1
        elif isinstance(op, BandedSpMV):
            check(op, "banded", label + f" banded W={op.W}")
            n_band += 1
    require(n_dia > 0 and n_band > 0, "the 512^2 hierarchy has no DIA or "
            "no banded operator")
    for n in (8192, 4224):
        offs = [-64, -1, 0, 1, 64]
        C = sp.diags([rng.random(n - abs(o)) + 0.1 for o in offs], offs,
                     format="csr")
        check(DIA.from_scipy(C), "aligned" if n == 8192 else "padded",
              f"5-offset DIA n={n}")
    rect = sp.csr_matrix(sp.eye(700, 2100, k=1400) + sp.eye(700, 2100, k=-5)
                         + 2.0 * sp.eye(700, 2100))
    check(DIA.from_scipy(rect), "padded", "rectangular DIA 700x2100")
    A500 = tpf.adv_diff_2d(500)
    check(DIA.from_scipy(A500), "padded", "DIA 500^2")
    check(BandedSpMV.from_scipy(band_matrix(np, sp, 1200, 37, 1)), "banded",
          "random band n=1200 w=37")

    def plain_matvec(M, x):
        if isinstance(M, DIA):
            return tdia.dia_spmv_plain(M.data, M.offsets, x, *M.shape)
        return tbanded.banded_spmv_plain(M.data, M.lcols, x, M.n, M.w, M.W)

    def copy_op(M, dtype=None):
        """A copy of a device operator in its own storage, in ``dtype``."""
        data = M.data.to(dtype or M.dtype, copy=True)
        if isinstance(M, DIA):
            return DIA(M.offsets, data, M.shape)
        return BandedSpMV(data, M.lcols.clone(), M.n, M.n_cols, M.w, M.W)

    def measure(label, op):
        """Kernel, plain version and the cuSPARSE CSR product ``A @ x`` of
        one operator, each by ``graph_ms``, in the order plain, kernel,
        kernel, plain, library, library (the better of each pair).  The R
        calls take enough copies of the operator in turn to fill twice
        the L2, so the operator comes from device memory, as in a
        V-cycle, while x stays in L2, as it does there.  The bound is the
        larger of bytes = stored slots * (sizeof T + index bytes, 4 for
        banded, 0 for DIA) + (n_cols + n) * sizeof T over 3.35 TB/s and
        2 FLOPs per nonzero over 67 TFLOP/s."""
        host = op.to_scipy()
        n, n_cols = op.shape
        T = op.data.element_size()
        banded = isinstance(op, BandedSpMV)
        op_bytes = op.data.numel() * (T + (4 if banded else 0))
        copies = min(R, max(1, math.ceil(2 * L2_BYTES / op_bytes)))
        mats = [op] + [copy_op(op) for _ in range(copies - 1)]
        csrs = [torch.sparse_csr_tensor(
            torch.as_tensor(host.indptr, dtype=torch.int32),
            torch.as_tensor(host.indices, dtype=torch.int32),
            torch.as_tensor(host.data, dtype=op.dtype),
            size=host.shape).to(dev) for _ in range(copies)]
        x = torch.as_tensor(rng.standard_normal(n_cols), dtype=op.dtype,
                            device=dev)
        kernel = [lambda M=M: M.matvec(x) for M in mats]
        plain = [lambda M=M: plain_matvec(M, x) for M in mats]
        library = [lambda C=C: C @ x for C in csrs]
        p1, k1, k2, p2, l1, l2 = (graph_ms(torch, f) for f in (
            plain, kernel, kernel, plain, library, library))
        if banded:
            # what make_op would build without the banded container: the
            # plain PyTorch TELL gather (one gather, multiply, add a slot)
            tells = [TELL.from_scipy(host, dtype=op.dtype).to(dev)
                     for _ in range(copies)]
            tell_ms = graph_ms(torch, [lambda M=M: M.matvec(x)
                                       for M in tells])
        t_bytes = (op_bytes + (n + n_cols) * T) / HBM_BYTES_S * 1e3
        t_ops = 2 * host.nnz / FP32_FLOPS * 1e3
        row = {
            "shape": f"{label}: {n} x {n_cols}, K={op.data.shape[0]}"
                     + (f", W={op.W}" if banded else "")
                     + f", {host.nnz} nonzeros in {op.data.numel()} slots",
            "ms": min(k1, k2), "plain_ms": min(p1, p2),
            "library_ms": min(l1, l2),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "host_launch_ms": eager_ms(torch, kernel[0]),
            "operator_copies": copies,
        }
        if banded:
            row["tell_plain_ms"] = tell_ms
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        print(f"# time {row['shape']} ({op.dtype}): graph replay kernel "
              f"{row['ms']:.6f} ms (pair {k1:.6f}/{k2:.6f}), plain "
              f"{row['plain_ms']:.6f} ms, cuSPARSE CSR {row['library_ms']:.6f}"
              f" ms, bound {row['bound_ms']:.6f} ms ({row['bound_by']}; "
              f"{row['share_of_bound']:.1%} of it); eager back-to-back kernel "
              f"calls (host launch rate) {row['host_launch_ms']:.6f} ms; "
              f"{copies} operator copies"
              + (f"; TELL plain gather {tell_ms:.6f} ms" if banded else ""))
        return row

    def level0_dia(dhier, prefix):
        """The DIA operators of level 0 (the masked A_ff, A_fc, R, P)."""
        lev = dhier.levels[0]
        found = [(f"{prefix} level 0 {k}", lev[k])
                 for k in ("A_ff", "A_fc", "R", "P")
                 if isinstance(lev[k], DIA)]
        require(found, f"{prefix}: level 0 has no DIA operator")
        return found

    def profile_solve(pcx, bx, label):
        """One more warm solve under torch.profiler: each kernel's calls
        and device time in it, and the device's busy and idle shares.
        Device activity alone: the host ops' events are not read, and with
        them the profiled 2048^2 lAIR fcf solve took 85 s in all on the
        H100's host, 3.4 s of it the solve."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            device_sync_read(*pcx.solve_device(bx, max_it=10,
                                               ksp="richardson"))
            t_prof = time.perf_counter() - t0
        found = {"dia": [0, 0.0], "banded": [0, 0.0]}
        busy_us = 0.0
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA:  # kernels, copies, sets
                busy_us += evt.self_device_time_total
            for kind in found:
                if f"{kind}_spmv_kernel" in evt.key:
                    found[kind][0] += evt.count
                    found[kind][1] += evt.device_time_total
        print(f"# {label} profiled solve: wall {t_prof:.4f} s, device busy "
              f"{busy_us / 1e3:.3f} ms, idle share "
              f"{1 - busy_us / 1e6 / t_prof:.1%}; " + ", ".join(
                  f"{kind} kernel {c} calls, {t / 1e3:.3f} ms, "
                  f"{t / c if c else float('nan'):.2f} us a call"
                  for kind, (c, t) in found.items()))
        return {kind: t / c if c else None for kind, (c, t) in found.items()}

    def banded_targets(dhier):
        """The largest banded A_ff or A_fc, where one is banded (at 2048^2
        none is: their K * W exceeds the banded envelope), and the largest
        banded P of a device hierarchy."""
        found = {}
        for i, lev in enumerate(dhier.levels):
            for k in ("A_ff", "A_fc", "P"):
                op, key = lev[k], "P" if k == "P" else "A"
                if isinstance(op, BandedSpMV) and (
                        key not in found
                        or op.data.numel() > found[key][1].data.numel()):
                    found[key] = (f"level {i} {k}", op)
        require("P" in found, "the hierarchy has no banded P")
        return [found[key] for key in ("A", "P") if key in found]

    one = torch.zeros(1, device=dev)
    floor_ms = graph_ms(torch, [lambda: one + 1])
    print(f"# per-launch floor: graph replay of a one-element add "
          f"{floor_ms:.6f} ms a call")
    dia_512 = [("512^2 top A", dh.top)] + level0_dia(dh, "512^2")
    timed = {
        "aligned": [measure(label, op) for label, op in dia_512],
        "padded": [measure("500^2 A", DIA.from_scipy(
            A500, dtype=torch.float32).to(dev))],
        "banded": [measure("512^2 " + label, op)
                   for label, op in banded_targets(dh)],
    }

    # ~~~~~~~~~~ 5. the main path's solve at 512^2 ~~~~~~~~~~
    b = np.random.default_rng(1).standard_normal(A512.shape[0])
    tdia.KERNEL_LAUNCHES = 0
    tbanded.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    x, norms = pc.solve_device(b, max_it=10, ksp="richardson")
    device_sync_read(x, norms)
    t_solve = time.perf_counter() - t0
    norms = norms.cpu().numpy()
    launches = {"dia": tdia.KERNEL_LAUNCHES, "banded": tbanded.KERNEL_LAUNCHES}
    print(f"# 512^2 f32 solve_device: {t_solve:.4f} s to completion "
          f"(first call), launches {launches}")
    require(launches["dia"] > 0 and launches["banded"] > 0,
            f"a kernel of the path was not launched: {launches}")
    its = _converged_at(np, norms, 1e-5)
    require(its is not None, f"512^2 Richardson did not reach rtol 1e-5 in "
            f"10 iterations: {norms / norms[0]}")
    true = float(np.linalg.norm(A512 @ x.double().cpu().numpy() - b)
                 / np.linalg.norm(b))
    require(np.isfinite(norms).all() and true <= 1e-4,
            f"512^2 true residual {true:.3e}")
    t0 = time.perf_counter()
    device_sync_read(*pc.solve_device(b, max_it=10, ksp="richardson"))
    t_solve2 = time.perf_counter() - t0
    print(f"# 512^2 f32: rtol 1e-5 at iteration {its}, true residual "
          f"{true:.3e}, warm solve {t_solve2:.4f} s to completion, "
          f"relative norms {np.array2string(norms / norms[0], precision=3)}")

    # ~~~~~~~~~~ 6. f64 parity configuration at 512^2 ~~~~~~~~~~
    n = A512.shape[0]
    pc64 = tpf.PCAIR(tpf.AIROptions(a_lump=True, a_drop=1e-5,
                                    strong_threshold=0.99),
                     dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    pc64.setup(A512)
    t_setup64 = time.perf_counter() - t0
    pc64.upload()
    paths64 = gmres_paths(pc64, np.zeros(n), x0=np.ones(n), rtol=1e-10,
                          atol=1e-50, max_it=6, side="right")
    for path, (res, t_solve64, reads, _) in paths64.items():
        x64 = res.x.cpu().numpy()
        true64 = float(np.linalg.norm(A512 @ x64)
                       / np.linalg.norm(A512 @ np.ones(n)))
        print(f"# 512^2 f64 parity, {path} GMRES: {pc64.n_levels} levels, "
              f"setup {t_setup64:.3f} s, right GMRES {res.iterations} its "
              f"(converged {res.converged}), solve {t_solve64} s to "
              f"completion, host reads {reads} ({reads / res.iterations:.2f}"
              f" an iteration), ||Ax||/||A1|| {true64:.3e}, history "
              + np.array2string(res.history, precision=6,
                                max_line_width=10**4))
        require(res.converged and res.iterations <= 6 and true64 <= 1e-8,
                f"f64 parity configuration, {path} GMRES: did not converge "
                "in 6 iterations")
    h, h_eager = (paths64[p][0].history for p in ("stationary", "eager"))
    require(len(h) == len(h_eager) and np.all(
        np.abs(h - h_eager) <= HISTORY_RTOL * h_eager
        + HISTORY_FLOOR * h_eager[0]), "f64 parity configuration: the "
        "stationary and eager GMRES histories differ")

    # ~~~~~~~~~~ 7. the main path at 2048^2 ~~~~~~~~~~
    # Two more levels per doubling of the grid side keep the coarsest grid
    # near the 512^2 path's ~24k rows, which the order-24 Newton coarse
    # solve can handle; with 6 levels the 2048^2 coarse grid has ~400k
    # rows and 10 Richardson iterations stop near 5e-3.
    A2k = tpf.adv_diff_2d(2048)
    pc2k = tpf.PCAIR(bench_options(tpf, max_levels=10), dtype=torch.float32,
                     device=dev)
    reset_timers()
    t0 = time.perf_counter()
    pc2k.setup(A2k.astype(np.float32))
    t_setup2k = time.perf_counter() - t0
    print(f"# 2048^2 f32 setup phases: {setup_breakdown()}")
    t0 = time.perf_counter()
    dh2k = pc2k.upload()
    torch.cuda.synchronize()
    t_upload2k = time.perf_counter() - t0
    b2k = np.random.default_rng(1).standard_normal(A2k.shape[0])
    solve_s = []
    tdia.KERNEL_LAUNCHES = 0
    tbanded.KERNEL_LAUNCHES = 0
    for _ in range(2):
        t0 = time.perf_counter()
        x2k, n2k = pc2k.solve_device(b2k, max_it=10, ksp="richardson")
        device_sync_read(x2k, n2k)
        solve_s.append(time.perf_counter() - t0)
        if len(solve_s) == 1:   # the counts of the first solve alone
            launches2k = {"dia": tdia.KERNEL_LAUNCHES,
                          "banded": tbanded.KERNEL_LAUNCHES}
    n2k = n2k.cpu().numpy()
    its2k = _converged_at(np, n2k, 1e-5)
    true2k = float(np.linalg.norm(A2k @ x2k.double().cpu().numpy() - b2k)
                   / np.linalg.norm(b2k))
    print(f"# 2048^2 f32: {A2k.shape[0]} rows, {pc2k.n_levels} levels, "
          f"setup {t_setup2k:.3f} s (host), upload {t_upload2k:.3f} s, "
          f"solve {solve_s[0]:.4f} s first / {solve_s[1]:.4f} s warm, "
          f"rtol 1e-5 at iteration {its2k}, true residual {true2k:.3e}, "
          f"launches in the first solve {launches2k}")
    require(its2k is not None and true2k <= 1e-4,
            "2048^2 Richardson did not converge")
    require(launches2k["dia"] > 0 and launches2k["banded"] > 0,
            f"a kernel of the 2048^2 path was not launched: {launches2k}")

    # right GMRES to rtol 1e-5 by both GMRES paths
    paths2k = gmres_paths(pc2k, b2k, rtol=1e-5, side="right")
    for path, (res, t_gmres, reads, counts2k) in paths2k.items():
        true = float(np.linalg.norm(A2k @ res.x.double().cpu().numpy() - b2k)
                     / np.linalg.norm(b2k))
        print(f"# 2048^2 f32 right GMRES, {path}: {res.iterations} its "
              f"(converged {res.converged}), {t_gmres} s to completion, "
              f"host reads {reads} ({reads / res.iterations:.2f} an "
              f"iteration), true residual {true:.3e}, launches {counts2k}, "
              f"per iteration dia {counts2k['dia'] / res.iterations:.2f} "
              f"banded {counts2k['banded'] / res.iterations:.2f}")
        require(res.converged and true <= 1e-4, f"2048^2 {path} GMRES: "
                f"true residual {true:.3e}")
        require(counts2k["dia"] > 0 and counts2k["banded"] > 0,
                f"2048^2 {path} GMRES: a kernel was not launched")
    gmres_runs = {f"2048 gmres {path}": {"launches": c, "iterations":
                                         r.iterations}
                  for path, (r, _, _, c) in paths2k.items()}
    require(len({r.iterations for r, *_ in paths2k.values()}) == 1,
            "2048^2: the stationary and eager GMRES iterations differ")
    del paths2k

    # profiled last: a profiler session can slow the launches after it
    us_512 = profile_solve(pc, b, "512^2")
    us_2048 = profile_solve(pc2k, b2k, "2048^2")

    # ~~~~~~~~~~ 8. kernels at the 2048^2 shapes ~~~~~~~~~~
    ops2k = [("2048^2 top A", dh2k.top)]
    for i, lev in enumerate(dh2k.levels):
        ops2k += [(f"2048^2 level {i} {k}", lev[k])
                  for k in ("A_ff", "A_fc", "R", "P")]
        if lev["inv_Aff"].kind == "assembled":
            ops2k.append((f"2048^2 level {i} inv_Aff", lev["inv_Aff"].mat))
    for label, op in ops2k:
        if not isinstance(op, (DIA, BandedSpMV)):
            continue
        group = "aligned" if isinstance(op, DIA) else "banded"
        for M in (op, copy_op(op, torch.float64)):
            name = str(M.dtype).split(".")[-1]
            x = torch.as_tensor(rng.standard_normal(M.shape[1]),
                                dtype=M.dtype, device=dev)
            y, ref = M.matvec(x), plain_matvec(M, x)
            torch.cuda.synchronize()
            rel = float((y - ref).norm() / ref.norm())
            require(rel <= TOL[name], f"{label} {name}: kernel vs plain "
                    f"relative error {rel:.3e}")
            err[group] = max(err[group], float((y - ref).abs().max()))
            print(f"# check {label} {type(M).__name__} {name} shape "
                  f"{M.shape} rel err {rel:.3e}")
    A2000 = DIA.from_scipy(tpf.adv_diff_2d(2000), dtype=torch.float32).to(dev)
    dia_2k = [("2048^2 top A", dh2k.top)] + level0_dia(dh2k, "2048^2")
    timed["aligned"][:0] = [measure(label, op) for label, op in dia_2k]
    timed["padded"].insert(0, measure("2000^2 A", A2000))
    timed["banded"][:0] = [measure("2048^2 " + label, op)
                           for label, op in banded_targets(dh2k)]

    # ~~~~~~~~~~ 9. PCPFLAREINV ~~~~~~~~~~
    inv_runs, t_phase9 = phase9(np, sp, torch, tpf, tdia, tbanded, dev, A512,
                                A2k, check, measure, timed)
    print(f"# phase 9: {t_phase9:.3f} s")

    # ~~~~~~~~~~ 10. the AIR options ~~~~~~~~~~
    del pc2k, dh2k, x2k, ops2k, dia_2k
    options_runs, t_phase10 = phase10(
        np, sp, torch, tpf, tdia, tbanded, dev, A2k, check, measure, timed,
        profile_solve, setup_breakdown, launches2k["dia"] / 10)
    print(f"# phase 10: {t_phase10:.3f} s")

    # ~~~~~~~~~~ 11. same-pattern re-setup ~~~~~~~~~~
    reuse_runs, t_phase11, handoff = phase11(
        np, sp, torch, tpf, tdia, tbanded, dev, A512, A2k, setup_breakdown)
    print(f"# phase 11: {t_phase11:.3f} s")

    # ~~~~~~~~~~ 12. device re-setup ~~~~~~~~~~
    resetup_runs, t_phase12 = phase12(np, sp, torch, tpf, tdia, tbanded,
                                      dev, A512, A2k, handoff)
    del handoff
    print(f"# phase 12: {t_phase12:.3f} s")

    kernels = []
    for group, kind, site in (("aligned", "dia", DIA_SITES["aligned"]),
                              ("padded", "dia", DIA_SITES["padded"]),
                              ("banded", "banded", BANDED_SITE)):
        kernels.append({
            "name": f"dia_spmv[{group}]" if kind == "dia" else "banded_spmv",
            "route": "cuda", "source": f"pflare_tpu_torch/csrc/{kind}_spmv.cu",
            "replaces": site, "launches": launches[kind],
            "launches_2048": launches2k[kind],
            "launches_per_iteration": launches2k[kind] / 10,
            "launches_per_iteration_512": launches[kind] / 10,
            "max_abs_err": err[group],
            **{k: timed[group][0][k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")},
            "solve_us_per_call_512": us_512[kind],
            "solve_us_per_call_2048": us_2048[kind],
            "launch_floor_ms": floor_ms,
            "pcpflareinv_2048": {
                label: {"launches": run["launches"][kind],
                        "iterations": run["iterations"],
                        "launches_per_iteration":
                            run["launches"][kind] / run["iterations"]}
                for label, run in inv_runs.items()},
            "air_options": {
                label: {"launches": run["launches"][kind],
                        "iterations": run["iterations"],
                        "launches_per_iteration":
                            run["launches"][kind] / max(run["iterations"], 1)}
                for label, run in options_runs.items()},
            **{key: {label: {"launches": run["launches"][kind],
                             "iterations": run["iterations"],
                             "launches_per_iteration":
                                 run["launches"][kind]
                                 / max(run["iterations"], 1)}
                     for label, run in runs.items()}
               for key, runs in (("gmres_2048", gmres_runs),
                                 ("reuse", reuse_runs),
                                 ("device_resetup", resetup_runs))},
            "timings": timed[group]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


PHASE9_TYPES = (
    ("POWER", False, 1), ("POWER", True, 1),
    ("ARNOLDI", False, 1), ("ARNOLDI", True, 1),
    ("NEWTON", False, 1), ("NEWTON", True, 1),
    ("NEUMANN", False, 1), ("NEUMANN", True, 1),
    ("NEWTON_NO_EXTRA", True, 1), ("ARNOLDI", False, 2),
    ("JACOBI", False, 1), ("WJACOBI", False, 1),
    ("SAI", False, 1), ("ISAI", False, 1))


def phase9(np, sp, torch, tpf, tdia, tbanded, dev, A512, A2k, check,
           measure, timed):
    """PCPFLAREINV on the card (see the module docstring, phase 9).
    Returns the 2048^2 runs ({label: {"launches", "iterations"}}) and the
    phase's seconds."""
    from pflare_tpu_torch.sparse import DIA

    t_phase = time.perf_counter()

    def counts():
        return {"dia": tdia.KERNEL_LAUNCHES, "banded": tbanded.KERNEL_LAUNCHES}

    def zero_counts():
        tdia.KERNEL_LAUNCHES = 0
        tbanded.KERNEL_LAUNCHES = 0

    # (a) every type at 512^2, f64, card against CPU
    b = np.random.default_rng(0).standard_normal(A512.shape[0])
    for itype, mf, order in PHASE9_TYPES:
        label = (f"{itype}{' matrix-free' if mf else ' assembled'}"
                 + (f" sparsity order {order}" if order > 1 else ""))
        kw = dict(inverse_type=itype, matrix_free=mf,
                  inverse_sparsity_order=order, dtype=torch.float64)
        t0 = time.perf_counter()
        pc = tpf.PCPFLAREINV(**kw, device=dev).setup(A512)
        pc_cpu = tpf.PCPFLAREINV(**kw, device="cpu").setup(A512)
        t_setup = (time.perf_counter() - t0) / 2
        pc.upload()
        zero_counts()
        t0 = time.perf_counter()
        res = pc.solve(b, restart=30, max_it=60)
        t_card = time.perf_counter() - t0
        launches = counts()
        t0 = time.perf_counter()
        res_cpu = pc_cpu.solve(b, restart=30, max_it=60)
        t_cpu = time.perf_counter() - t0
        h, h_cpu = res.history, res_cpu.history
        require(len(h) == len(h_cpu), f"512^2 {label}: {len(h)} card norms "
                f"against {len(h_cpu)} on the CPU")
        dev_rel = float(np.max(np.abs(h - h_cpu) / h_cpu))
        print(f"# 512^2 f64 PCPFLAREINV {label} ({pc.inverse.kind}): host "
              f"setup {t_setup:.3f} s, GMRES {res.iterations} its, relative "
              f"residual {h[-1] / h[0]:.6e}, card {t_card:.4f} s, CPU "
              f"{t_cpu:.4f} s, history max relative difference "
              f"{dev_rel:.3e}, launches {launches}")
        require(dev_rel <= HISTORY_RTOL, f"512^2 {label}: card and CPU "
                f"histories differ by {dev_rel:.3e} > {HISTORY_RTOL}")
        require(launches["dia"] >= res.iterations, f"512^2 {label}: "
                f"{launches['dia']} DIA launches in {res.iterations} its")
        if order == 2:
            K6 = pc.get_inverse_mat()
            require(isinstance(K6, DIA) and len(K6.offsets) == 6,
                    "the 512^2 sparsity-order-2 inverse is not a K=6 DIA")
            check(K6, "aligned", "512^2 sparsity-order-2 inverse DIA K=6")

    # (b) 2048^2, f32: the default and NEWTON matrix-free
    A2k32 = A2k.astype(np.float32)
    b2k = np.random.default_rng(0).standard_normal(A2k.shape[0])
    runs = {}
    for label, kw, per_it in (
            ("arnoldi_assembled", {}, 2),
            ("newton_matrix_free", dict(inverse_type="NEWTON",
                                        matrix_free=True), 1)):
        pc = tpf.PCPFLAREINV(**kw, dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        pc.setup(A2k32)
        t_setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        pc.upload()
        torch.cuda.synchronize()
        t_upload = time.perf_counter() - t0
        zero_counts()
        t0 = time.perf_counter()
        res = pc.solve(b2k, side="right", rtol=1e-5, max_it=300)
        x = res.x.double().cpu().numpy()
        t_solve = time.perf_counter() - t0
        launches = counts()
        reported = res.residual_norms[-1] / float(np.linalg.norm(b2k))
        true = float(np.linalg.norm(A2k @ x - b2k) / np.linalg.norm(b2k))
        print(f"# 2048^2 f32 PCPFLAREINV {label} ({pc.inverse.kind}): host "
              f"setup {t_setup:.3f} s, upload {t_upload:.3f} s, right GMRES "
              f"{res.iterations} its (converged {res.converged}), solve "
              f"{t_solve:.4f} s to completion, relative residual "
              f"{reported:.6e} reported, {true:.6e} true (scipy, f64), "
              f"launches {launches}, DIA launches an iteration "
              f"{launches['dia'] / res.iterations:.3f}")
        require(np.isfinite(x).all() and abs(true - reported)
                <= 0.1 * reported, f"2048^2 {label}: true residual {true:.3e}"
                f" against {reported:.3e} reported")
        require(launches["dia"] >= per_it * res.iterations, f"2048^2 "
                f"{label}: {launches['dia']} DIA launches in "
                f"{res.iterations} its")
        runs[label] = {"launches": launches, "iterations": res.iterations}
        M = pc.get_inverse_mat()
        if M is not None:
            require(isinstance(M, DIA), "the 2048^2 inverse is not DIA")
            check(M, "aligned", f"2048^2 {label} inverse DIA "
                  f"K={len(M.offsets)}")
        del pc
    pc = tpf.PCPFLAREINV(inverse_sparsity_order=2, dtype=torch.float32,
                         device=dev).setup(A2k32)
    K6 = pc.get_inverse_mat()
    require(isinstance(K6, DIA) and len(K6.offsets) == 6,
            "the 2048^2 sparsity-order-2 inverse is not a K=6 DIA")
    check(K6, "aligned", "2048^2 sparsity-order-2 inverse DIA K=6")
    timed["aligned"].append(measure("2048^2 sparsity-order-2 inverse", K6))
    del pc, K6

    # (c) LU as a one-level PC
    A64 = tpf.adv_diff_2d(64)
    pc = tpf.PCPFLAREINV(inverse_type="LU", dtype=torch.float64,
                         device=dev).setup(A64)
    res = pc.solve(np.random.default_rng(0).standard_normal(A64.shape[0]),
                   max_it=2)
    print(f"# 64^2 f64 PCPFLAREINV LU ({pc.inverse.kind}): GMRES "
          f"{res.iterations} its, converged {res.converged}")
    require(res.converged and res.iterations <= 2,
            "LU did not converge in 2 GMRES iterations")
    return runs, time.perf_counter() - t_phase


def _bench_kw():
    """The bench's drop, lump and strength options (bench.py:430-436)."""
    return dict(a_lump=True, a_drop=1e-5, strong_threshold=0.99)


# the bench's depth (bench.py:430-436): phase 10 (a) cuts every set to it,
# so that a set's setup and solves cost seconds; the auto-truncation set
# keeps the full depth it truncates
BENCH_DEPTH = dict(max_levels=6, coarsest_inverse_type="NEWTON",
                   coarsest_poly_order=24, coarsest_matrix_free_polys=True)
FULL_DEPTH = dict(max_levels=300, coarsest_inverse_type="ARNOLDI",
                  coarsest_matrix_free_polys=False)

# (label, generator, options, solve keywords) of phase 10 (a); the sets on
# adv_diff_2d (and its scramble and 3-D sibling) also take the bench's
# drop, lump and strength.  Consecutive sets with the same generator and
# options share one setup.  ``device_ksp`` solves with ``solve_device``.
PHASE10_SETS = (
    ("lair", "adv", dict(z_type="LAIR"), {}),
    ("lair strong R", "adv", dict(z_type="LAIR", strong_r_threshold=0.01),
     {}),
    ("sai-lair", "adv", dict(z_type="LAIR_SAI"), {}),
    ("sai-lair strong R", "adv", dict(z_type="LAIR_SAI",
                                      strong_r_threshold=0.01), {}),
    ("ideal W", "adv", dict(one_point_classical_prolong=False), {}),
    ("ideal W matrix-free", "adv", dict(one_point_classical_prolong=False,
                                        matrix_free_polys=True), {}),
    ("ideal W lair", "adv", dict(one_point_classical_prolong=False,
                                 z_type="LAIR"), {}),
    ("ideal W matrix-free lair", "adv", dict(
        one_point_classical_prolong=False, matrix_free_polys=True,
        z_type="LAIR"), {}),
    ("improve and constrain", "adv", dict(
        one_point_classical_prolong=False, improve_w_its=2, improve_z_its=2,
        constrain_w=True, constrain_z=True), {}),
    ("symmetric", "diff", dict(symmetric=True), {}),
    ("full smoothing", "diff", dict(full_smoothing_up_and_down=True,
                                    inverse_type="ARNOLDI"), {}),
    ("fc", "adv", dict(inverse_type="POWER", smooth_order="fc"), {}),
    ("fcf", "adv", dict(smooth_order="fcf"), {}),
    ("per-level fcf/ff/f", "adv", dict(smooth_order_levels=("fcf", "ff",
                                                           "f")), {}),
    ("anisotropic ffc", "aniso", dict(strong_threshold=0.2,
                                      smooth_order="ffc"), {}),
    ("auto-truncation", "adv", dict(FULL_DEPTH, auto_truncate_start_level=2,
                                    auto_truncate_tol=1e-2,
                                    coarsest_poly_order=12), {}),
    ("PMIS", "adv", dict(cf_splitting_type="PMIS"), {}),
    ("PMIS_DIST2", "adv", dict(cf_splitting_type="PMIS_DIST2"), {}),
    ("AGG", "adv", dict(cf_splitting_type="AGG"), {}),
    ("PMIS_AGG", "adv", dict(cf_splitting_type="PMIS_AGG"), {}),
    ("CR", "adv", dict(cf_splitting_type="CR", strong_threshold=0.4), {}),
    # DIAG_DOM's strong threshold is its largest diagonal-dominance ratio
    ("DIAG_DOM", "adv", dict(cf_splitting_type="DIAG_DOM",
                             strong_threshold=0.9), {}),
    ("RCM reorder", "scrambled", dict(reorder="rcm"), {}),
    ("FGMRES", "adv", {}, dict(ksp="fgmres")),
    ("Richardson", "adv", {}, dict(ksp="richardson")),
    ("solve_device GMRES", "adv", {}, dict(device_ksp="gmres", max_it=10)),
    ("adv_diff_3d(64)", "adv3d", {}, {}),
)
def _phase10_solve(pcx, b, solve_kw):
    """One phase-10 (a) solve: (residual norms, x, iterations)."""
    kw = dict(solve_kw)
    ksp = kw.pop("device_ksp", None)
    if ksp is not None:
        x, norms = pcx.solve_device(b, max_it=kw["max_it"], ksp=ksp)
        return norms.cpu().numpy(), x, kw["max_it"]
    res = pcx.solve(b, **kw)
    return res.history, res.x, res.iterations


def _timed_phase10_solve(pcx, b, solve_kw):
    """The CPU twin's solve: (residual norms, seconds)."""
    t0 = time.perf_counter()
    h = _phase10_solve(pcx, b, solve_kw)[0]
    return h, time.perf_counter() - t0


HISTORY_FLOOR = 1e-12  # phase 10 (a): of the initial norm (rounding)
F32_FLOOR = 1e-6       # phase 10 (b): f32 rounding floor of a residual


def phase10(np, sp, torch, tpf, tdia, tbanded, dev, A2k, check, measure,
            timed, profile_solve, setup_breakdown, phase7_dia_per_it):
    """The AIR options on the card (see the module docstring, phase 10).
    Returns the 512^2 runs and the 2048^2 run ({label: {"launches",
    "iterations"}}) and the phase's seconds."""
    from pflare_tpu_torch.sparse import DIA
    from pflare_tpu_torch.sparse.ops import diag_dominance_ratio
    from pflare_tpu_torch.utils.timers import device_sync_read, reset_timers

    t_phase = time.perf_counter()

    def counts():
        return {"dia": tdia.KERNEL_LAUNCHES, "banded": tbanded.KERNEL_LAUNCHES}

    def zero_counts():
        tdia.KERNEL_LAUNCHES = 0
        tbanded.KERNEL_LAUNCHES = 0

    # (a) every option set at 512^2, f64, card against CPU
    A_adv = tpf.adv_diff_2d(512)
    p = np.random.default_rng(8).permutation(A_adv.shape[0])
    matrices = {"adv": A_adv, "diff": tpf.adv_diff_2d(512, alpha=1.0),
                "aniso": tpf.anisotropic_diffusion_2d(512, 1e-3),
                "scrambled": sp.csr_matrix(A_adv[p][:, p]),
                "adv3d": tpf.adv_diff_3d(64)}
    t0 = time.perf_counter()
    sub, keep = tpf.compute_diag_dom_submatrix(A_adv, max_dd_ratio=0.9)
    ratio = diag_dominance_ratio(sub, np.ones(sub.shape[0], bool)).max()
    print(f"# 512^2 compute_diag_dom_submatrix(0.9): {len(keep)} of "
          f"{A_adv.shape[0]} rows, largest ratio {ratio:.4f}, "
          f"{time.perf_counter() - t0:.3f} s")
    require(0 < len(keep) and ratio < 0.9, "512^2 diagonally dominant "
            f"submatrix: {len(keep)} rows, largest ratio {ratio:.4f}")
    runs = {}
    pending = []
    key = pc = pc_cpu = None
    # Each set's CPU twin (its upload and solve, the plain versions) runs in
    # a worker thread while this one sets up the next set and solves it on
    # the card; the worker gets two cores fewer, and the printed seconds of
    # both sides are taken under that shared load.
    n_threads = torch.get_num_threads()
    torch.set_num_threads(max(1, n_threads - 2))
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        for label, gen, kw, solve_kw in PHASE10_SETS:
            A = matrices[gen]
            solve_kw = dict(side="right", rtol=1e-10, atol=1e-50, max_it=60,
                            restart=30) | solve_kw
            if solve_kw.get("ksp", "gmres") != "gmres":
                solve_kw.pop("side")
            b = np.random.default_rng(0).standard_normal(A.shape[0])
            t_setup = 0.0
            if key != (gen, kw):
                key = (gen, kw)
                base = BENCH_DEPTH | (_bench_kw() if gen in (
                    "adv", "scrambled", "adv3d") else {})
                opts = tpf.AIROptions().replace(**(base | kw))
                t0 = time.perf_counter()
                pc = tpf.PCAIR(opts, dtype=torch.float64, device=dev).setup(A)
                t_setup = time.perf_counter() - t0
                pc_cpu = pc.on("cpu")
                pc.upload()
            zero_counts()
            t0 = time.perf_counter()
            h, x, its = _phase10_solve(pc, b, solve_kw)
            t_card = time.perf_counter() - t0
            launches = counts()
            true = float(np.linalg.norm(A @ x.cpu().numpy() - b)
                         / np.linalg.norm(b))
            line = (f"# {A.shape[0]} rows f64 AIR {label}: {pc.n_levels} "
                    "levels" + (", auto-truncated" if
                                pc.hierarchy.auto_truncated else "")
                    + f", host setup {t_setup:.3f} s"
                    + (" (shared with the set before)" if not t_setup else "")
                    + ", " + (solve_kw.get("device_ksp")
                              or solve_kw.get("ksp", "right GMRES"))
                    + (" on the device" if "device_ksp" in solve_kw else "")
                    + f" {its} its, relative residual {h[-1] / h[0]:.6e} "
                    f"reported, {true:.6e} true, card {t_card:.4f} s")
            pending.append((label, gen, line, h, its, launches, pool.submit(
                _timed_phase10_solve, pc_cpu, b, solve_kw)))
            runs[f"512 {label}"] = {"launches": launches, "iterations": its}
        del pc, pc_cpu
        top3d = DIA.from_scipy(matrices["adv3d"], dtype=torch.float32).to(dev)
        check(top3d, "aligned",
              f"adv_diff_3d(64) top A DIA K={len(top3d.offsets)}")
        timed["aligned"].append(measure("adv_diff_3d(64) top A", top3d))
        del matrices, A_adv, top3d
        t_a = time.perf_counter() - t_phase

        # (b) 2048^2, f32: the phase-7 options with lAIR and fcf smoothing,
        # and strong-R dropping: without it the lAIR sparsity of the coarse
        # levels reaches 100-200 unknowns a row, and their host solves alone
        # would take several minutes at this size.  Its host setup and
        # upload run while the worker finishes the CPU twins of (a).
        opts = tpf.AIROptions(
            a_lump=True, a_drop=1e-5, strong_threshold=0.99, max_levels=10,
            coarsest_inverse_type=tpf.InverseType.NEWTON,
            coarsest_poly_order=24, coarsest_matrix_free_polys=True,
            z_type=tpf.ZType.LAIR,
            strong_r_threshold=0.01).with_smooth_type("fcf")
        pc = tpf.PCAIR(opts, dtype=torch.float32, device=dev)
        reset_timers()
        t0 = time.perf_counter()
        pc.setup(A2k.astype(np.float32))
        t_setup = time.perf_counter() - t0
        print(f"# 2048^2 f32 lAIR fcf setup phases: {setup_breakdown()}")
        t0 = time.perf_counter()
        pc.upload()
        torch.cuda.synchronize()
        t_upload = time.perf_counter() - t0

        t0 = time.perf_counter()
        for label, gen, line, h, its, launches, twin in pending:
            h_cpu, t_cpu = twin.result()
            require(len(h) == len(h_cpu), f"512^2 {label}: {len(h)} card "
                    f"norms against {len(h_cpu)} on the CPU")
            diff = np.abs(h - h_cpu)
            dev_rel = float(np.max(diff / h_cpu))
            print(f"{line}, CPU {t_cpu:.4f} s, history max relative "
                  f"difference {dev_rel:.3e}, launches {launches}, per "
                  f"iteration dia {launches['dia'] / max(its, 1):.2f} banded "
                  f"{launches['banded'] / max(its, 1):.2f}")
            require(np.all(diff <= HISTORY_RTOL * h_cpu
                           + HISTORY_FLOOR * h_cpu[0]),
                    f"512^2 {label}: card and CPU histories differ by "
                    f"{dev_rel:.3e} of a norm")
            if gen == "scrambled":
                require(launches["banded"] > 0, f"512^2 {label}: the banded "
                        f"kernel was not launched: {launches}")
            else:
                require(launches["dia"] > 0, f"512^2 {label}: the DIA "
                        f"kernel was not launched: {launches}")
        print(f"# phase 10 (a): card side {t_a:.3f} s; its CPU twins ended "
              f"{time.perf_counter() - t0:.3f} s after (b)'s host setup and "
              "upload")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        torch.set_num_threads(n_threads)
    del pending
    b2k = np.random.default_rng(1).standard_normal(A2k.shape[0])

    def true_residual(x):
        return float(np.linalg.norm(A2k @ x.double().cpu().numpy() - b2k)
                     / np.linalg.norm(b2k))

    zero_counts()
    t0 = time.perf_counter()
    x, norms = pc.solve_device(b2k, max_it=10)
    device_sync_read(x, norms)
    t_solve = time.perf_counter() - t0
    launches = counts()
    norms = norms.cpu().numpy()
    reported, true = float(norms[-1] / norms[0]), true_residual(x)
    # two iterations, above the f32 rounding floor, where the reported
    # residual must be the true one's; after ten both sit at that floor
    # (b - A x in f32 rounds to ~1e-7 of ||b||), where they differ
    x2, norms2 = pc.solve_device(b2k, max_it=2)
    reported2 = float(norms2[-1] / norms2[0])
    true2 = true_residual(x2)
    print(f"# 2048^2 f32 lAIR fcf: {pc.n_levels} levels "
          f"{[lv.n for lv in pc.hierarchy.levels]}, host setup "
          f"{t_setup:.3f} s, upload {t_upload:.3f} s, solve_device 10 "
          f"Richardson its {t_solve:.4f} s to completion, relative residual "
          f"{reported:.6e} reported, {true:.6e} true (scipy, f64); after 2 "
          f"its {reported2:.6e} reported, {true2:.6e} true; launches "
          f"{launches}, DIA launches an iteration {launches['dia'] / 10:.1f} "
          f"(phase 7: {phase7_dia_per_it:.1f}), relative norms "
          f"{np.array2string(norms / norms[0], precision=3)}")
    require(np.isfinite(norms).all() and abs(true2 - reported2)
            <= 0.1 * reported2, f"2048^2 lAIR fcf: true residual {true2:.3e}"
            f" against {reported2:.3e} reported after 2 its")
    require(abs(true - reported) <= 0.1 * reported
            or max(true, reported) <= F32_FLOOR, f"2048^2 lAIR fcf: true "
            f"residual {true:.3e} against {reported:.3e} reported")
    require(launches["dia"] / 10 > phase7_dia_per_it, f"2048^2 lAIR fcf: "
            f"{launches['dia'] / 10} DIA launches an iteration, not more "
            f"than phase 7's {phase7_dia_per_it}")
    runs["2048 lair fcf"] = {"launches": launches, "iterations": 10}

    # right GMRES on the device (gmres_right_fixed) on the same hierarchy
    zero_counts()
    t0 = time.perf_counter()
    x, norms = pc.solve_device(b2k, max_it=10, ksp="gmres")
    device_sync_read(x, norms)
    t_solve = time.perf_counter() - t0
    launches = counts()
    norms = norms.cpu().numpy()
    x2, norms2 = pc.solve_device(b2k, max_it=2, ksp="gmres")
    reported2 = float(norms2[-1] / norms2[0])
    true2 = true_residual(x2)
    print(f"# 2048^2 f32 lAIR fcf: solve_device 10 right GMRES its "
          f"{t_solve:.4f} s to completion, relative residual "
          f"{norms[-1] / norms[0]:.6e} reported, {true_residual(x):.6e} true; "
          f"after 2 its {reported2:.6e} reported, {true2:.6e} true; launches "
          f"{launches}, relative norms "
          f"{np.array2string(norms / norms[0], precision=3)}")
    require(np.isfinite(norms).all() and abs(true2 - reported2)
            <= 0.1 * reported2, f"2048^2 lAIR fcf GMRES: true residual "
            f"{true2:.3e} against {reported2:.3e} reported after 2 its")
    require(launches["dia"] > 0 and launches["banded"] > 0, f"2048^2 lAIR "
            f"fcf GMRES: a kernel was not launched: {launches}")
    runs["2048 lair fcf gmres"] = {"launches": launches, "iterations": 10}
    t0 = time.perf_counter()
    profile_solve(pc, b2k, "2048^2 lAIR fcf")
    print(f"# 2048^2 lAIR fcf: profiled solve and its tables "
          f"{time.perf_counter() - t0:.3f} s")
    del pc
    print(f"# phase 10 (b), with the end of (a)'s CPU twins: "
          f"{time.perf_counter() - t_phase - t_a:.3f} s")
    return runs, time.perf_counter() - t_phase


# (label, options) of phase 11 (a), each on the bench's options and depth
# with reuse_sparsity
PHASE11_SETS = tuple(
    (f"amount {a}" + (" reuse_poly_coeffs" if p else ""),
     dict(reuse_amount=a, reuse_poly_coeffs=p))
    for a in (1, 2, 3) for p in (False, True))


def perturbed(np, A, seed):
    """A's pattern, its values times 1 + 0.01 N(0, 1)."""
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 0.01 * np.random.default_rng(seed)
                         .standard_normal(A.nnz))
    return A2


def phase11(np, sp, torch, tpf, tdia, tbanded, dev, A512, A2k,
            setup_breakdown):
    """Same-pattern re-setup on the host (see the module docstring, phase
    11).  Returns the runs ({label: {"launches", "iterations"}}) and the
    phase's seconds."""
    from pflare_tpu_torch.utils.timers import (device_sync_read, get_timers,
                                               reset_timers)

    t_phase = time.perf_counter()

    def counts():
        return {"dia": tdia.KERNEL_LAUNCHES, "banded": tbanded.KERNEL_LAUNCHES}

    def zero_counts():
        tdia.KERNEL_LAUNCHES = 0
        tbanded.KERNEL_LAUNCHES = 0

    def resetup_split():
        return ", ".join(f"{k} {v:.4f} s" for k, v in get_timers().items()
                         if k.startswith("resetup_")) or "no resetup_ timers"

    def max_operator_diff(h1, h2):
        diff = 0.0
        for l1, l2 in zip(h1.levels, h2.levels):
            for name in ("A_ff", "A_fc", "R", "P", "inv_Aff_host"):
                diff = max(diff, float(abs(getattr(l1, name)
                                           - getattr(l2, name)).max()))
        return max(diff, float(abs(h1.coarse_matrix
                                   - h2.coarse_matrix).max()))

    runs = {}
    # (a) 512^2, f64, the bench's options and depth
    A2 = perturbed(np, A512, 5)
    b = np.random.default_rng(0).standard_normal(A512.shape[0])
    kw = dict(side="right", rtol=1e-10, atol=1e-50, max_it=60)
    pending = []
    n_threads = torch.get_num_threads()
    torch.set_num_threads(max(1, n_threads - 2))
    pool = ThreadPoolExecutor(max_workers=1)

    def setup_pair(opts):
        """(PCAIR set up on A512 then re-set up on A2, first-setup s,
        re-setup s)."""
        pc = tpf.PCAIR(opts, dtype=torch.float64, device=dev)
        t0 = time.perf_counter()
        pc.setup(A512)
        t_first = time.perf_counter() - t0
        reset_timers()
        t0 = time.perf_counter()
        pc.setup(A2, "same")
        return pc, t_first, time.perf_counter() - t0

    def card_and_twin(label, pc, line):
        """Upload, solve on the card, queue the CPU twin's solve."""
        pc_cpu = pc.on("cpu")
        t0 = time.perf_counter()
        pc.upload()
        torch.cuda.synchronize()
        t_upload = time.perf_counter() - t0
        zero_counts()
        t0 = time.perf_counter()
        res = pc.solve(b, **kw)
        device_sync_read(res.x)
        t_card = time.perf_counter() - t0
        launches = counts()
        pending.append((label, f"{line}, upload {t_upload:.3f} s, right "
                        f"GMRES {res.iterations} its, relative residual "
                        f"{res.history[-1] / res.history[0]:.6e}, card "
                        f"{t_card:.4f} s", res, launches, pool.submit(
                            _timed_solve, pc_cpu, b, kw)))
        runs[f"512 {label}"] = {"launches": launches,
                                "iterations": res.iterations}
        return res

    base = tpf.AIROptions().replace(**(BENCH_DEPTH | _bench_kw()),
                                    reuse_sparsity=True)
    try:
        for label, opts_kw in PHASE11_SETS:
            pc, t_first, t_re = setup_pair(base.replace(**opts_kw))
            fast = sum("host_fast" in lv.patterns
                       for lv in pc.hierarchy.levels)
            require(fast == (0 if opts_kw["reuse_amount"] < 2
                             else len(pc.hierarchy.levels)),
                    f"512^2 {label}: {fast} levels re-set up by plans")
            card_and_twin(label, pc, f"# 512^2 f64 reuse {label}: first "
                          f"setup {t_first:.3f} s, re-setup {t_re:.3f} s "
                          f"({resetup_split()}), {fast} of "
                          f"{len(pc.hierarchy.levels)} levels by plans")
            if label == "amount 2 reuse_poly_coeffs":
                pc_fast = pc
            else:
                del pc

        # the generic reuse path, with the plans popped (tests/test_air.py:
        # 381-384), against the plan re-setup
        gen = tpf.PCAIR(pc_fast.options, dtype=torch.float64, device=dev)
        gen.setup(A512)
        for lv in gen.hierarchy.levels:
            lv.patterns.pop("host_fast", None)
        reset_timers()
        t0 = time.perf_counter()
        gen.setup(A2, "same")
        t_re = time.perf_counter() - t0
        diff = max_operator_diff(pc_fast.hierarchy, gen.hierarchy)
        card_and_twin("generic", gen, f"# 512^2 f64 reuse generic (plans "
                      f"popped): re-setup {t_re:.3f} s, operators within "
                      f"{diff:.3e} of the plan re-setup's")
        require(diff <= 1e-11, f"512^2: plan and generic re-setups differ "
                f"by {diff:.3e}")
        del gen, pc_fast

        # set_poly_coefficients: a fresh PCAIR given every level's
        # coefficients reproduces the history
        opts = base.replace(reuse_amount=2)
        pc1 = tpf.PCAIR(opts, dtype=torch.float64, device=dev).setup(A512)
        res1 = pc1.solve(b, **kw)
        pc2 = tpf.PCAIR(opts, dtype=torch.float64, device=dev)
        for lvl in list(range(pc1.n_levels - 1)) + [-1]:
            c = pc1.get_poly_coefficients(lvl)
            if c is not None:
                pc2.set_poly_coefficients(lvl, c)
        pc2.setup(A512)
        res2 = pc2.solve(b, **kw)
        rel = float(np.max(np.abs(res2.history - res1.history)
                           / res1.history))
        print(f"# 512^2 f64 set_poly_coefficients: {res2.iterations} its "
              f"against {res1.iterations}, histories within {rel:.3e}")
        require(res2.iterations == res1.iterations and rel <= 1e-12,
                "512^2 set_poly_coefficients did not reproduce the history")
        del pc1
        t0 = time.perf_counter()
        pc2.setup(A2, "same")
        card_and_twin("set_poly_coefficients", pc2, "# 512^2 f64 reuse "
                      "set_poly_coefficients: re-setup "
                      f"{time.perf_counter() - t0:.3f} s with the injected "
                      "coefficients")
        del pc2

        # freeze: the re-setup keeps the hierarchy
        pc = tpf.PCAIR(opts, dtype=torch.float64, device=dev).setup(A512)
        h = pc.hierarchy
        pc.freeze(True)
        pc.setup(A2, "same")
        require(pc.hierarchy is h, "512^2 freeze: the hierarchy changed")
        card_and_twin("freeze", pc, "# 512^2 f64 reuse freeze: hierarchy "
                      "kept")
        del pc, h

        # (b) 2048^2, f32 solve of a hierarchy set up from the f64 matrix
        # (the plan re-setup computes in f64, as the reference's does)
        print(f"# phase 11 (b) starts: {host_gib()}", flush=True)
        opts = bench_options(tpf, max_levels=10).replace(
            reuse_sparsity=True, reuse_amount=3, reuse_poly_coeffs=True)
        pc = tpf.PCAIR(opts, dtype=torch.float32, device=dev)
        reset_timers()
        t0 = time.perf_counter()
        pc.setup(A2k)
        t_first = time.perf_counter() - t0
        first_split = setup_breakdown()
        A2k2 = perturbed(np, A2k, 6)
        reset_timers()
        t0 = time.perf_counter()
        pc.setup(A2k2, "same")
        t_re = time.perf_counter() - t0
        fast = sum("host_fast" in lv.patterns for lv in pc.hierarchy.levels)
        t0 = time.perf_counter()
        dh = pc.upload()
        torch.cuda.synchronize()
        t_upload = time.perf_counter() - t0
        require(dh.top.dtype == torch.float32 and all(
            lev[k].dtype == torch.float32 for lev in dh.levels
            for k in ("A_ff", "A_fc", "R", "P")), "2048^2 reuse: the "
            "upload is not float32")
        b2k = np.random.default_rng(1).standard_normal(A2k.shape[0])
        zero_counts()
        t0 = time.perf_counter()
        x, norms = pc.solve_device(b2k, max_it=10, ksp="richardson")
        device_sync_read(x, norms)
        t_solve = time.perf_counter() - t0
        launches = counts()
        norms = norms.cpu().numpy()
        its = _converged_at(np, norms, 1e-5)
        true = float(np.linalg.norm(A2k2 @ x.double().cpu().numpy() - b2k)
                     / np.linalg.norm(b2k))
        print(f"# 2048^2 after the re-setup: {host_gib()}")
        print(f"# 2048^2 reuse amount 3 (f64 setup, f32 solve): first "
              f"setup {t_first:.3f} s ({first_split}), re-setup {t_re:.3f} "
              f"s ({resetup_split()}), {t_first / t_re:.2f}x, {fast} of "
              f"{len(pc.hierarchy.levels)} levels by plans; upload "
              f"{t_upload:.3f} s; solve_device 10 Richardson its "
              f"{t_solve:.4f} s, rtol 1e-5 at iteration {its}, true "
              f"residual {true:.3e}, launches {launches}")
        require(fast == len(pc.hierarchy.levels), "2048^2: a level was not "
                "re-set up by its plans")
        require(its is not None and true <= 1e-4 and np.isfinite(norms).all(),
                f"2048^2 reuse: did not converge ({true:.3e})")
        require(launches["dia"] > 0 and launches["banded"] > 0,
                f"2048^2 reuse: a kernel was not launched: {launches}")
        runs["2048 reuse amount 3"] = {"launches": launches,
                                       "iterations": 10}
        handoff = {"pc": pc, "A2": A2k2, "host_s": t_re + t_upload}
        del dh, x

        for label, line, res, launches, twin in pending:
            h_cpu, t_cpu = twin.result()
            h = res.history
            require(len(h) == len(h_cpu), f"512^2 reuse {label}: {len(h)} "
                    f"card norms against {len(h_cpu)} on the CPU")
            diff = np.abs(h - h_cpu)
            print(f"{line}, CPU {t_cpu:.4f} s, history max relative "
                  f"difference {float(np.max(diff / h_cpu)):.3e}, launches "
                  f"{launches}")
            require(np.all(diff <= HISTORY_RTOL * h_cpu
                           + HISTORY_FLOOR * h_cpu[0]),
                    f"512^2 reuse {label}: card and CPU histories differ")
            require(launches["dia"] > 0, f"512^2 reuse {label}: the DIA "
                    f"kernel was not launched: {launches}")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        torch.set_num_threads(n_threads)
    return runs, time.perf_counter() - t_phase, handoff


# (label, options) of phase 12 (a)'s plan-alone check, card against CPU:
# configurations of the reference's device re-setup tests
# (tests/test_device_resetup.py:60-133) and the auto-truncated one
PHASE12_SETS = (
    ("strong R", dict(strong_r_threshold=0.01)),
    ("lAIR", dict(z_type="LAIR")),
    ("SAI smoother", dict(inverse_type="SAI")),
    ("full smoothing", dict(full_smoothing_up_and_down=True)),
    ("fcf C smoothing", dict(smooth_order="fcf")),
    ("Newton matrix-free coarse", dict(coarsest_inverse_type="NEWTON",
                                       coarsest_matrix_free_polys=True,
                                       coarsest_poly_order=10)),
    ("constrain_z", dict(constrain_z=True)),
    ("LU coarse", dict(coarsest_inverse_type="LU")),
    ("auto-truncated", dict(auto_truncate_start_level=2,
                            auto_truncate_tol=0.5, coarsest_poly_order=12)),
)


def max_rel_diff(np, got, want):
    """The largest difference of two ``DeviceHierarchy.to_scipy`` dicts,
    each operator's over its largest entry, and the operator."""
    require(got.keys() == want.keys(), "the device hierarchies hold "
            f"different operators: {sorted(got.keys() ^ want.keys())}")
    worst = (0.0, "")
    for name in want:
        scale = max(float(abs(want[name]).max()), 1e-300)
        worst = max(worst, (float(abs(got[name] - want[name]).max()) / scale,
                            name))
    return worst


def phase12(np, sp, torch, tpf, tdia, tbanded, dev, A512, A2k, handoff):
    """The device re-setup (see the module docstring, phase 12).  Returns
    the runs ({label: {"launches", "iterations"}}) and the phase's
    seconds."""
    from pflare_tpu_torch.sparse import BandedSpMV
    from pflare_tpu_torch.utils.timers import count_syncs, device_sync_read

    t_phase = time.perf_counter()

    def counts():
        return {"dia": tdia.KERNEL_LAUNCHES, "banded": tbanded.KERNEL_LAUNCHES}

    def zero_counts():
        tdia.KERNEL_LAUNCHES = 0
        tbanded.KERNEL_LAUNCHES = 0

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def has_banded(dh):
        return any(isinstance(op, BandedSpMV) for lev in dh.levels
                   for op in lev.values())

    runs = {}
    # (a) 512^2, f64, the bench's options and depth
    opts = tpf.AIROptions().replace(**(BENCH_DEPTH | _bench_kw()),
                                    reuse_sparsity=True, reuse_amount=3,
                                    reuse_poly_coeffs=True)
    A2 = perturbed(np, A512, 7)
    b = np.random.default_rng(0).standard_normal(A512.shape[0])
    kw = dict(side="right", rtol=1e-10, atol=1e-50, max_it=60)
    pc = tpf.PCAIR(opts, dtype=torch.float64, device=dev)
    _, t_first = timed(pc.setup, A512)
    twin = pc.on("cpu")
    plan, t_plan = timed(pc.build_device_resetup)
    _, t_install = timed(plan.install, pc, A2)
    _, t_warm = timed(plan.install, pc, A2)
    _, n_sync = count_syncs(plan.install, pc, A2)
    host = tpf.PCAIR(opts, dtype=torch.float64, device=dev).setup(A512)
    t0 = time.perf_counter()
    host.setup(A2, "same")
    host.upload()
    torch.cuda.synchronize()
    t_host = time.perf_counter() - t0
    diff, where = max_rel_diff(np, pc.upload().to_scipy(),
                               host.upload().to_scipy())
    print(f"# 512^2 f64 device re-setup: first setup {t_first:.3f} s, plan "
          f"{t_plan:.3f} s ({plan.device_bytes / 1e6:.1f} MB on the card), "
          f"install {t_install:.4f} s first / {t_warm:.4f} s warm, host "
          f"re-setup + upload {t_host:.4f} s ({t_host / t_warm:.1f}x the "
          f"warm install); operators within {diff:.3e} of the host's "
          f"({where}); synchronisations in one install {n_sync}")
    require(diff <= 1e-10, f"512^2 device re-setup: {where} differs from "
            f"the host re-setup's by {diff:.3e} of its largest entry")
    require(n_sync == 0, f"512^2 device re-setup: {n_sync} synchronisations "
            "in one install")
    twin.build_device_resetup().install(twin, A2)
    hres = host.solve(b, **kw)
    zero_counts()
    t0 = time.perf_counter()
    res = pc.solve(b, **kw)
    device_sync_read(res.x)
    t_card = time.perf_counter() - t0
    launches = counts()
    h_cpu, t_cpu = _timed_solve(twin, b, kw)
    h = res.history
    rel = np.abs(h - h_cpu)
    print(f"# 512^2 f64 device re-setup: right GMRES {res.iterations} its "
          f"(host re-setup {hres.iterations}), card {t_card:.4f} s, CPU twin "
          f"{t_cpu:.4f} s, history max relative difference "
          f"{float(np.max(rel / h_cpu)):.3e}, launches {launches}")
    require(res.converged and res.iterations == hres.iterations,
            "512^2 device re-setup: GMRES iterations differ from the host "
            "re-setup's")
    require(len(h) == len(h_cpu) and np.all(
        rel <= HISTORY_RTOL * h_cpu + HISTORY_FLOOR * h_cpu[0]),
        "512^2 device re-setup: card and CPU twin histories differ")
    banded = has_banded(pc.upload())
    require(launches["dia"] > 0 and (launches["banded"] > 0 or not banded),
            f"512^2 device re-setup: a kernel was not launched: {launches}")
    runs["512 device re-setup"] = {"launches": launches,
                                   "iterations": res.iterations}
    del host, twin
    for step in range(3):
        A_s = A512.copy()
        A_s.data = A_s.data * (1.0 + 0.02 * (step + 1) * np.random
                               .default_rng(20 + step)
                               .standard_normal(A512.nnz))
        _, t_s = timed(plan.install, pc, A_s)
        zero_counts()
        res = pc.solve(b, **kw)
        launches = counts()
        true = float(np.linalg.norm(A_s @ res.x.cpu().numpy() - b)
                     / np.linalg.norm(b))
        print(f"# 512^2 f64 install {step + 1} (drift "
              f"{0.02 * (step + 1):.2f}): {t_s:.4f} s, right GMRES "
              f"{res.iterations} its, true residual {true:.3e}, launches "
              f"{launches}")
        require(res.converged and true <= 1e-8, f"512^2 install {step + 1}: "
                f"true residual {true:.3e}")
        require(launches["dia"] > 0, f"512^2 install {step + 1}: the DIA "
                "kernel was not launched")
        runs[f"512 install {step + 1}"] = {"launches": launches,
                                           "iterations": res.iterations}
    del pc, plan

    # the plan alone, card against CPU, on the reference's configurations
    A128 = tpf.adv_diff_2d(128)
    A128_2 = perturbed(np, A128, 8)
    for label, set_kw in PHASE12_SETS:
        o = tpf.AIROptions().replace(reuse_sparsity=True, reuse_amount=3,
                                     reuse_poly_coeffs=True, max_levels=5,
                                     **set_kw)
        pcs = tpf.PCAIR(o, dtype=torch.float64, device=dev).setup(A128)
        cpu = pcs.on("cpu")
        (dh, n_s) = count_syncs(pcs.build_device_resetup(), A128_2)
        dh_cpu = cpu.build_device_resetup()(A128_2)
        diff, where = max_rel_diff(np, dh.to_scipy(), dh_cpu.to_scipy())
        print(f"# 128^2 f64 device re-setup plan, {label}: card against CPU "
              f"{diff:.3e} ({where}), synchronisations {n_s}")
        # the card's atomic segment sums round otherwise than the CPU's
        # ordered ones, and the difference grows down the levels (to
        # 5.6e-12 at level 7 of a 12-level constrained hierarchy at 48^2)
        require(diff <= 1e-11, f"128^2 {label}: the card's plan differs from "
                f"the CPU's by {diff:.3e} at {where}")
    t_a = time.perf_counter() - t_phase

    # (b) 2048^2, f32: phase 11 (b)'s PCAIR and matrix
    pc, A2k2 = handoff["pc"], handoff["A2"]
    torch.cuda.reset_peak_memory_stats()
    plan, t_plan = timed(pc.build_device_resetup)
    _, t_install = timed(plan.install, pc, A2k2)
    _, t_warm = timed(plan.install, pc, A2k2)
    _, n_sync = count_syncs(plan.install, pc, A2k2)
    peak = torch.cuda.max_memory_allocated()
    b2k = np.random.default_rng(1).standard_normal(A2k.shape[0])
    zero_counts()
    t0 = time.perf_counter()
    x, norms = pc.solve_device(b2k, max_it=10, ksp="richardson")
    device_sync_read(x, norms)
    t_solve = time.perf_counter() - t0
    launches = counts()
    norms = norms.cpu().numpy()
    its = _converged_at(np, norms, 1e-5)
    true = float(np.linalg.norm(A2k2 @ x.double().cpu().numpy() - b2k)
                 / np.linalg.norm(b2k))
    print(f"# 2048^2 f32 device re-setup: plan {t_plan:.3f} s "
          f"({plan.device_bytes / 1e9:.3f} GB on the card), install "
          f"{t_install:.4f} s first / {t_warm:.4f} s warm, against host "
          f"re-setup + upload {handoff['host_s']:.3f} s "
          f"({handoff['host_s'] / t_warm:.1f}x); peak device memory "
          f"{peak / 1e9:.3f} GB; synchronisations in one install {n_sync}; "
          f"solve_device 10 Richardson its {t_solve:.4f} s, rtol 1e-5 at "
          f"iteration {its}, true residual {true:.3e}, launches {launches}; "
          f"{host_gib()}")
    require(its is not None and true <= 1e-4 and np.isfinite(norms).all(),
            f"2048^2 device re-setup: did not converge ({true:.3e})")
    require(launches["dia"] > 0 and launches["banded"] > 0,
            f"2048^2 device re-setup: a kernel was not launched: {launches}")
    runs["2048 device re-setup"] = {"launches": launches, "iterations": 10}

    # one warm install under the profiler, device activity alone
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, t_prof = timed(plan.install, pc, A2k2)
    busy_us, ops = 0.0, []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            busy_us += evt.self_device_time_total
            ops.append((evt.self_device_time_total, evt.count, evt.key))
    ops.sort(reverse=True)
    print(f"# 2048^2 f32 profiled install: wall {t_prof:.4f} s, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / 1e6 / t_prof:.1%}; top device ops: " + "; ".join(
              f"{key[:60]} {t / 1e3:.3f} ms in {c}" for t, c, key in ops[:6]))
    print(f"# phase 12 (a) {t_a:.3f} s, (b) "
          f"{time.perf_counter() - t_phase - t_a:.3f} s")
    del pc, plan, x
    return runs, time.perf_counter() - t_phase


def _timed_solve(pcx, b, kw):
    """A CPU twin's solve: (history, seconds)."""
    t0 = time.perf_counter()
    h = pcx.solve(b, **kw).history
    return h, time.perf_counter() - t0


def _converged_at(np, norms, rtol):
    """First iteration whose residual norm is <= rtol * the initial one."""
    hit = np.nonzero(norms <= rtol * norms[0])[0]
    return int(hit[0]) if len(hit) else None


if __name__ == "__main__":
    sys.exit(main())
