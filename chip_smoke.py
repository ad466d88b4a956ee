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
   residual against scipy, and every kernel launched; then the same solve
   eagerly with each TELL, ELL and DELL product counted
   (``gather_routes``): the gather kernel ``csrc/sell_spmv.cu`` launched
   once a product for the TELL operators and for the coarse inverse's
   ELL, as many times in all as the counted solve, and once a product in
   an apply and a stationary right GMRES;
6. the f64 parity configuration at 512^2: full depth, right GMRES from
   x0 = 1 with a zero RHS, rtol 1e-10, <= 6 iterations, by the default
   (stationary) GMRES and by the host-driven one (``eager=True``), twice
   each in the order stationary, eager, eager, stationary: equal
   iterations, histories equal to 1e-8 of each norm (or 1e-12 of the
   first), each solve's seconds and host reads (counted by the solvers);
7. the main path at 2048^2, with 10 levels so that its coarsest grid
   stays near the 512^2 path's size, with the launch counters at 0
   before it and every kernel launched, and phase 5's ``gather_routes``; right GMRES to rtol 1e-5 by
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
    adv_diff_3d(64) top A, which ``measure`` also times; (b) at 1024^2
    (``Abig``), f32, 10 levels, the phase-7 options with lAIR, strong-R
    dropping and fcf smoothing: solve_device with max_it=10, Richardson
    and right GMRES, each with the launch counters at 0 before it, more
    DIA launches a Richardson iteration than phase 7, the true residual
    by scipy within 10% of the reported one, then one more Richardson
    solve under torch.profiler;
11. same-pattern re-setup: (a) at 512^2, f64, the bench's options and
    depth with ``reuse_sparsity``: every ``reuse_amount`` with and
    without ``reuse_poly_coeffs`` (``PHASE11_SETS``), the generic reuse
    path (plans popped) against the plan re-setup (operators within
    1e-11), ``set_poly_coefficients`` (a fresh setup reproduces the
    history to 1e-12) and ``freeze``; each set up on A512, re-set up on
    its seeded perturbation (``setup(A2, "same")``) and solved by right
    GMRES to rtol 1e-10 on the card and on a CPU twin made after the
    re-setup (phase 10's rule, the DIA kernel launched); (b) at 1024^2,
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
    ``PHASE12_SETS`` at 128^2 (the LU set at ten levels); (b) at 1024^2, f32, phase 11 (b)'s
    PCAIR: plan build, first and warm install of phase 11's matrix
    against its host re-setup + upload, the plan's device bytes and the
    peak device memory, ``solve_device`` with 10 Richardson iterations
    (rtol 1e-5, true residual <= 1e-4, both kernels launched), one
    install under torch.profiler;
13. the device first setup (``setup_device``, air/device_setup.py): (a)
    at 512^2, f64, the bench's options and depth: first and warm setup to
    completion, the level sizes, the synchronisations by level
    (``count_syncs``), every operator a DIA or DELL on the card, right
    GMRES to rtol 1e-10 from x0 = 1 with a zero RHS within 3 iterations
    of a host setup with the same options, the DIA kernel launched; the
    same solve after ``setup_device`` with phase 6's configuration (full
    depth) within 3 iterations of phase 6's; the bench setup at 256^2 on
    the card and on the CPU, held level by level
    (``pflare_tpu_torch/air/setup_compare.py::compare_setups``: markers
    equal, operators and inverses applied to a probe within 1e-12 of
    their largest entry, the polynomial coefficients reported; it stops
    at a decision the two take on a rounding tie and names it), residual
    histories within
    phase 10's rule unless a tie parted them; the same on the
    curved-velocity sibling at 256^2, which has no tie, so card and CPU
    must agree on every level; the option sweep
    ``PHASE13_SETS`` at 64^2, card against CPU; (b) at 2048^2, f32, the
    phase-7 options: first and warm setup to completion against phase
    7's host setup + upload, the peak device memory, the
    synchronisations by level, the level sizes against phase 7's (levels
    within 1, level-0 F fraction within 0.1: the reference's rule),
    ``solve_device`` with 10 Richardson iterations and the counters at 0
    (true residual <= 1e-4, the DIA kernel launched); the form's DELLs on
    the gather kernel (``dell_checks``: each packed by the setup, the
    kernel against ``sell_spmv_plain`` bit for bit in f32 and f64 and
    within 1e-6 / 1e-14 of max |y| of the DELL's gather and row sum,
    ``measure`` on the widest, ``gather_routes``, the solve through its
    graph bit for bit against eager with no DELL packed and the graph's
    kernel nodes equal to the counters); the solve profiled with and
    without graphs (``profile_solve``); one setup under torch.profiler;
14. unstructured meshes: (a) a jittered Delaunay mesh of 2 x 1024^2
    triangles in a scrambled cell order, written as Gmsh 4.1 ASCII,
    read back by ``read_gmsh`` (equal to the mesh written) and assembled
    by ``fv_upwind_advection``; PCAIR with ``a_lump`` and
    ``reorder="auto"`` in f32: host setup + upload (which compacts the
    host hierarchy: ``stats()`` equal before and after, the released
    bytes printed) and ``setup_device``, each timed to completion with
    every level's size and containers, each solved by Richardson to
    rtol 1e-5 (cap 30) with the counters at 0 and then profiled over 10
    Richardson iterations (``profile_solve``): the true residual by
    scipy <= 1e-4, and on the host-built hierarchy the top A banded and
    the banded kernel launched at least once an iteration; the banded
    kernel against its plain version on that top A, which ``measure``
    also times; on the device-built hierarchy phase 13 (b)'s
    ``dell_checks``; (b) the same for ``dg1_upwind_advection`` on 2 x 512^2
    triangles with ``reorder="auto"``, where the solve that must
    converge is right GMRES (its V-cycle diverges as a stationary
    iteration at this size; a Richardson run is printed for the
    record); (d) (b)'s matrix and RHS written in PETSc binary and read
    back bit for bit by ``read_petsc_matrix``, then PCPFLAREINV
    (default, GMRES, 30 its: the residual falls) and PCAIR
    (``setup_device``, right GMRES as in (b)) on what was read; (e)
    the benchmark's 3-D DG(1) operator on 6 x 24^3 tetrahedra
    (``tet_device_built``): ``setup_device`` in f32, whose coarse rows
    hold hundreds of entries packed at 2-16 lanes, right GMRES to 1e-5,
    and ``dell_checks`` on its form with a ``measure`` row for its widest
    multi-lane DELL; (c)
    ``PHASE14_SETS``: the option sets of tests/test_mesh.py on generated
    meshes of 10-50k DoF (FV, DG(1) straight and curved, SUPG with
    diagonally scaled polynomials and diffusion; triangles, tets and a
    twisted-annulus hex mesh) in f64, card against its CPU twin
    (``PCAIR.on`` before the upload): residual histories within phase
    10's rule, the iterations beside the reference's caps;
15. the row mesh (``pflare_tpu_torch.parallel``, every shard on the
    card but in (d)): (a) ``setup(A, mesh=make_mesh(8))`` at 512^2 f64
    against the serial setup, for the bench options and POWER inverses with the
    ideal W (``PHASE15_SETS``): on the curved-velocity sibling, which
    puts no entry on a decision's edge, markers equal on every level, R
    within 1e-11 of its largest entry, every W/Z/AP/RAP product
    row-sharded (``MESH_PRODUCT_LOG``) and equal right GMRES
    iterations at rtol 1e-10; on the main path's matrix the same until
    the two part, each parted row a one-point-W tie (the host's
    products round with FMA, the card's do not); the agglomeration
    schedule and the exchanges printed; (b) phase 7's 2048^2 f32
    hierarchy through ``solve_device(b, max_it=10, mesh=make_mesh(4))``
    against the serial ``solve_device`` (serial, sharded, sharded,
    serial), with the counters at 0 before each: norms within 1e-5 of
    the serial ones, both kernels launched on the shards, every
    ``HaloELL`` operator exchanging with its neighbours alone, the
    exchanges an iteration by level, the DIA and banded shard blocks of
    the top and levels 0-1 against their plain versions, wall and
    device busy time under torch.profiler against the serial solve, a
    level-0 DIA and a banded shard block timed by ``measure``; (c) phase
    14 (a)'s FV hierarchy on 4 shards: the top a ``HaloELL`` on the
    banded kernel, neighbour-only exchanges on the top and the
    repartitioned levels, x within 1e-5 of the serial solve's, the true
    residual <= 1e-4; (d) with two or more cards visible
    (else one line says it did not run), the row mesh over them
    (``phase15d``): (b)'s 2048^2 solve on 4 shards over min(4, cards)
    cards against the one-card mesh and serial (eager; ``jit=True``
    raises there), norms within 1e-5 of serial, each shard's DIA and
    banded blocks on its own card and launched there as often as their
    operator's products, the bytes across cards an iteration by level,
    wall and busy time by card; (a)'s 8-shard 512^2 f64 setup over
    the cards against the one-card mesh: markers equal on every level,
    R within 1e-11, equal right GMRES iterations; and ``shard_ell`` of
    the 2048^2 top A and of its first n/2 columns as f32 ELLs on 4
    shards over the cards against the one-card mesh, given a plain and
    a sharded x: y bit for bit, each card's gather launches;
16. the example and notebook twins (examples/torch/, notebooks/torch/),
    each loaded in this process and run on the card with the launch
    counters at 0 before it (``PHASE16_EXAMPLES``, ``PHASE16_NOTEBOOKS``):
    ex_airg_advection at 1024^2 (f64, right GMRES to rtol 1e-10, the true
    residual by scipy <= 1e-8) and ex_scaling at 256^2, 512^2 and 1024^2
    (<= 6 right GMRES its at rtol 1e-10 each), both launching both
    kernels, each kernel held once against its plain version on their
    hierarchy's level-0 A and level-1 P; the other twins at their JAX
    examples' own sizes; one line per twin with its seconds, iterations
    and its example's own rule (``_twin_rule``);
17. the one-program solve (``PCAIR(jit=)``: CUDA graphs, and the gather
    kernel ``csrc/sell_spmv.cu``), run after phase 16 on phase 5's 512^2
    and phase 7's 2048^2 f32 PCAIRs, kept until then: (a) ``jit=True``
    against ``jit=False`` on each, every run warm and with the launch
    counters at 0 before it: ``apply`` equal bit for bit (and a second
    apply leaves the first's result as it was), ``solve_device`` (10
    Richardson its, with and without x0) x and norms equal bit for bit
    with equal launches, right GMRES to rtol 1e-5 through graphs equal
    bit for bit to the same stationary GMRES run eagerly and in
    iterations to ``jit=False``'s host-driven GMRES; the walls, the
    profiled device busy and idle share of each, the launches an
    iteration and the capture seconds; phase 6's f64 parity GMRES with
    and without graphs within phase 6's history rule; (b) (run at the end
    of phase 12 (b), on its PCAIR, ``install_replay``) an ``install`` of
    new values drops the graphs, and the replayed solve then equals the
    eager solve on the new operators bit for bit; (c) phase 15 (b)'s
    4-shard ``solve_device`` through its graph against eager: x, norms,
    launches and the mesh's exchange log equal; (d) the gather kernel
    against its plain version (``sell_spmv_plain`` over the packed copy),
    bit for bit in f32 and f64, and within 1e-6 (f32) or 1e-14 (f64) of
    max |y| of the container's own plain product, on every TELL operator
    and the coarse inverse's ELL of the 512^2 and 2048^2 hierarchies; the
    bytes of their packed copies and indexes; ``measure`` on the widest
    TELL and on the coarse ELL at each size; (e) a capture that reads the
    host raises.  In
    (a)-(c) every captured program's graph is read back
    (``graph_launches``): the kernel nodes of each of our kernels in it,
    which each replay launches, must equal what a replay adds to the
    launch counters.

Every PCAIR here runs with ``jit=True``, the default: on the card its
solves replay CUDA graphs, so every launch and exchange count of phases
5-16 also checks that a replay counts what an eager run does.  Every
graph is kept (``graphs.KEEP_GRAPHS``) so that phase 17 can read it.

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
# not a Pallas site: the TELL slot loop the reference's jitted solve fuses
# (and the ELL gather and row sum at pflare_tpu/sparse/ell.py:98)
GATHER_SITE = "pflare_tpu/sparse/ell.py:217"
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


def profiled(torch, fn, label):
    """``fn()`` once under torch.profiler, device activity alone (with the
    host ops' events the profiled 2048^2 lAIR fcf solve took 85 s in all
    on the H100's host, 3.4 s of it the solve), to completion: prints its
    wall, device busy and idle share, each kernel's calls and device time
    and the top device ops; returns ({kind: us a call or None}, "wall_s",
    "busy_ms")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pflare_tpu_torch.utils.timers import device_sync_read

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        device_sync_read(*(out if isinstance(out, tuple) else [
            out if torch.is_tensor(out) else out.x]))
        wall = time.perf_counter() - t0
    found = {"dia": [0, 0.0], "banded": [0, 0.0], "sell": [0, 0.0]}
    busy_us = 0.0
    ops = []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:  # kernels, copies, sets
            busy_us += evt.self_device_time_total
            ops.append((evt.self_device_time_total, evt.count, evt.key))
        for kind in found:
            if f"{kind}_spmv_kernel" in evt.key:
                found[kind][0] += evt.count
                found[kind][1] += evt.device_time_total
    print(f"# {label} profiled: wall {wall:.4f} s, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / 1e6 / wall:.1%}; " + ", ".join(
              f"{kind} kernel {c} calls, {t / 1e3:.3f} ms, "
              f"{t / c if c else float('nan'):.2f} us a call"
              for kind, (c, t) in found.items())
          + "; top device ops: " + "; ".join(
              f"{key[:60]} {t / 1e3:.3f} ms in {c}"
              for t, c, key in sorted(ops, reverse=True)[:5]),
          flush=True)
    res = {kind: t / c if c else None for kind, (c, t) in found.items()}
    res["wall_s"], res["busy_ms"] = wall, busy_us / 1e3
    return res


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
    from pflare_tpu_torch.sparse import ell as sell
    from pflare_tpu_torch.utils.timers import device_sync_read

    out, seconds = {}, {}
    stationary, eager = ("stationary", False, jitted), ("eager", True, krylov)
    for path, is_eager, solver in (stationary, eager, eager, stationary):
        tdia.KERNEL_LAUNCHES = 0
        tbanded.KERNEL_LAUNCHES = 0
        sell.KERNEL_LAUNCHES = 0
        reads = solver.HOST_READS
        t0 = time.perf_counter()
        res = pcx.solve(b, eager=is_eager, **kw)
        device_sync_read(res.x)
        seconds.setdefault(path, []).append(time.perf_counter() - t0)
        out[path] = (res, " / ".join(f"{t:.4f}" for t in seconds[path]),
                     solver.HOST_READS - reads,
                     {"dia": tdia.KERNEL_LAUNCHES,
                      "banded": tbanded.KERNEL_LAUNCHES,
                      "sell": sell.KERNEL_LAUNCHES})
    return out


def run_notebook(path, **params):
    """Execute the code cells of a percent-format notebook (``# %%``
    headers) in order in one namespace, with ``params`` assigned just
    after its cell tagged "parameters" (papermill's convention); returns
    the namespace."""
    with open(path) as f:
        lines = f.read().splitlines(keepends=True)
    cells, header, body = [], None, []
    for line in lines + ["# %%\n"]:
        if line.startswith("# %%"):
            if header is not None and "[markdown]" not in header:
                cells.append((header, "".join(body)))
            header, body = line, []
        else:
            body.append(line)
    ns = {"__name__": "__notebook__", "__file__": os.path.abspath(path)}
    for i, (header, src) in enumerate(cells):
        exec(compile(src, f"{path} (cell {i})", "exec"), ns)
        if 'tags=["parameters"]' in header:
            ns.update(params)
    return ns


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
    from pflare_tpu_torch.air.fullspace import coarse_maps
    from pflare_tpu_torch.air.smooth import _place_coarse
    from pflare_tpu_torch.sparse import DELL, DIA, ELL, TELL, BandedSpMV
    from pflare_tpu_torch.sparse import banded as tbanded
    from pflare_tpu_torch.sparse import dia as tdia
    from pflare_tpu_torch.sparse import ell as sell
    from pflare_tpu_torch.utils import graphs
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
    graphs.KEEP_GRAPHS = True   # phase 17 reads every captured graph

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
    err = {"aligned": 0.0, "padded": 0.0, "banded": 0.0, "sell": 0.0}

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
            return tdia.dia_spmv_plain(M.data, M.offsets, x, *M.shape,
                                       M.col_base)
        if isinstance(M, (TELL, ELL, DELL)):
            return sell.sell_spmv_plain(M.packed, x)
        return tbanded.banded_spmv_plain(M.data, M.lcols, x, M.n, M.w, M.W,
                                         M.col_base)

    def copy_op(M, dtype=None):
        """A copy of a device operator in its own storage, in ``dtype``."""
        data = M.data.to(dtype or M.dtype, copy=True)
        if isinstance(M, DIA):
            return DIA(M.offsets, data, M.shape, M.col_base)
        if isinstance(M, (TELL, ELL)):
            return type(M)(M.pattern, data, M.cols.clone())
        if isinstance(M, DELL):
            # packed now (by the index cached on its cols): a capture of
            # its products cannot pack
            D = DELL(data, M.cols, M.n_cols, M.nonzero_slots)
            D.pack()
            return D
        return BandedSpMV(data, M.lcols.clone(), M.n, M.n_cols, M.w, M.W,
                          M.col_base)

    def measure(label, op, kind="plain", coarse=None):
        """Kernel, plain version and the cuSPARSE CSR product ``A @ x`` of
        one operator, each by ``graph_ms``, in the order plain, kernel,
        kernel, plain, library, library (the better of each pair).  The R
        calls take enough copies of the operator in turn to fill twice
        the L2, so the operator comes from device memory, as in a
        V-cycle, while x stays in L2, as it does there.  The bound is the
        larger of bytes = nonzeros * (sizeof T + index bytes, 4 for
        banded, TELL and ELL, 0 for DIA) + (x entries read + n) * sizeof T
        over 3.35 TB/s and 2 FLOPs per nonzero over 67 TFLOP/s: what this
        operator's product needs, not what its layout stores (padded
        slots hold 0 and add nothing).  The x entries read are the
        columns that hold a nonzero.  A gather operator's (TELL, ELL,
        DELL) plain version is ``sell_spmv_plain`` over its packed
        copy.  Stored zeros (the masked A_ff and A_fc of a device-built
        form keep A's slots) are no nonzeros of the product: the bound and
        cuSPARSE's CSR leave them out.

        ``kind`` other than "plain", for a gather operator: the launch
        the V-cycle makes, as ``sparse/ell.py::Fused`` asks it.  An
        epilogue (``ell.EPILOGUES``) reads vectors u (and m, "masked") of
        n rows, each counted once more in the bound; "coarse_out" (R)
        and "coarse_in" (P) run through the copy ``fullspace.coarse_maps``
        makes of each operator copy for the list ``coarse``, and write
        its nc rows or read x of nc entries (the bound's n and x follow).
        Such a row also times, interleaved with the kernel, what the
        V-cycle launched without it (the plain launch, then PyTorch's op,
        gather or scatter) under "separate_ms"; the library row is the
        operator's cuSPARSE product alone."""
        host = op.to_scipy()
        host.eliminate_zeros()
        n, n_cols = op.shape
        T = op.data.element_size()
        banded = isinstance(op, BandedSpMV)
        gather = isinstance(op, (TELL, ELL, DELL))
        fused = kind != "plain"
        require(gather or not fused, f"{label}: {kind} on a "
                f"{type(op).__name__}")
        op_bytes = (op.packed.nbytes if gather else
                    op.data.numel() * (T + (4 if banded else 0)))
        copies = min(R, max(1, math.ceil(2 * L2_BYTES / op_bytes)))
        mats = [op] + [copy_op(op) for _ in range(copies - 1)]
        csrs = [torch.sparse_csr_tensor(
            torch.as_tensor(host.indptr, dtype=torch.int32),
            torch.as_tensor(host.indices, dtype=torch.int32),
            torch.as_tensor(host.data, dtype=op.dtype),
            size=host.shape).to(dev) for _ in range(copies)]

        def vec(k):
            return torch.as_tensor(rng.standard_normal(k), dtype=op.dtype,
                                   device=dev)

        def remapped(M):
            """M's packed copy as the V-cycle's coarse map of it."""
            level = {"coarse": coarse, "mask_f": torch.empty(n, device=dev),
                     "R": M, "P": M}
            mp = coarse_maps([level])[0][kind == "coarse_in"]
            require(mp is not None, f"{label}: no {kind} map")
            return mp

        sells = [remapped(M) for M in mats] if kind in sell.MAPS else []
        x = vec(coarse.shape[0] if kind == "coarse_in" else n_cols)
        x_op = (_place_coarse(x, coarse, n_cols) if kind == "coarse_in"
                else x)
        if fused and kind not in sell.MAPS:
            u, m = vec(n), (vec(n) > 0).to(op.dtype)
        after = {"residual": lambda y: u - y,
                 "masked": lambda y: m * u - y,
                 "correction": lambda y: u + y,
                 "coarse_out": lambda y: y.index_select(0, coarse)}

        if kind in sell.MAPS:
            kernel = [lambda M=M, S=S: M.matvec(sell.Fused(kind, x,
                                                           packed=S))
                      for M, S in zip(mats, sells)]
            plain = [lambda S=S: sell.sell_spmv_plain(S, x) for S in sells]
        elif fused:
            kernel = [lambda M=M: M.matvec(sell.Fused(kind, x, u=u, m=m))
                      for M in mats]
            plain = [lambda M=M: sell.sell_spmv_plain(M.packed, x, kind, u,
                                                      m) for M in mats]
        else:
            kernel = [lambda M=M: M.matvec(x) for M in mats]
            plain = [lambda M=M: plain_matvec(M, x) for M in mats]
        if kind == "coarse_in":
            separate = [lambda M=M: M.matvec(_place_coarse(x, coarse,
                                                           n_cols))
                        for M in mats]
        elif fused:
            separate = [lambda M=M: after[kind](M.matvec(x)) for M in mats]
        library = [lambda C=C: C @ x_op for C in csrs]
        if fused:
            p1, k1, s1, k2, s2, p2, l1, l2 = (graph_ms(torch, f) for f in (
                plain, kernel, separate, kernel, separate, plain, library,
                library))
        else:
            p1, k1, k2, p2, l1, l2 = (graph_ms(torch, f) for f in (
                plain, kernel, kernel, plain, library, library))
        if banded:
            # what make_op would build without the banded container: the
            # plain PyTorch TELL gather (one gather, multiply, add a slot)
            tells = [TELL.from_scipy(host, dtype=op.dtype).to(dev)
                     for _ in range(copies)]
            tell_ms = graph_ms(torch, [
                lambda M=M: sell.tell_spmv_plain(M.data, M.cols, x)
                for M in tells])
        index = 4 if banded or gather else 0
        x_read = int(np.count_nonzero(np.bincount(host.indices,
                                                  minlength=n_cols)))
        rows = coarse.shape[0] if kind == "coarse_out" else n
        vectors = {"residual": n, "masked": 2 * n, "correction": n}.get(
            kind, 0)
        t_bytes = ((host.nnz * (T + index) + (rows + x_read + vectors) * T)
                   / HBM_BYTES_S * 1e3)
        t_ops = 2 * host.nnz / FP32_FLOPS * 1e3
        if gather:
            stored = (f"{op.data.numel()} slots, packed in "
                      f"{op.packed.data.numel()} at {op.packed.lanes} lanes "
                      "a row")
        else:
            stored = f"{op.data.numel()} slots"
        K = (op.K if isinstance(op, DELL) else
             op.pattern.K if gather else op.data.shape[0])
        row = {
            "shape": f"{label}: {type(op).__name__} {n} x {n_cols}, "
                     f"K={K}"
                     + (f", W={op.W}" if banded else "")
                     + f", {host.nnz} nonzeros in {stored}"
                     + (f", {kind} launch" if fused else ""),
            "kind": kind,
            "ms": min(k1, k2), "plain_ms": min(p1, p2),
            "library_ms": min(l1, l2),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "host_launch_ms": eager_ms(torch, kernel[0]),
            "operator_copies": copies,
        }
        if fused:
            row["separate_ms"] = min(s1, s2)
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
              + (f"; TELL plain gather {tell_ms:.6f} ms" if banded else "")
              + (f"; separate launches {row['separate_ms']:.6f} ms (pair "
                 f"{s1:.6f}/{s2:.6f})" if fused else ""))
        return row

    def level0_dia(dhier, prefix):
        """The DIA operators of level 0 (the masked A_ff, A_fc, R, P)."""
        lev = dhier.levels[0]
        found = [(f"{prefix} level 0 {k}", lev[k])
                 for k in ("A_ff", "A_fc", "R", "P")
                 if isinstance(lev[k], DIA)]
        require(found, f"{prefix}: level 0 has no DIA operator")
        return found

    def profile_solve(pcx, bx, label, **kw):
        """One more warm solve (10 Richardson its, ``kw`` to
        ``solve_device``: a mesh) under torch.profiler, twice: with graphs
        (the replay of the solve's CUDA graph, after one solve outside the
        profiler, so that no capture is profiled) and eagerly
        (``jit=False``).  Prints each kernel's calls and device time and
        the device's busy and idle shares for both; returns the graph
        run's ({kind: us a call}, "wall_s", "busy_ms") with the eager
        run's under "eager"."""
        def run():
            return pcx.solve_device(bx, max_it=10, ksp="richardson", **kw)

        device_sync_read(*run())
        out = {}
        for mode, jit in (("graphs", True), ("eager", False)):
            pcx.jit = jit
            try:
                out[mode] = profiled(torch, run, f"{label} ({mode})")
            finally:
                pcx.jit = True
        return {**out["graphs"], "eager": out["eager"]}

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
        "sell": [],     # phase 17 (d)
        "dell": [],     # phases 13 (b) and 14, device-built forms
    }

    # ~~~~~~~~~~ 5. the main path's solve at 512^2 ~~~~~~~~~~
    b = np.random.default_rng(1).standard_normal(A512.shape[0])
    tdia.KERNEL_LAUNCHES = 0
    tbanded.KERNEL_LAUNCHES = 0
    sell.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    x, norms = pc.solve_device(b, max_it=10, ksp="richardson")
    device_sync_read(x, norms)
    t_solve = time.perf_counter() - t0
    norms = norms.cpu().numpy()
    launches = {"dia": tdia.KERNEL_LAUNCHES, "banded": tbanded.KERNEL_LAUNCHES,
                "sell": sell.KERNEL_LAUNCHES}
    print(f"# 512^2 f32 solve_device: {t_solve:.4f} s to completion "
          f"(first call: run, then captured), launches {launches}")
    routes = {"512": gather_routes(torch, pc, b, sell, launches["sell"],
                                   "512^2")}
    require(min(launches.values()) > 0,
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
    host512 = paths64["stationary"][0].iterations
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
    sell.KERNEL_LAUNCHES = 0
    for _ in range(2):
        t0 = time.perf_counter()
        x2k, n2k = pc2k.solve_device(b2k, max_it=10, ksp="richardson")
        device_sync_read(x2k, n2k)
        solve_s.append(time.perf_counter() - t0)
        if len(solve_s) == 1:   # the counts of the first solve alone
            launches2k = {"dia": tdia.KERNEL_LAUNCHES,
                          "banded": tbanded.KERNEL_LAUNCHES,
                          "sell": sell.KERNEL_LAUNCHES}
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
    require(min(launches2k.values()) > 0,
            f"a kernel of the 2048^2 path was not launched: {launches2k}")
    routes["2048"] = gather_routes(torch, pc2k, b2k, sell,
                                   launches2k["sell"], "2048^2")
    host2k = {"setup": t_setup2k, "upload": t_upload2k,
              "n_levels": pc2k.n_levels,
              "levels": [(lv.n, len(lv.fine)) for lv in pc2k.hierarchy.levels]}

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
    # Phases 10 (b), 11 (b) and 12 (b) run at 1024^2: their 2048^2 host
    # setups took most of the command's time limit and swung between calls
    del dh2k, x2k, ops2k, dia_2k     # phase 15 (b) shards pc2k
    A1k = tpf.adv_diff_2d(1024)
    options_runs, t_phase10 = phase10(
        np, sp, torch, tpf, tdia, tbanded, dev, A1k, check, measure, timed,
        profile_solve, setup_breakdown, launches2k["dia"] / 10)
    print(f"# phase 10: {t_phase10:.3f} s")

    # ~~~~~~~~~~ 11. same-pattern re-setup ~~~~~~~~~~
    reuse_runs, t_phase11, handoff = phase11(
        np, sp, torch, tpf, tdia, tbanded, dev, A512, A1k, setup_breakdown)
    print(f"# phase 11: {t_phase11:.3f} s")

    # ~~~~~~~~~~ 12. device re-setup ~~~~~~~~~~
    resetup_runs, t_phase12, install_check = phase12(
        np, sp, torch, tpf, tdia, tbanded, dev, A512, A1k, handoff)
    del handoff, A1k
    print(f"# phase 12: {t_phase12:.3f} s")

    # ~~~~~~~~~~ 13. device first setup ~~~~~~~~~~
    setup_runs, t_phase13, dell_runs = phase13(
        np, sp, torch, tpf, tdia, tbanded, dev, A512, A2k, host512, host2k,
        measure, err, timed, profile_solve)
    print(f"# phase 13: {t_phase13:.3f} s")

    # ~~~~~~~~~~ 14. unstructured meshes ~~~~~~~~~~
    mesh_runs, t_phase14, fv = phase14(np, sp, torch, tpf, tdia, tbanded,
                                       dev, check, measure, timed,
                                       profile_solve, setup_breakdown, err,
                                       dell_runs)
    print(f"# phase 14: {t_phase14:.3f} s")

    # ~~~~~~~~~~ 15. the row mesh ~~~~~~~~~~
    row_mesh, t_phase15, mesh4 = phase15(np, torch, tpf, tdia, tbanded, dev,
                                         A512, pc2k, A2k, b2k, fv, measure,
                                         plain_matvec, profile_solve, err)
    del fv
    print(f"# phase 15: {t_phase15:.3f} s")
    cards = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
    phase15d(np, torch, tpf, tdia, tbanded, dev, cards, A512, pc2k, A2k,
             b2k)

    # ~~~~~~~~~~ 16. the example and notebook twins ~~~~~~~~~~
    twin_runs, t_phase16 = phase16(np, torch, tpf, tdia, tbanded, dev,
                                   plain_matvec, err)
    print(f"# phase 16: {t_phase16:.3f} s")

    # ~~~~~~~~~~ 17. the one-program solve ~~~~~~~~~~
    one_program, t_phase17 = phase17(
        np, torch, tdia, tbanded, sell, dev,
        [("512^2", pc, b, A512), ("2048^2", pc2k, b2k, A2k)],
        (pc64, A512), mesh4, install_check, measure, profile_solve,
        plain_matvec, err, timed)
    del pc2k, A2k, mesh4
    print(f"# phase 17: {t_phase17:.3f} s")

    # last, so that no phase's host timings or memory change with it
    from pflare_tpu_torch.utils.hostmem import tune_host_malloc
    print(f"# tune_host_malloc applied: {tune_host_malloc()} (glibc keeps "
          "large blocks on the heap across setups)")

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
                                 ("device_resetup", resetup_runs),
                                 ("device_setup", setup_runs),
                                 ("unstructured", mesh_runs))},
            "mesh": row_mesh[kind],
            "twins": {name: run["launches"][kind]
                      for name, run in twin_runs.items()},
            "timings": timed[group]})
    kernels.append({
        "name": "sell_spmv", "route": "cuda",
        "source": "pflare_tpu_torch/csrc/sell_spmv.cu",
        "replaces": GATHER_SITE, "launches": launches["sell"],
        "launches_2048": launches2k["sell"],
        "launches_per_iteration": launches2k["sell"] / 10,
        "launches_per_iteration_512": launches["sell"] / 10,
        "launches_by_container": routes,
        "max_abs_err": err["sell"],
        **{k: timed["sell"][0][k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "solve_us_per_call_512": us_512["sell"],
        "solve_us_per_call_2048": us_2048["sell"],
        "launch_floor_ms": floor_ms,
        "one_program": one_program,
        "dell": {label: {k: v for k, v in run.items()
                         if k not in ("timing", "fused_timing",
                                      "multilane_timing")}
                 for label, run in dell_runs.items()},
        "dell_timings": timed["dell"],
        "timings": timed["sell"]})
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


def phase10(np, sp, torch, tpf, tdia, tbanded, dev, Abig, check, measure,
            timed, profile_solve, setup_breakdown, phase7_dia_per_it):
    """The AIR options on the card (see the module docstring, phase 10).
    Returns the 512^2 runs and the ``Abig`` runs ({label: {"launches",
    "iterations"}}) and the phase's seconds."""
    from pflare_tpu_torch.sparse import DIA
    from pflare_tpu_torch.sparse.ops import diag_dominance_ratio
    from pflare_tpu_torch.utils.timers import device_sync_read, reset_timers

    side = math.isqrt(Abig.shape[0])   # Abig is the side^2 grid
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

        # (b) Abig, f32: the phase-7 options with lAIR and fcf smoothing,
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
        pc.setup(Abig.astype(np.float32))
        t_setup = time.perf_counter() - t0
        print(f"# {side}^2 f32 lAIR fcf setup phases: {setup_breakdown()}")
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
    bbig = np.random.default_rng(1).standard_normal(Abig.shape[0])

    def true_residual(x):
        return float(np.linalg.norm(Abig @ x.double().cpu().numpy() - bbig)
                     / np.linalg.norm(bbig))

    zero_counts()
    t0 = time.perf_counter()
    x, norms = pc.solve_device(bbig, max_it=10)
    device_sync_read(x, norms)
    t_solve = time.perf_counter() - t0
    launches = counts()
    norms = norms.cpu().numpy()
    reported, true = float(norms[-1] / norms[0]), true_residual(x)
    # two iterations, above the f32 rounding floor, where the reported
    # residual must be the true one's; after ten both sit at that floor
    # (b - A x in f32 rounds to ~1e-7 of ||b||), where they differ
    x2, norms2 = pc.solve_device(bbig, max_it=2)
    reported2 = float(norms2[-1] / norms2[0])
    true2 = true_residual(x2)
    print(f"# {side}^2 f32 lAIR fcf: {pc.n_levels} levels "
          f"{[lv.n for lv in pc.hierarchy.levels]}, host setup "
          f"{t_setup:.3f} s, upload {t_upload:.3f} s, solve_device 10 "
          f"Richardson its {t_solve:.4f} s to completion, relative residual "
          f"{reported:.6e} reported, {true:.6e} true (scipy, f64); after 2 "
          f"its {reported2:.6e} reported, {true2:.6e} true; launches "
          f"{launches}, DIA launches an iteration {launches['dia'] / 10:.1f} "
          f"(phase 7: {phase7_dia_per_it:.1f}), relative norms "
          f"{np.array2string(norms / norms[0], precision=3)}")
    require(np.isfinite(norms).all() and abs(true2 - reported2)
            <= 0.1 * reported2, f"{side}^2 lAIR fcf: true residual {true2:.3e}"
            f" against {reported2:.3e} reported after 2 its")
    require(abs(true - reported) <= 0.1 * reported
            or max(true, reported) <= F32_FLOOR, f"{side}^2 lAIR fcf: true "
            f"residual {true:.3e} against {reported:.3e} reported")
    require(launches["dia"] / 10 > phase7_dia_per_it, f"{side}^2 lAIR fcf: "
            f"{launches['dia'] / 10} DIA launches an iteration, not more "
            f"than phase 7's {phase7_dia_per_it}")
    runs[f"{side} lair fcf"] = {"launches": launches, "iterations": 10}

    # right GMRES on the device (gmres_right_fixed) on the same hierarchy
    zero_counts()
    t0 = time.perf_counter()
    x, norms = pc.solve_device(bbig, max_it=10, ksp="gmres")
    device_sync_read(x, norms)
    t_solve = time.perf_counter() - t0
    launches = counts()
    norms = norms.cpu().numpy()
    x2, norms2 = pc.solve_device(bbig, max_it=2, ksp="gmres")
    reported2 = float(norms2[-1] / norms2[0])
    true2 = true_residual(x2)
    print(f"# {side}^2 f32 lAIR fcf: solve_device 10 right GMRES its "
          f"{t_solve:.4f} s to completion, relative residual "
          f"{norms[-1] / norms[0]:.6e} reported, {true_residual(x):.6e} true; "
          f"after 2 its {reported2:.6e} reported, {true2:.6e} true; launches "
          f"{launches}, relative norms "
          f"{np.array2string(norms / norms[0], precision=3)}")
    require(np.isfinite(norms).all() and abs(true2 - reported2)
            <= 0.1 * reported2, f"{side}^2 lAIR fcf GMRES: true residual "
            f"{true2:.3e} against {reported2:.3e} reported after 2 its")
    require(launches["dia"] > 0 and launches["banded"] > 0, f"{side}^2 lAIR "
            f"fcf GMRES: a kernel was not launched: {launches}")
    runs[f"{side} lair fcf gmres"] = {"launches": launches, "iterations": 10}
    t0 = time.perf_counter()
    profile_solve(pc, bbig, f"{side}^2 lAIR fcf")
    print(f"# {side}^2 lAIR fcf: profiled solve and its tables "
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


def phase11(np, sp, torch, tpf, tdia, tbanded, dev, A512, Abig,
            setup_breakdown):
    """Same-pattern re-setup on the host (see the module docstring, phase
    11).  Returns the runs ({label: {"launches", "iterations"}}) and the
    phase's seconds."""
    from pflare_tpu_torch.utils.timers import (device_sync_read, get_timers,
                                               reset_timers)

    side = math.isqrt(Abig.shape[0])   # Abig is the side^2 grid
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

        # (b) Abig, f32 solve of a hierarchy set up from the f64 matrix
        # (the plan re-setup computes in f64, as the reference's does)
        print(f"# phase 11 (b) starts: {host_gib()}", flush=True)
        opts = bench_options(tpf, max_levels=10).replace(
            reuse_sparsity=True, reuse_amount=3, reuse_poly_coeffs=True)
        pc = tpf.PCAIR(opts, dtype=torch.float32, device=dev)
        reset_timers()
        t0 = time.perf_counter()
        pc.setup(Abig)
        t_first = time.perf_counter() - t0
        first_split = setup_breakdown()
        Abig2 = perturbed(np, Abig, 6)
        reset_timers()
        t0 = time.perf_counter()
        pc.setup(Abig2, "same")
        t_re = time.perf_counter() - t0
        fast = sum("host_fast" in lv.patterns for lv in pc.hierarchy.levels)
        t0 = time.perf_counter()
        dh = pc.upload()
        torch.cuda.synchronize()
        t_upload = time.perf_counter() - t0
        require(dh.top.dtype == torch.float32 and all(
            lev[k].dtype == torch.float32 for lev in dh.levels
            for k in ("A_ff", "A_fc", "R", "P")), f"{side}^2 reuse: the "
            "upload is not float32")
        bbig = np.random.default_rng(1).standard_normal(Abig.shape[0])
        zero_counts()
        t0 = time.perf_counter()
        x, norms = pc.solve_device(bbig, max_it=10, ksp="richardson")
        device_sync_read(x, norms)
        t_solve = time.perf_counter() - t0
        launches = counts()
        norms = norms.cpu().numpy()
        its = _converged_at(np, norms, 1e-5)
        true = float(np.linalg.norm(Abig2 @ x.double().cpu().numpy() - bbig)
                     / np.linalg.norm(bbig))
        print(f"# {side}^2 after the re-setup: {host_gib()}")
        print(f"# {side}^2 reuse amount 3 (f64 setup, f32 solve): first "
              f"setup {t_first:.3f} s ({first_split}), re-setup {t_re:.3f} "
              f"s ({resetup_split()}), {t_first / t_re:.2f}x, {fast} of "
              f"{len(pc.hierarchy.levels)} levels by plans; upload "
              f"{t_upload:.3f} s; solve_device 10 Richardson its "
              f"{t_solve:.4f} s, rtol 1e-5 at iteration {its}, true "
              f"residual {true:.3e}, launches {launches}")
        require(fast == len(pc.hierarchy.levels), f"{side}^2: a level was not "
                "re-set up by its plans")
        require(its is not None and true <= 1e-4 and np.isfinite(norms).all(),
                f"{side}^2 reuse: did not converge ({true:.3e})")
        require(launches["dia"] > 0 and launches["banded"] > 0,
                f"{side}^2 reuse: a kernel was not launched: {launches}")
        runs[f"{side} reuse amount 3"] = {"launches": launches,
                                       "iterations": 10}
        handoff = {"pc": pc, "A2": Abig2, "host_s": t_re + t_upload}
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
    # ten levels: a 575-row coarse matrix, where five leave 3,874 rows,
    # whose Gauss-Jordan the CPU twin takes minutes over
    ("LU coarse", dict(coarsest_inverse_type="LU", max_levels=10)),
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


def phase12(np, sp, torch, tpf, tdia, tbanded, dev, A512, Abig, handoff):
    """The device re-setup (see the module docstring, phase 12).  Returns
    the runs ({label: {"launches", "iterations"}}), the phase's seconds
    and phase 17 (b)'s check (``install_replay``), which runs on (b)'s
    PCAIR."""
    from pflare_tpu_torch.sparse import BandedSpMV
    from pflare_tpu_torch.utils.timers import count_syncs, device_sync_read

    side = math.isqrt(Abig.shape[0])   # Abig is the side^2 grid
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
        o = tpf.AIROptions().replace(**({"reuse_sparsity": True,
                                         "reuse_amount": 3,
                                         "reuse_poly_coeffs": True,
                                         "max_levels": 5} | set_kw))
        pcs = tpf.PCAIR(o, dtype=torch.float64, device=dev).setup(A128)
        cpu = pcs.on("cpu")
        (dh, n_s) = count_syncs(pcs.build_device_resetup(), A128_2)
        dh_cpu = cpu.build_device_resetup()(A128_2)
        diff, where = max_rel_diff(np, dh.to_scipy(), dh_cpu.to_scipy())
        print(f"# 128^2 f64 device re-setup plan, {label}: card against CPU "
              f"{diff:.3e} ({where}), synchronisations {n_s}")
        # the segment sums, the constraints' sums and a dense coarse
        # inverse add in the CPU's order on the card; the SVD least
        # squares of lAIR and SAI round otherwise
        require(diff <= 1e-11, f"128^2 {label}: the card's plan differs from "
                f"the CPU's by {diff:.3e} at {where}")
    t_a = time.perf_counter() - t_phase

    # (b) Abig, f32: phase 11 (b)'s PCAIR and matrix
    pc, Abig2 = handoff["pc"], handoff["A2"]
    torch.cuda.reset_peak_memory_stats()
    plan, t_plan = timed(pc.build_device_resetup)
    _, t_install = timed(plan.install, pc, Abig2)
    _, t_warm = timed(plan.install, pc, Abig2)
    _, n_sync = count_syncs(plan.install, pc, Abig2)
    peak = torch.cuda.max_memory_allocated()
    bbig = np.random.default_rng(1).standard_normal(Abig.shape[0])
    zero_counts()
    t0 = time.perf_counter()
    x, norms = pc.solve_device(bbig, max_it=10, ksp="richardson")
    device_sync_read(x, norms)
    t_solve = time.perf_counter() - t0
    launches = counts()
    norms = norms.cpu().numpy()
    its = _converged_at(np, norms, 1e-5)
    true = float(np.linalg.norm(Abig2 @ x.double().cpu().numpy() - bbig)
                 / np.linalg.norm(bbig))
    print(f"# {side}^2 f32 device re-setup: plan {t_plan:.3f} s "
          f"({plan.device_bytes / 1e9:.3f} GB on the card), install "
          f"{t_install:.4f} s first / {t_warm:.4f} s warm, against host "
          f"re-setup + upload {handoff['host_s']:.3f} s "
          f"({handoff['host_s'] / t_warm:.1f}x); peak device memory "
          f"{peak / 1e9:.3f} GB; synchronisations in one install {n_sync}; "
          f"solve_device 10 Richardson its {t_solve:.4f} s, rtol 1e-5 at "
          f"iteration {its}, true residual {true:.3e}, launches {launches}; "
          f"{host_gib()}")
    require(its is not None and true <= 1e-4 and np.isfinite(norms).all(),
            f"{side}^2 device re-setup: did not converge ({true:.3e})")
    require(launches["dia"] > 0 and launches["banded"] > 0,
            f"{side}^2 device re-setup: a kernel was not launched: {launches}")
    runs[f"{side} device re-setup"] = {"launches": launches, "iterations": 10}
    install_check = install_replay(np, torch, pc, plan, Abig2, bbig, norms)

    # one warm install under the profiler, device activity alone
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, t_prof = timed(plan.install, pc, Abig2)
    busy_us, ops = 0.0, []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            busy_us += evt.self_device_time_total
            ops.append((evt.self_device_time_total, evt.count, evt.key))
    ops.sort(reverse=True)
    print(f"# {side}^2 f32 profiled install: wall {t_prof:.4f} s, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / 1e6 / t_prof:.1%}; top device ops: " + "; ".join(
              f"{key[:60]} {t / 1e3:.3f} ms in {c}" for t, c, key in ops[:6]))
    print(f"# phase 12 (a) {t_a:.3f} s, (b) "
          f"{time.perf_counter() - t_phase - t_a:.3f} s")
    del pc, plan, x
    return runs, time.perf_counter() - t_phase, install_check


def graph_launches(pcx, label):
    """Every captured program of ``pcx``: the kernel nodes of each of our
    kernels in its graph (``Program.graph_kernels``, read from the kept
    graph: what each replay launches) against what each replay adds to
    the launch counters (``Program.counted``); they must be equal.
    Returns the programs' nodes summed by kernel."""
    total = {}
    for key, prog in pcx._programs.items():
        nodes, counted = prog.graph_kernels(), prog.counted()
        require(nodes == counted, f"{label} program {key[:4]}: its graph "
                f"launches {nodes}, a replay counts {counted}")
        for kernel, c in nodes.items():
            total[kernel] = total.get(kernel, 0) + c
    require(len(pcx._programs) > 0, f"{label}: no program was captured")
    print(f"# {label}: the graphs of {len(pcx._programs)} programs launch "
          f"what their replays count: {total} kernel nodes", flush=True)
    return total


def gather_routes(torch, pcx, bx, sell, launched, label):
    """The gather kernel's launches by container in an eager
    (``jit=False``) ``solve_device`` of 10 Richardson its, one ``apply``
    and a stationary right GMRES (rtol 1e-5, at most 30 its): each TELL,
    ELL and DELL of the device form has its ``matvec`` wrapped for the
    runs, and each call must launch the kernel exactly once (so no
    container runs an index_select gather and row sum).  Every gather
    container kind of the form must launch it in the solve, and together
    as often as the counted solve before (``launched``).  Returns {kind:
    launches an iteration of the solve} with, under "apply" and "gmres",
    the launches by kind of the apply and an iteration of GMRES."""
    from pflare_tpu_torch.solvers.jitted import gmres_stationary
    from pflare_tpu_torch.sparse import DELL, ELL, TELL
    from pflare_tpu_torch.utils.timers import device_sync_read

    calls = {"TELL": 0, "ELL": 0, "DELL": 0}
    wrapped = []

    def wrap(op):
        inner = op.matvec

        def matvec(x):
            before = sell.KERNEL_LAUNCHES
            y = inner(x)
            require(sell.KERNEL_LAUNCHES == before + 1,
                    f"{label}: a {type(op).__name__} product launched "
                    f"{sell.KERNEL_LAUNCHES - before} gather kernels")
            calls[type(op).__name__] += 1
            return y

        op.matvec = matvec
        wrapped.append(op)

    dh = pcx.upload()
    for _, op in _device_ops(dh):
        if isinstance(op, (TELL, ELL, DELL)):
            wrap(op)
    kinds = {type(op).__name__ for op in wrapped}
    runs = {}
    pcx.jit = False
    try:
        for what in ("solve", "apply", "gmres"):
            for k in calls:
                calls[k] = 0
            if what == "solve":
                device_sync_read(*pcx.solve_device(bx, max_it=10,
                                                   ksp="richardson"))
                its = 10
            elif what == "apply":
                device_sync_read(pcx.apply(bx))
                its = 1
            else:
                bi = pcx._to_internal(pcx._vector(bx))
                _, its, _, _ = gmres_stationary(
                    dh.top.matvec, pcx._precond(dh), bi, None, 1e-5, 1e-50,
                    30, 30, "right")
                its = max(int(its), 1)
            runs[what] = {k: calls[k] / its for k in sorted(kinds)}
            if what == "solve":
                total = sum(calls.values())
                require(kinds and all(calls[k] > 0 for k in kinds)
                        and total == launched,
                        f"{label}: gather kernel launches by container "
                        f"{calls}, {launched} counted in the solve before")
    finally:
        pcx.jit = True
        for op in wrapped:
            del op.matvec
    print(f"# {label}: every gather product launched the gather kernel "
          f"once; launches an iteration of solve_device by container "
          f"{runs['solve']}, in one apply {runs['apply']}, an iteration of "
          f"stationary right GMRES {runs['gmres']}", flush=True)
    return {**runs["solve"], "apply": runs["apply"], "gmres": runs["gmres"]}


def dell_checks(np, torch, pcx, bx, label, measure, err):
    """The DELLs of a device-built solve form on the gather kernel: every
    one packed by the setup; its product, in its own dtype and in the
    other of f32 and f64 (a copy, packed as the setup packs), launches the
    kernel once and equals
    ``sell_spmv_plain`` over the packed copy bit for bit, within 1e-6
    (f32) or 1e-14 (f64) of max |y| of the DELL's plain gather and row
    sum; each DELL's product with each epilogue (``ell.Fused``) equal to
    ``sell_spmv_plain`` with it bit for bit; each level's R and P
    through their coarse maps (``DeviceHierarchy.coarse_maps``, one for
    every DELL R and P) equal to the plain launch followed by
    ``index_select`` or preceded by ``_place_coarse`` bit for bit;
    ``measure`` on the widest DELL (most stored slots) plain and with
    each epilogue, on the widest DELL packed at two or more lanes a row
    plain (where it is not the widest), and on level 0's R and P through
    their maps; a counted
    ``solve_device`` (10 Richardson its, replayed), with the share of its
    gather launches that carried an epilogue or a coarse map
    (``ell.EPILOGUE_LAUNCHES``), and ``gather_routes``;
    the solve through its graph equal to the eager one bit for bit, no
    DELL packed in either, and the graphs' kernel nodes equal to the
    counters (``graph_launches``).  Returns the numbers, with the timing
    rows under "timing" (the widest DELL's plain product),
    "fused_timing" and "multilane_timing" (None where no DELL has two
    lanes)."""
    from pflare_tpu_torch.air.device_setup import solve_form_dells
    from pflare_tpu_torch.air.smooth import _place_coarse
    from pflare_tpu_torch.sparse import DELL
    from pflare_tpu_torch.sparse import dell as tdell
    from pflare_tpu_torch.sparse import ell as sell
    from pflare_tpu_torch.utils.timers import device_sync_read

    dev = pcx.device
    dells = solve_form_dells(pcx.upload())
    require(dells and all(M._packed is not None for M in dells),
            f"{label}: the device-built form has no DELL, or one unpacked")
    rng = np.random.default_rng(14)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    other = {torch.float32: torch.float64, torch.float64: torch.float32}
    copies = [DELL(M.data.to(other[M.dtype]), M.cols, M.n_cols,
                   M.nonzero_slots) for M in dells]
    tdell.pack_dells(copies)
    for D in dells + copies:
        dtype = D.dtype
        x = torch.as_tensor(rng.standard_normal(D.n_cols), dtype=dtype,
                            device=dev)
        before = sell.KERNEL_LAUNCHES
        y = D.matvec(x)
        ref = sell.sell_spmv_plain(D.packed, x)
        own = tdell.dell_spmv_plain(D, x)
        torch.cuda.synchronize()
        require(sell.KERNEL_LAUNCHES == before + 1,
                f"{label}: a DELL product launched "
                f"{sell.KERNEL_LAUNCHES - before} gather kernels")
        require(torch.equal(y, ref), f"{label} {dtype}: the gather "
                f"kernel differs from its plain version on a DELL of "
                f"{D.shape[0]} rows by {float((y - ref).abs().max()):.3e}")
        gap = float((y - own).abs().max()
                    / max(float(own.abs().max()), 1e-300))
        require(gap <= {torch.float32: 1e-6, torch.float64: 1e-14}[dtype],
                f"{label} {dtype}: the kernel is {gap:.3e} of max |y| "
                "from the DELL's gather and row sum")
        worst[dtype] = max(worst[dtype], gap)
        err["sell"] = max(err["sell"], float((y - ref).abs().max()))
    for D in dells:
        n = D.shape[0]
        x, u = (torch.as_tensor(rng.standard_normal(k), dtype=D.dtype,
                                device=dev) for k in (D.n_cols, n))
        m = (torch.as_tensor(rng.standard_normal(n), device=dev) > 0).to(
            D.dtype)
        for kind in ("residual", "masked", "correction"):
            before = dict(sell.EPILOGUE_LAUNCHES)
            y = D.matvec(sell.Fused(kind, x, u=u, m=m))
            ref = sell.sell_spmv_plain(D.packed, x, kind, u, m)
            require(torch.equal(y, ref), f"{label} {D.dtype}: the {kind} "
                    f"epilogue differs from its plain version on a DELL of "
                    f"{n} rows by {float((y - ref).abs().max()):.3e}")
            require(sell.EPILOGUE_LAUNCHES[kind] == before.get(kind, 0) + 1,
                    f"{label}: a {kind} launch was not counted once")
    dh = pcx.upload()
    require(dh.coarse_maps is not None, f"{label}: no coarse maps")
    mapped = {"R": 0, "P": 0}
    for i, (lev, pair) in enumerate(zip(dh.levels, dh.coarse_maps)):
        coarse, n = lev["coarse"], lev["mask_f"].shape[0]
        for side, M, mp in (("R", lev["R"], pair[0]), ("P", lev["P"],
                                                       pair[1])):
            require(mp is not None or not isinstance(M, DELL),
                    f"{label}: level {i} {side}, a DELL, has no coarse map")
            if mp is None:
                continue
            v = torch.as_tensor(rng.standard_normal(mp.shape[1]),
                                dtype=M.dtype, device=dev)
            if side == "R":
                y = M.matvec(sell.Fused("coarse_out", v, packed=mp))
                ref = M.matvec(v).index_select(0, coarse)
            else:
                y = M.matvec(sell.Fused("coarse_in", v, packed=mp))
                ref = M.matvec(_place_coarse(v, coarse, n))
            require(torch.equal(y, ref), f"{label}: level {i} {side} through "
                    f"its coarse map differs from the plain launch with the "
                    f"separate {'gather' if side == 'R' else 'scatter'} by "
                    f"{float((y - ref).abs().max()):.3e}")
            mapped[side] += 1
    nnz = sum(int((M.cols < tdell.PADCOL).sum()) for M in dells)
    # the masked A_ff and A_fc keep all of A's slots, zeroed outside
    # their blocks, and pack their nonzeros alone (``nonzero_slots``)
    nonzero = sum(int(((M.cols < tdell.PADCOL) & (M.data != 0)).sum())
                  for M in dells)
    slots = sum(M.data.numel() for M in dells)
    packed = sum(M.packed.data.numel() for M in dells)
    zeros = sum(int(((M.packed.data == 0) & (M.packed.index.src >= 0)).sum())
                for M in dells)
    masked = sum(M.nonzero_slots for M in dells)
    print(f"# {label}: the gather kernel equals its plain version bit for "
          f"bit in f32 and f64 on the form's {len(dells)} DELLs ({masked} "
          f"packing their nonzeros alone; {nnz} live slots, {nonzero} of "
          f"them nonzero, in {slots} slots; packed in {packed}, {zeros} "
          f"packed live slots zero), within "
          f"{worst[torch.float32]:.3e} / {worst[torch.float64]:.3e} of max "
          "|y| of their gather and row sum; each epilogue equals its "
          f"plain version bit for bit; {mapped['R']} R and {mapped['P']} P "
          "through their coarse maps equal the plain launch with the "
          "separate gather or scatter bit for bit", flush=True)
    widest = max(dells, key=lambda M: M.data.numel())
    names = {id(op): lab for lab, op in _device_ops(dh)}
    what = f"{label} widest DELL ({names.get(id(widest), '?')})"
    timing = measure(what, widest)
    fused_timing = [measure(what, widest, kind)
                    for kind in ("residual", "masked", "correction")]
    multi = max((M for M in dells if M.packed.lanes > 1),
                key=lambda M: M.data.numel(), default=None)
    multilane = None
    if multi is not None:
        multilane = timing if multi is widest else measure(
            f"{label} widest multi-lane DELL ({names.get(id(multi), '?')})",
            multi)
    lev0, (R_map, P_map) = dh.levels[0], dh.coarse_maps[0]
    for kind, M, mp in (("coarse_out", lev0["R"], R_map),
                        ("coarse_in", lev0["P"], P_map)):
        if mp is not None:
            fused_timing.append(measure(
                f"{label} level 0 {'R' if kind == 'coarse_out' else 'P'}",
                M, kind, lev0["coarse"]))
    sell.KERNEL_LAUNCHES = 0
    sell.EPILOGUE_LAUNCHES.clear()
    device_sync_read(*pcx.solve_device(bx, max_it=10, ksp="richardson"))
    launched = sell.KERNEL_LAUNCHES
    fused = dict(sell.EPILOGUE_LAUNCHES)
    fused_pct = sum(fused.values()) / max(launched, 1) * 100
    print(f"# {label}: {launched / 10} gather launches an iteration of "
          f"solve_device, {fused_pct:.1f}% of them with an epilogue or a "
          f"coarse map, by kind {fused}", flush=True)
    routes = gather_routes(torch, pcx, bx, sell, launched, label)
    packs = tdell.PACKS
    pcx.jit = True
    g = pcx.solve_device(bx, max_it=10, ksp="richardson")
    pcx.jit = False
    try:
        e = pcx.solve_device(bx, max_it=10, ksp="richardson")
    finally:
        pcx.jit = True
    require(all(bool(torch.equal(u, v)) for u, v in zip(g, e)),
            f"{label}: solve_device through its graph is not the eager "
            "solve bit for bit")
    require(tdell.PACKS == packs, f"{label}: {tdell.PACKS - packs} DELLs "
            "packed during the solves")
    nodes = graph_launches(pcx, label)
    return {"dells": len(dells), "live_slots": nnz, "nonzeros": nonzero,
            "packed_zero_slots": zeros, "slots": slots, "packed": packed,
            "launches_per_iteration": launched / 10,
            "fused_launches": fused, "fused_pct": fused_pct,
            "coarse_maps": mapped, "routes": routes,
            "graph_kernel_nodes": nodes, "timing": timing,
            "fused_timing": fused_timing, "multilane_timing": multilane}


def install_replay(np, torch, pc, plan, A_old, b, norms_old):
    """Phase 17 (b), run at the end of phase 12 (b) on its PCAIR: an
    ``install`` of new values drops the CUDA graphs of the old operators
    (the graph cache is empty after it); the first solve after it runs
    eagerly and captures, the second replays, and the replay equals, bit
    for bit, an eager solve (``jit=False``) on the new operators, whose
    norms differ from the old operators' ``norms_old``; the replayed
    graph launches what the counters count (``graph_launches``)."""
    from pflare_tpu_torch.utils.timers import device_sync_read

    t0 = time.perf_counter()
    A_new = perturbed(np, A_old, 12)
    plan.install(pc, A_new)
    require(len(pc._programs) == 0, "install left CUDA graphs of the old "
            "operators in place")
    pc.jit = True
    pc.solve_device(b, max_it=10)
    t1 = time.perf_counter()
    x_g, n_g = pc.solve_device(b, max_it=10)
    device_sync_read(x_g, n_g)
    t_g = time.perf_counter() - t1
    pc.jit = False
    t1 = time.perf_counter()
    x_e, n_e = pc.solve_device(b, max_it=10)
    device_sync_read(x_e, n_e)
    t_e = time.perf_counter() - t1
    pc.jit = True
    n_g, n_e = n_g.cpu().numpy(), n_e.cpu().numpy()
    equal = bool(torch.equal(x_g, x_e)) and np.array_equal(n_g, n_e)
    fresh = not np.array_equal(n_e, norms_old)
    true = float(np.linalg.norm(A_new @ x_g.double().cpu().numpy() - b)
                 / np.linalg.norm(b))
    out = {"equal": equal, "fresh": fresh, "true_residual": true,
           "replay_s": t_g, "eager_s": t_e,
           "graph_kernel_nodes": graph_launches(pc, "phase 17 (b)"),
           "seconds": time.perf_counter() - t0}
    print(f"# phase 17 (b) install on new values: the replay equals the "
          f"eager solve on the new operators bit for bit: {equal}; its "
          f"norms differ from the old operators': {fresh}; true residual "
          f"{true:.3e}; warm wall replay {t_g:.4f} s, eager {t_e:.4f} s")
    require(equal and fresh, "phase 17 (b): the solve after install is not "
            "the eager solve on the new operators")
    require(true <= 1e-4, f"phase 17 (b): true residual {true:.3e}")
    return out


# (label, options, input) of phase 13's option sweep at 64^2, card against
# CPU: the reference's device configurations
# (tests/test_device_setup.py:176-206, 289-320)
PHASE13_SETS = (
    ("PMIS", dict(cf_splitting_type="PMIS", max_levels=5), "scipy"),
    ("PMIS_DIST2", dict(cf_splitting_type="PMIS_DIST2", max_levels=5),
     "scipy"),
    ("CR", dict(cf_splitting_type="CR", strong_threshold=0.5, max_levels=4),
     "scipy"),
    ("lAIR", dict(z_type="LAIR", a_drop=1e-4, max_levels=4), "scipy"),
    ("SAI-lAIR", dict(z_type="LAIR_SAI", a_drop=1e-4, max_levels=4),
     "scipy"),
    ("strong R", dict(strong_r_threshold=0.01, a_drop=1e-4, max_levels=4),
     "scipy"),
    ("improve_z", dict(improve_z_its=2, a_drop=1e-4, max_levels=4), "scipy"),
    ("auto-truncated", dict(max_levels=10, auto_truncate_start_level=3,
                            auto_truncate_tol=0.5,
                            coarsest_inverse_type="NEWTON",
                            coarsest_poly_order=12,
                            coarsest_matrix_free_polys=True), "scipy"),
    ("DELL input", dict(max_levels=4), "DELL"),
)


def phase13(np, sp, torch, tpf, tdia, tbanded, dev, A512, A2k, host512,
            host2k, measure, err, timed, profile_solve):
    """The device first setup on the card (see the module docstring,
    phase 13).  ``host512``: phase 6's right-GMRES iterations; ``host2k``:
    phase 7's host setup and upload seconds and level sizes.  Returns the
    runs ({label: {"launches", "iterations"}}), the phase's seconds and
    (b)'s ``dell_checks``."""
    from pflare_tpu_torch.air.setup_compare import (LevelMatrices,
                                                    compare_setups,
                                                    setup_levels)
    from pflare_tpu_torch.sparse import DELL, DIA
    from pflare_tpu_torch.sparse import ell as sell
    from pflare_tpu_torch.utils.timers import count_syncs, device_sync_read

    t_phase = time.perf_counter()

    def counts():
        return {"dia": tdia.KERNEL_LAUNCHES, "banded": tbanded.KERNEL_LAUNCHES,
                "sell": sell.KERNEL_LAUNCHES}

    def zero_counts():
        tdia.KERNEL_LAUNCHES = 0
        tbanded.KERNEL_LAUNCHES = 0
        sell.KERNEL_LAUNCHES = 0

    def timed_setup(pc, A):
        t0 = time.perf_counter()
        pc.setup_device(A)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def on_card(pc):
        """Every operator of the device-built solve form lies on the card
        as a DIA or DELL: no host CSR, no upload."""
        dh = pc.upload()
        ops = [dh.top, dh.coarse_inv.mat] + [
            op for lev in dh.levels for op in lev.values()
            if not isinstance(op, torch.Tensor)]
        ops += [lev["inv_Aff"].mat for lev in dh.levels]
        for op in ops:
            if op is None or isinstance(op, torch.Tensor):
                continue
            if hasattr(op, "kind"):       # the level's Inverse
                op = op.mat if op.kind != "diagonal" else None
                if op is None:
                    continue
            require(isinstance(op, (DIA, DELL)) and op.data.is_cuda,
                    f"a device-built operator is a {type(op).__name__} on "
                    f"{getattr(op.data, 'device', '?')}")
        return dh

    def syncs_by_level(pc, A):
        _, total = count_syncs(pc.setup_device, A)
        h = pc.hierarchy
        return [lvl.syncs for lvl in h.levels] + [h.coarse_syncs], total

    runs = {}
    # (a) 512^2, f64, the bench's options and depth
    opts = bench_options(tpf)
    pc = tpf.PCAIR(opts, dtype=torch.float64, device=dev)
    t_first = timed_setup(pc, A512)
    t_warm = timed_setup(pc, A512)
    per_level, total = syncs_by_level(pc, A512)
    h = pc.hierarchy
    on_card(pc)
    print(f"# 512^2 f64 setup_device: {t_first:.3f} s first / {t_warm:.3f} s "
          f"warm to completion, {h.n_levels} levels, (n, n_f, n_c) "
          f"{[(lv.n, lv.n_f, lv.n_c) for lv in h.levels]}, coarse "
          f"{h.coarse_A.shape[0]} rows; synchronisations {total} (by level "
          f"{per_level}, the last the coarse inverse and layouts)")
    n = A512.shape[0]
    kw = dict(x0=np.ones(n), rtol=1e-10, atol=1e-50, max_it=60, side="right")
    host = tpf.PCAIR(opts, dtype=torch.float64, device=dev).setup(A512)
    hres = host.solve(np.zeros(n), **kw)
    zero_counts()
    t0 = time.perf_counter()
    res = pc.solve(np.zeros(n), **kw)
    device_sync_read(res.x)
    t_solve = time.perf_counter() - t0
    launches = counts()
    true = float(np.linalg.norm(A512 @ res.x.cpu().numpy())
                 / np.linalg.norm(A512 @ np.ones(n)))
    print(f"# 512^2 f64 setup_device parity solve: right GMRES "
          f"{res.iterations} its (host setup, same options: "
          f"{hres.iterations}; phase 6, full depth: {host512}), "
          f"||Ax||/||A1|| {true:.3e}, {t_solve:.4f} s, launches {launches}, "
          f"DIA {launches['dia'] / max(res.iterations, 1):.2f} an iteration")
    require(res.converged and res.iterations <= hres.iterations + 3,
            f"512^2 setup_device: {res.iterations} right GMRES its against "
            f"{hres.iterations} (host, same options)")
    require(launches["dia"] > 0, "512^2 setup_device: no DIA launch")
    runs["512 setup_device gmres"] = {"launches": launches,
                                      "iterations": res.iterations}
    del pc, host, h
    # phase 6's configuration (full depth), against phase 6's host setup
    pc = tpf.PCAIR(tpf.AIROptions(a_lump=True, a_drop=1e-5,
                                  strong_threshold=0.99),
                   dtype=torch.float64, device=dev)
    t_full = timed_setup(pc, A512)
    zero_counts()
    res = pc.solve(np.zeros(n), **kw)
    launches = counts()
    true = float(np.linalg.norm(A512 @ res.x.cpu().numpy())
                 / np.linalg.norm(A512 @ np.ones(n)))
    print(f"# 512^2 f64 setup_device, phase 6's configuration: "
          f"{pc.n_levels} levels, setup {t_full:.3f} s to completion, right "
          f"GMRES {res.iterations} its (phase 6's host setup: {host512}), "
          f"||Ax||/||A1|| {true:.3e}, launches {launches}")
    require(res.converged and res.iterations <= host512 + 3
            and true <= 1e-8, f"512^2 setup_device, phase 6's "
            f"configuration: {res.iterations} its against {host512}")
    runs["512 setup_device parity"] = {"launches": launches,
                                       "iterations": res.iterations}
    del pc

    # card against CPU, 256^2 f64, and the option sweep at 64^2
    def card_and_cpu(label, A, o, make_input=None):
        inp = A if make_input is None else make_input(A)
        with LevelMatrices() as seen_card:
            pcd = tpf.PCAIR(o, dtype=torch.float64, device=dev)
            pcd.setup_device(inp if make_input is None else inp.to(dev))
        with LevelMatrices() as seen_cpu:
            pcc = tpf.PCAIR(o, dtype=torch.float64, device="cpu")
            pcc.setup_device(inp)
        on_card(pcd)
        try:
            notes, diverged, worst, coeff = compare_setups(
                setup_levels(pcd.hierarchy), setup_levels(pcc.hierarchy),
                seen_card, seen_cpu, o, rtol=1e-12, coeff_rtol=None)
        except AssertionError as e:
            raise RuntimeError(f"{label}: card against CPU: {e}") from e
        notes.append(("polynomial coefficients within", f"{coeff:.3e}"))
        return pcd, pcc, notes, diverged, worst

    A256 = tpf.adv_diff_2d(256)
    pcd, pcc, notes, diverged, worst = card_and_cpu("256^2", A256, opts)
    b = np.random.default_rng(0).standard_normal(A256.shape[0])
    kw256 = dict(side="right", rtol=1e-10, atol=1e-50, max_it=60)
    zero_counts()
    rd = pcd.solve(b, **kw256)
    launches = counts()
    rc = pcc.solve(b, **kw256)
    hd, hc = rd.history, rc.history
    same_hist = len(hd) == len(hc) and bool(np.all(
        np.abs(hd - hc) <= HISTORY_RTOL * hc + HISTORY_FLOOR * hc[0]))
    print(f"# 256^2 f64 setup_device card against CPU: {pcd.n_levels} / "
          f"{pcc.n_levels} levels, markers and operators "
          + ("equal up to a tie" if diverged else "equal on every level")
          + ": " + "; ".join(f"{k}: {v}" for k, v in notes)
          + f", operators within {worst:.3e} of their largest entry; right "
          f"GMRES {rd.iterations} / {rc.iterations} its, histories "
          + ("within phase 10's rule" if same_hist else "differ")
          + f"; launches {launches}")
    require(worst <= 1e-12, f"256^2 card against CPU: {worst:.3e}")
    require(same_hist or diverged, "256^2 setup_device: card and CPU "
            "histories differ on equal hierarchies")
    require(rd.converged and launches["dia"] > 0,
            "256^2 setup_device: the card's solve")
    runs["256 setup_device gmres"] = {"launches": launches,
                                      "iterations": rd.iterations}
    del pcd, pcc
    # the curved-velocity sibling puts no entry on a decision's edge:
    # card and CPU must agree on every level
    pcd, pcc, notes, diverged, worst = card_and_cpu(
        "256^2 curved", tpf.adv_diff_2d(256, curved_velocity=True), opts)
    print(f"# 256^2 curved f64 setup_device card against CPU: "
          f"{pcd.n_levels} / {pcc.n_levels} levels, "
          + ("parted at a tie" if diverged else "equal on every level")
          + ": " + "; ".join(f"{k}: {v}" for k, v in notes)
          + f", operators within {worst:.3e} of their largest entry")
    require(not diverged and pcd.n_levels == pcc.n_levels,
            "256^2 curved setup_device: card and CPU parted")
    del pcd, pcc
    A64 = tpf.adv_diff_2d(64)
    for label, kw_set, kind in PHASE13_SETS:
        o = tpf.AIROptions().replace(**kw_set)
        make = None
        if kind == "DELL":
            make = lambda A: DELL.from_scipy(A, dtype=torch.float64,
                                             device="cpu")
        pcd, pcc, notes, diverged, worst = card_and_cpu(label, A64, o, make)
        res = pcd.solve(np.ones(A64.shape[0]), side="right", rtol=1e-8,
                        max_it=60)
        print(f"# 64^2 f64 setup_device {label}: {pcd.n_levels} levels"
              + (" (auto-truncated)" if pcd.hierarchy.auto_truncated else "")
              + ", card against CPU "
              + ("equal up to a tie" if diverged else "equal on every level")
              + ": " + "; ".join(f"{k}: {v}" for k, v in notes)
              + f", within {worst:.3e}; right GMRES {res.iterations} its")
        require(res.converged, f"64^2 setup_device {label}: no convergence")
        if kind == "DELL":
            ref = tpf.PCAIR(o, dtype=torch.float64, device=dev)
            ref.setup_device(A64)
            got, want = pcd.upload().to_scipy(), ref.upload().to_scipy()
            require(got.keys() == want.keys() and all(
                abs(got[k] - want[k]).max() == 0 for k in want),
                "64^2 setup_device: a DELL input differs from its matrix")
    del pcd, pcc
    t_a = time.perf_counter() - t_phase

    # (b) 2048^2, f32, the phase-7 options
    opts2k = bench_options(tpf, max_levels=10)
    pc = tpf.PCAIR(opts2k, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t_first = timed_setup(pc, A2k)
    peak = torch.cuda.max_memory_allocated() - mem0
    t_warm = timed_setup(pc, A2k)
    per_level, total = syncs_by_level(pc, A2k)
    h = pc.hierarchy
    on_card(pc)
    f_dev = h.levels[0].n_f / h.levels[0].n
    f_host = host2k["levels"][0][1] / host2k["levels"][0][0]
    print(f"# 2048^2 f32 setup_device: {t_first:.3f} s first / "
          f"{t_warm:.3f} s warm to completion, against "
          f"phase 7's host setup {host2k['setup']:.3f} s + upload "
          f"{host2k['upload']:.3f} s; peak device memory {peak / 1e9:.3f} GB "
          f"above the {mem0 / 1e9:.3f} GB held; synchronisations {total} "
          f"(by level {per_level}); {h.n_levels} levels (host "
          f"{host2k['n_levels']}), (n, n_f) device "
          f"{[(lv.n, lv.n_f) for lv in h.levels]} host {host2k['levels']}; "
          f"level-0 F fraction {f_dev:.4f} (host {f_host:.4f}); {host_gib()}")
    require(abs(h.n_levels - host2k["n_levels"]) <= 1
            and abs(f_dev - f_host) < 0.1, "2048^2 setup_device: level "
            "sizes outside the reference's rule (levels +-1, F fraction "
            "within 0.1)")
    b2k = np.random.default_rng(1).standard_normal(A2k.shape[0])
    zero_counts()
    t0 = time.perf_counter()
    x, norms = pc.solve_device(b2k, max_it=10, ksp="richardson")
    device_sync_read(x, norms)
    t_solve = time.perf_counter() - t0
    launches = counts()
    norms = norms.cpu().numpy()
    its = _converged_at(np, norms, 1e-5)
    true = float(np.linalg.norm(A2k @ x.double().cpu().numpy() - b2k)
                 / np.linalg.norm(b2k))
    print(f"# 2048^2 f32 setup_device solve_device: 10 Richardson its "
          f"{t_solve:.4f} s, rtol 1e-5 at iteration {its}, true residual "
          f"{true:.3e}, launches {launches} (DIA {launches['dia'] / 10:.1f}, "
          f"banded {launches['banded'] / 10:.1f}, gather "
          f"{launches['sell'] / 10:.1f} an iteration), relative "
          f"norms {np.array2string(norms / norms[0], precision=3)}")
    require(np.isfinite(norms).all() and true <= 1e-4,
            f"2048^2 setup_device: true residual {true:.3e} after 10 its")
    require(launches["dia"] > 0, "2048^2 setup_device: no DIA launch")
    runs["2048 setup_device richardson"] = {"launches": launches,
                                            "iterations": 10}
    dell = {"2048^2 device-built": dell_checks(
        np, torch, pc, b2k, "2048^2 device-built", measure, err)}
    timed["dell"] += dell_rows(dell["2048^2 device-built"])
    dell["2048^2 device-built"]["profiled"] = profile_solve(
        pc, b2k, "2048^2 device-built")
    dh = pc.upload()
    print(f"# 2048^2 device-built containers: top {type(dh.top).__name__}; "
          + "; ".join(f"level {i}: " + ", ".join(
              f"{k} {type(lev[k]).__name__}" for k in ("A_ff", "A_fc", "R",
                                                        "P"))
              for i, lev in enumerate(dh.levels)), flush=True)
    del dh

    # one warm setup_device under the profiler, device activity alone
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_prof = timed_setup(pc, A2k)
    busy_us, ops = 0.0, []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            busy_us += evt.self_device_time_total
            ops.append((evt.self_device_time_total, evt.count, evt.key))
    ops.sort(reverse=True)
    print(f"# 2048^2 f32 profiled setup_device: wall {t_prof:.4f} s, device "
          f"busy {busy_us / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / 1e6 / t_prof:.1%}; top device ops: " + "; ".join(
              f"{key[:60]} {t / 1e3:.3f} ms in {c}" for t, c, key in ops[:8]))
    print(f"# phase 13 (a) {t_a:.3f} s, (b) "
          f"{time.perf_counter() - t_phase - t_a:.3f} s")
    del pc, h, x
    return runs, time.perf_counter() - t_phase, dell


# ~~~~~~~~~~ phase 14: unstructured meshes ~~~~~~~~~~

# grid sides of (a) and (b): 2 m^2 jittered Delaunay triangles each; of
# (e): about 6 m^3 tetrahedra of the benchmark's frozen mesh
PHASE14_M = {"fv": 1024, "dg1": 512, "tet": 24}


def dell_rows(run) -> list:
    """The timing rows of a ``dell_checks`` run, each once."""
    rows = [run["timing"], *run["fused_timing"]]
    multi = run["multilane_timing"]
    return rows + ([multi] if multi is not None and multi is not rows[0]
                   else [])


def tet_device_built(np, torch, tpf, dev, solve, measure, err, timed,
                     dell_runs):
    """Phase 14 (e): the benchmark's 3-D DG(1) operator on tetrahedra
    (``solverbench/generators/dg1_upwind_tet_mesh.py`` at m =
    ``PHASE14_M["tet"]``), ``setup_device`` with the default options and
    ``reorder="auto"`` in f32, whose coarse rows hold hundreds of entries
    (the widest DELL at least 100 slots a row), packed at two or more
    lanes a row; right GMRES to rtol 1e-5 (cap 60, true residual <=
    1e-4); ``dell_checks`` on its form: every DELL, each epilogue and
    each level's R and P through its coarse map bit for bit against
    ``sell_spmv_plain``, ``measure`` on the widest DELL and on the widest
    multi-lane one, which must exist."""
    from pflare_tpu_torch.air.device_setup import solve_form_dells
    from solverbench import harness

    m = PHASE14_M["tet"]
    label = f"DG(1) tet m={m}"
    t0 = time.perf_counter()
    A = harness.generator("dg1_upwind_tet_mesh")(m=m)
    t_asm = time.perf_counter() - t0
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    pc = tpf.PCAIR(tpf.AIROptions(reorder="auto"), dtype=torch.float32,
                   device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pc.setup_device(A)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    dells = solve_form_dells(pc.upload())
    widest = max(M.K for M in dells)
    lanes = sorted({M.packed.lanes for M in dells})
    print(f"# {label}: {A.shape[0]} DoF, {A.nnz} nonzeros, frozen "
          f"generator {t_asm:.3f} s; f32 setup_device {t_dev:.3f} s to "
          f"completion, {pc.n_levels} levels, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; "
          f"{len(dells)} DELLs, widest {widest} slots a row, packed at "
          f"{lanes} lanes", flush=True)
    require(widest >= 100 and lanes[-1] >= 2, f"{label}: the widest DELL "
            f"has {widest} slots a row, the most lanes are {lanes[-1]}")
    solve(f"{label} setup_device", pc, A, b, "gmres", cap=60)
    run = dell_checks(np, torch, pc, b, f"{label} device-built", measure,
                      err)
    require(run["multilane_timing"] is not None, f"{label}: no multi-lane "
            "DELL was timed")
    timed["dell"] += dell_rows(run)
    dell_runs[f"{label} device-built"] = run


def mesh_tri(np, m, seed=0, jitter=0.3):
    """Delaunay triangles of an (m+1)^2 grid on the unit square whose
    interior points are jittered by up to ``jitter`` of a spacing, in a
    seeded scrambled cell order (the construction of
    tests/torch_cases.py::tri_mesh)."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    g = np.linspace(0.0, 1.0, m + 1)
    pts = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    inner = np.all((pts > 0) & (pts < 1), axis=1)
    pts[inner] += rng.uniform(-jitter, jitter, (inner.sum(), 2)) / m
    cells = Delaunay(pts).simplices.astype(np.int64)
    return pts, cells[rng.permutation(len(cells))]


def mesh_tet(np, m, seed=0, jitter=0.2):
    """Delaunay tets of a jittered (m+1)^3 grid on the unit cube, without
    the flat tets of coplanar boundary points."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    g = np.linspace(0.0, 1.0, m + 1)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    inner = np.all((pts > 0) & (pts < 1), axis=1)
    pts[inner] += rng.uniform(-jitter, jitter, (inner.sum(), 3)) / m
    cells = Delaunay(pts).simplices.astype(np.int64)
    vol = np.abs(np.linalg.det(pts[cells[:, 1:]] - pts[cells[:, :1]])) / 6
    return pts, cells[vol > 1e-6 / m ** 3]


def mesh_annulus(np, nr, nt, nz, twist=0.5, r0=0.5, r1=1.0):
    """Hexes on an annulus r0 <= r <= r1, 0 <= z <= 1, twisted by
    ``twist`` radians over the height (the reference's annulus_twisted
    family)."""
    r, z = np.linspace(r0, r1, nr + 1), np.linspace(0.0, 1.0, nz + 1)
    R, T, Z = np.meshgrid(r, np.arange(nt) * (2 * np.pi / nt), z,
                          indexing="ij")
    T = T + twist * Z
    pts = np.stack([R * np.cos(T), R * np.sin(T), Z], -1).reshape(-1, 3)
    a, b, c = (x.ravel() for x in np.meshgrid(
        np.arange(nr), np.arange(nt), np.arange(nz), indexing="ij"))

    def vid(i, j, k):
        return (i * nt + j % nt) * (nz + 1) + k

    return pts, np.stack([
        vid(a, b, c), vid(a + 1, b, c), vid(a + 1, b + 1, c),
        vid(a, b + 1, c), vid(a, b, c + 1), vid(a + 1, b, c + 1),
        vid(a + 1, b + 1, c + 1), vid(a, b + 1, c + 1)], 1)


GMSH_TYPES = {(2, 3): 2, (2, 4): 3, (3, 4): 4, (3, 8): 5}


def write_gmsh(np, path, points, cells):
    """Write a Gmsh 4.1 ASCII mesh of one cell block (node tags 1..n in
    order, coordinates to 17 digits, so they read back exactly)."""
    dim = 3 if cells.shape[1] == 8 or (
        cells.shape[1] == 4 and points.shape[1] == 3) else 2
    pts = np.zeros((len(points), 3))
    pts[:, :points.shape[1]] = points
    n, m, k = len(pts), len(cells), cells.shape[1]
    row = " ".join(["%d"] * (k + 1))
    tagged = np.hstack([np.arange(1, m + 1)[:, None], cells + 1])
    with open(path, "w") as f:
        f.write(f"$MeshFormat\n4.1 0 8\n$EndMeshFormat\n$Nodes\n1 {n} 1 {n}"
                f"\n{dim} 1 0 {n}\n")
        f.write("\n".join(map(str, range(1, n + 1))) + "\n")
        f.write("\n".join("%.17g %.17g %.17g" % tuple(p)
                          for p in pts.tolist()) + "\n")
        f.write(f"$EndNodes\n$Elements\n1 {m} 1 {m}\n{dim} 1 "
                f"{GMSH_TYPES[(dim, k)]} {m}\n")
        f.write("\n".join(row % tuple(c) for c in tagged.tolist()) + "\n")
        f.write("$EndElements\n")


def write_petsc(np, path, A, vecs):
    """Write a PETSc binary AIJ matrix followed by vectors."""
    with open(path, "wb") as f:
        np.array([1211216, A.shape[0], A.shape[1], A.nnz], ">i4").tofile(f)
        np.diff(A.indptr).astype(">i4").tofile(f)
        A.indices.astype(">i4").tofile(f)
        A.data.astype(">f8").tofile(f)
        for v in vecs:
            np.array([1211214, len(v)], ">i4").tofile(f)
            np.asarray(v, ">f8").tofile(f)


def peak_rss() -> str:
    import resource

    return (f"peak host memory "
            f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f}"
            " GiB")


# (label, mesh, assembly and keywords, AIROptions keywords, solve
# keywords, the reference's cap) of phase 14 (c): the option sets of
# tests/test_mesh.py:55-190 on generated meshes of 10-50k DoF, f64
PHASE14_SETS = (
    ("FV tri", ("tri", 100), ("fv", {}), dict(a_lump=True),
     dict(ksp="richardson"), 6),
    ("FV tet", ("tet", 16), ("fv", {}), dict(a_lump=True),
     dict(ksp="richardson"), 4),
    ("DG(1) tri", ("tri", 58), ("dg1", {}), {}, dict(ksp="richardson"), 4),
    ("DG(1) tri curved", ("tri", 58), ("dg1", dict(curved=True)), {},
     dict(ksp="richardson"), 4),
    ("DG(1) tet", ("tet", 9), ("dg1", {}), dict(a_lump=True),
     dict(ksp="richardson"), 6),
    ("DG(1) twisted annulus hex", ("hex", (4, 64, 8)),
     ("dg1", dict(velocity=(0.0, 0.0, 1.0))), dict(a_lump=True),
     dict(ksp="richardson"), 5),
    ("SUPG tet", ("tet", 24), ("supg", {}), dict(a_lump=True),
     dict(ksp="richardson"), 4),
    ("SUPG tri curved unscaled PRODUCT", ("tri", 128),
     ("supg", dict(curved=True, unit_velocity=False)),
     dict(a_lump=True, diag_scale_polys=True, z_type="PRODUCT"),
     dict(ksp="richardson"), 5),
    ("SUPG tri curved unscaled LAIR", ("tri", 128),
     ("supg", dict(curved=True, unit_velocity=False)),
     dict(a_lump=True, diag_scale_polys=True, z_type="LAIR"),
     dict(ksp="richardson"), 5),
    ("SUPG tri diffusion", ("tri", 128),
     ("supg", dict(alpha=1.0, velocity=(0.0, 0.0), unit_velocity=False)),
     {}, dict(rtol=1e-8), 30),
)


def phase14(np, sp, torch, tpf, tdia, tbanded, dev, check, measure, timed,
            profile_solve, setup_breakdown, err, dell_runs):
    """Unstructured meshes on the card (see the module docstring, phase
    14).  Returns the runs ({label: {"launches", "iterations"}}), the
    phase's seconds and (a)'s FV matrix, RHS and host-built PCAIR."""
    import shutil
    import tempfile

    from pflare_tpu_torch.sparse import BandedSpMV
    from pflare_tpu_torch.sparse import ell as sell
    from pflare_tpu_torch.utils.timers import device_sync_read, reset_timers

    require(dev.type == "cuda", "phase 14 runs on the card")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pflare_mesh_")
    runs = {}

    def counts():
        return {"dia": tdia.KERNEL_LAUNCHES, "banded": tbanded.KERNEL_LAUNCHES,
                "sell": sell.KERNEL_LAUNCHES}

    def zero_counts():
        tdia.KERNEL_LAUNCHES = 0
        tbanded.KERNEL_LAUNCHES = 0
        sell.KERNEL_LAUNCHES = 0

    def containers(pc):
        """Each level's size and the container of each of its operators
        (an inverse without a matrix by its kind)."""
        h, dh = pc.hierarchy, pc.upload()
        out = [f"top {type(dh.top).__name__}"]
        for i, (lv, lev) in enumerate(zip(h.levels, dh.levels)):
            inv = lev["inv_Aff"]
            ops = [f"{k} {type(lev[k]).__name__}"
                   for k in ("A_ff", "A_fc", "R", "P")]
            ops.append("inv " + (inv.kind if inv.mat is None
                                 else type(inv.mat).__name__))
            out.append(f"level {i} ({lv.n} rows): " + ", ".join(ops))
        coarse = getattr(h, "coarse_matrix", None)
        coarse = h.coarse_A if coarse is None else coarse
        return "; ".join(out) + f"; coarse {coarse.shape[0]} rows"

    def solve(label, pc, A, b, ksp="richardson", needed=True, cap=30):
        """Richardson or right GMRES to rtol 1e-5 (cap 30) with the
        counters at 0: the iterations, the true residual by scipy in f64
        and the launches; ``needed``: it must converge (true residual <=
        1e-4)."""
        kw = dict(side="right") if ksp == "gmres" else {}
        zero_counts()
        t0 = time.perf_counter()
        res = pc.solve(b, ksp=ksp, rtol=1e-5, max_it=cap, **kw)
        device_sync_read(res.x)
        t = time.perf_counter() - t0
        launches = counts()
        true = float(np.linalg.norm(A @ res.x.double().cpu().numpy() - b)
                     / np.linalg.norm(b))
        its = max(res.iterations, 1)
        h = np.asarray(res.history)
        print(f"# {label}: {'right GMRES' if kw else 'Richardson'} "
              f"{res.iterations} its to rtol 1e-5 (converged "
              f"{res.converged}), {t:.4f} s to completion, true residual "
              f"{true:.3e}, launches {launches}, an iteration dia "
              f"{launches['dia'] / its:.2f} banded "
              f"{launches['banded'] / its:.2f} gather "
              f"{launches['sell'] / its:.2f}, relative norms "
              + np.array2string(h[:12] / h[0], precision=3,
                                max_line_width=10**4))
        if needed:
            require(res.converged and true <= 1e-4 and np.isfinite(true),
                    f"{label}: {ksp} did not reach rtol 1e-5 in {cap} its "
                    f"(true residual {true:.3e})")
            runs[label] = {"launches": launches,
                           "iterations": res.iterations}
        return res, launches

    def large_cell(tag, m, assemble, opts, ksp):
        """(a)/(b): write, read and assemble the m-mesh; host setup +
        upload and ``setup_device``, each solved by ``ksp`` (right GMRES
        after a Richardson run for the record)."""
        t0 = time.perf_counter()
        pts, cells = mesh_tri(np, m)
        t_mesh = time.perf_counter() - t0
        path = os.path.join(tmp, f"{tag}_{m}.msh")
        t0 = time.perf_counter()
        write_gmsh(np, path, pts, cells)
        t_write = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        points, found = tpf.read_gmsh(path)
        t_read = time.perf_counter() - t0
        require(np.array_equal(points[:, :2], pts)
                and np.array_equal(found["tri"], cells),
                f"{tag} m={m}: the mesh read back differs from the one "
                "written")
        os.remove(path)
        t0 = time.perf_counter()
        A = assemble(points, found["tri"])
        t_asm = time.perf_counter() - t0
        del pts, cells, points, found
        label = f"{tag} m={m}"
        print(f"# {label}: {A.shape[0]} DoF, {A.nnz} nonzeros; mesh "
              f"{t_mesh:.3f} s, write {t_write:.3f} s ({size / 1e6:.1f} MB), "
              f"read_gmsh {t_read:.3f} s, assemble {t_asm:.3f} s; "
              f"{host_gib()}, {peak_rss()}", flush=True)
        b = np.random.default_rng(1).standard_normal(A.shape[0])

        pc = tpf.PCAIR(opts, dtype=torch.float32, device=dev)
        reset_timers()
        t0 = time.perf_counter()
        pc.setup(A)
        t_setup = time.perf_counter() - t0
        s0 = pc.stats()
        t0 = time.perf_counter()
        dh = pc.upload()
        torch.cuda.synchronize()
        t_upload = time.perf_counter() - t0
        s1 = pc.stats()
        require(pc.hierarchy.compacted and pc.host_bytes_released > 0
                and s0 == s1, f"{label}: the upload did not compact the "
                "host hierarchy, or stats() changed")
        print(f"# {label} f32 host setup {t_setup:.3f} s + upload "
              f"{t_upload:.3f} s, {pc.n_levels} levels, reordered "
              f"{pc._perm is not None}; {containers(pc)}; compact_host "
              f"released {pc.host_bytes_released / 1e9:.3f} GB of host CSR; "
              f"stats() before and after: operator complexity "
              f"{s0['operator_complexity']:.6f} / "
              f"{s1['operator_complexity']:.6f}, storage "
              f"{s0['storage_complexity']:.6f} / "
              f"{s1['storage_complexity']:.6f}, nnz {s1['nnz']}; "
              f"{host_gib()}, {peak_rss()}", flush=True)
        if ksp == "gmres":
            solve(f"{label} host setup, Richardson", pc, A, b, needed=False)
        res, launches = solve(f"{label} host setup", pc, A, b, ksp)
        print(f"# {label} host setup phases: {setup_breakdown()}")
        profile_solve(pc, b, f"{label} host-built")
        top = dh.top
        del dh, res

        pcd = tpf.PCAIR(opts, dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        pcd.setup_device(A)
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        print(f"# {label} f32 setup_device {t_dev:.3f} s to completion "
              f"({(t_setup + t_upload) / t_dev:.1f}x the host setup + "
              f"upload), {pcd.n_levels} levels; {containers(pcd)}")
        solve(f"{label} setup_device", pcd, A, b, ksp)
        profile_solve(pcd, b, f"{label} device-built")
        run = dell_checks(np, torch, pcd, b, f"{label} device-built",
                          measure, err)
        timed["dell"] += dell_rows(run)
        dell_runs[f"{label} device-built"] = run
        del pcd
        return A, b, top, launches, pc

    try:
        # (a) FV on 2 x 1024^2 triangles: the top level on the banded kernel
        A, b, top, launches, pc = large_cell(
            "FV", PHASE14_M["fv"], tpf.fv_upwind_advection,
            tpf.AIROptions(a_lump=True, reorder="auto"), "richardson")
        require(isinstance(top, BandedSpMV), f"FV: the reordered top A is a "
                f"{type(top).__name__}, not banded")
        its = runs[f"FV m={PHASE14_M['fv']} host setup"]["iterations"]
        require(launches["banded"] >= its, f"FV: {launches['banded']} "
                f"banded launches in {its} iterations")
        check(top, "banded", f"FV m={PHASE14_M['fv']} top A banded "
              f"W={top.W}")
        timed["banded"].append(measure(f"FV m={PHASE14_M['fv']} top A", top))
        fv = (A, b, pc)     # phase 15 (c) shards this hierarchy
        del A, b, top, pc

        # (b) DG(1) on 2 x 512^2 triangles: its V-cycle diverges as a
        # stationary iteration at this size (Richardson's norms grow by
        # ~1.4 an iteration from the third on, card and CPU alike, with
        # every option set tried), so the solve that must converge is
        # right GMRES; the Richardson run is printed for the record
        A, b, _, _, _ = large_cell("DG(1)", PHASE14_M["dg1"],
                                tpf.dg1_upwind_advection,
                                tpf.AIROptions(reorder="auto"), "gmres")

        # (d) the file route: (b)'s matrix and RHS in PETSc binary
        path = os.path.join(tmp, "dg1.petsc")
        t0 = time.perf_counter()
        write_petsc(np, path, A, [b])
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        Af, vecs = tpf.read_petsc_matrix(path, return_vecs=True)
        t_read = time.perf_counter() - t0
        require(Af.shape == A.shape and all(
            np.array_equal(getattr(Af, k), getattr(A, k))
            for k in ("indptr", "indices", "data")) and len(vecs) == 1
            and np.array_equal(vecs[0], b), "PETSc binary: the matrix or "
            "vector read back differs")
        os.remove(path)
        print(f"# PETSc binary of the DG(1) matrix and RHS: write "
              f"{t_write:.3f} s, read {t_read:.3f} s, equal bit for bit")
        del A
        inv = tpf.PCPFLAREINV(dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        inv.setup(Af)
        inv.upload()
        torch.cuda.synchronize()
        t_inv = time.perf_counter() - t0
        zero_counts()
        t0 = time.perf_counter()
        res = inv.solve(vecs[0], rtol=1e-5, max_it=30)
        device_sync_read(res.x)
        t_solve = time.perf_counter() - t0
        launches = counts()
        true = float(np.linalg.norm(Af @ res.x.double().cpu().numpy()
                                    - vecs[0]) / np.linalg.norm(vecs[0]))
        print(f"# file DG(1) PCPFLAREINV default f32: setup + upload "
              f"{t_inv:.3f} s, GMRES {res.iterations} its (converged "
              f"{res.converged}), {t_solve:.4f} s, true residual "
              f"{true:.3e}, launches {launches}")
        require(np.isfinite(true) and true < 1.0, "file DG(1) PCPFLAREINV: "
                f"the residual did not fall ({true:.3e})")
        runs["file DG(1) PCPFLAREINV"] = {"launches": launches,
                                          "iterations": res.iterations}
        del inv, res
        pcf = tpf.PCAIR(tpf.AIROptions(reorder="auto"), dtype=torch.float32,
                        device=dev)
        t0 = time.perf_counter()
        pcf.setup_device(Af)
        torch.cuda.synchronize()
        print(f"# file DG(1) PCAIR setup_device {time.perf_counter() - t0:.3f}"
              " s")
        solve("file DG(1) PCAIR", pcf, Af, vecs[0], "gmres")
        del pcf, Af, vecs

        # (e) 3-D DG(1) on tetrahedra: the wide coarse rows on the gather
        # kernel
        tet_device_built(np, torch, tpf, dev, solve, measure, err, timed,
                         dell_runs)
        t_ab = time.perf_counter() - t_phase

        # (c) small meshes, f64: card against its CPU twin
        assemble = {"fv": tpf.fv_upwind_advection,
                    "dg1": tpf.dg1_upwind_advection,
                    "supg": tpf.supg_advection_diffusion}
        meshes = {}
        for label, (kind, size), (asm, kw), opts_kw, solve_kw, cap in \
                PHASE14_SETS:
            if (kind, size) not in meshes:
                meshes[(kind, size)] = (
                    mesh_tri(np, size) if kind == "tri" else
                    mesh_tet(np, size) if kind == "tet" else
                    mesh_annulus(np, *size))
            pts, cells = meshes[(kind, size)]
            A = assemble[asm](pts, cells, **kw)
            b = np.random.default_rng(0).standard_normal(A.shape[0])
            kw_solve = dict(rtol=1e-5, max_it=30) | solve_kw
            pc = tpf.PCAIR(tpf.AIROptions().replace(**opts_kw),
                           dtype=torch.float64, device=dev).setup(A)
            cpu = pc.on("cpu")
            zero_counts()
            res = pc.solve(b, **kw_solve)
            launches = counts()
            ref = cpu.solve(b, **kw_solve)
            h, hr = np.asarray(res.history), np.asarray(ref.history)
            true = float(np.linalg.norm(A @ res.x.cpu().numpy() - b)
                         / np.linalg.norm(b))
            dev_rel = (float(np.max(np.abs(h - hr) / hr)) if len(h) == len(hr)
                       else float("inf"))
            print(f"# {label}: {A.shape[0]} DoF f64, {pc.n_levels} levels, "
                  f"{kw_solve.get('ksp', 'gmres')} {res.iterations} its "
                  f"(reference cap {cap} on its own mesh; CPU twin "
                  f"{ref.iterations}), true residual {true:.3e}, card "
                  f"against CPU history max relative difference "
                  f"{dev_rel:.3e}, launches {launches}, compacted "
                  f"{pc.hierarchy.compacted}")
            require(res.converged and len(h) == len(hr) and np.all(
                np.abs(h - hr) <= HISTORY_RTOL * hr + HISTORY_FLOOR * hr[0]),
                f"{label}: card and CPU histories differ")
            require(true <= 10 * kw_solve["rtol"] and pc.hierarchy.compacted,
                    f"{label}: true residual {true:.3e}")
            runs[label] = {"launches": launches,
                           "iterations": res.iterations}
            del pc, cpu
        print(f"# phase 14 (a, b, d, e) {t_ab:.3f} s, (c) "
              f"{time.perf_counter() - t_phase - t_ab:.3f} s; {peak_rss()}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs, time.perf_counter() - t_phase, fv


# ~~~~~~~~~~ phase 15: the row mesh ~~~~~~~~~~

# (label, options over bench_options) of phase 15 (a): the bench options
# (one-point W: products Z, AP, RAP) and POWER inverses with the ideal W
# (the TSQR, and the W product)
PHASE15_SETS = (
    ("bench", {}),
    ("POWER, ideal W", dict(inverse_type="POWER",
                            coarsest_inverse_type="POWER",
                            one_point_classical_prolong=False)))
PHASE15_SHARDS = {"setup": 8, "solve": 4}
PHASE15_CURVED = 512       # (a)'s grid side, as A512's
MESH_HISTORY_RTOL = 1e-5   # (b), (c): sharded against serial norms, f32


def _pattern(M):
    """M's sparsity pattern, as ones."""
    P = M.copy()
    P.data[:] = 1.0
    return P


def phase15(np, torch, tpf, tdia, tbanded, dev, A512, pc2k, A2k, b2k, fv,
            measure, plain_matvec, profile_solve, err):
    """The row mesh on the card (see the module docstring, phase 15).
    Returns {"dia", "banded"}: each kernel's launches an iteration of the
    sharded 2048^2 solve, its per-shard shapes and a shard block's timing;
    the phase's seconds; and (b)'s mesh, for phase 17."""
    from pflare_tpu_torch.air import operators as tops
    from pflare_tpu_torch.parallel import HaloELL, make_mesh
    from pflare_tpu_torch.parallel.mesh import agglomeration_schedule
    from pflare_tpu_torch.sparse import DIA, BandedSpMV
    from pflare_tpu_torch.utils.timers import device_sync_read

    require(dev.type == "cuda", "phase 15 runs on the card")
    t_phase = time.perf_counter()

    def zero_counts():
        tdia.KERNEL_LAUNCHES = 0
        tbanded.KERNEL_LAUNCHES = 0

    def counts():
        return {"dia": tdia.KERNEL_LAUNCHES, "banded": tbanded.KERNEL_LAUNCHES}

    def timed_solve(pc, b, **kw):
        zero_counts()
        t0 = time.perf_counter()
        x, norms = pc.solve_device(b, max_it=10, ksp="richardson", **kw)
        device_sync_read(x, norms)
        return x, norms.cpu().numpy(), time.perf_counter() - t0, counts()

    def sharded_ops(st):
        """(label, HaloELL or RowShardedOp) of a sharded solve form."""
        ops = [("top", st.top)]
        for i, lev in enumerate(st.levels):
            seen = set()
            for key, val in lev.items():
                op = getattr(val, "mat", val)
                if hasattr(op, "blocks") and id(op) not in seen:
                    seen.add(id(op))
                    ops.append((f"level {i} {key}", op))
        return ops

    def describe(st):
        lines = []
        for label, op in sharded_ops(st):
            kinds = sorted({type(b).__name__ for b in op.blocks if b})
            lines.append(f"{label} {type(op).__name__} {op.active}/"
                         f"{op.mesh.size} shards x {op.w} rows {kinds}")
        return "; ".join(lines)

    def check_blocks(op, label):
        """Each DIA or banded shard block of ``op`` against its plain
        version on its own source vector (the extended window of a
        HaloELL, the whole vector otherwise): the kernels on the shapes
        of the sharded path."""
        x = torch.as_tensor(np.random.default_rng(9).standard_normal(
            op.n_pad), dtype=op.dtype, device=dev)
        src = op._sources(x)
        n = 0
        for s, blk in enumerate(op.blocks):
            if not isinstance(blk, (DIA, BandedSpMV)):
                continue
            y, ref = blk.matvec(src[s]), plain_matvec(blk, src[s])
            torch.cuda.synchronize()
            rel = float((y - ref).norm() / ref.norm())
            name = str(blk.dtype).split(".")[-1]
            require(rel <= TOL[name], f"phase 15 {label} shard {s}: kernel "
                    f"vs plain relative error {rel:.3e}")
            group = "padded" if isinstance(blk, DIA) else "banded"
            err[group] = max(err[group], float((y - ref).abs().max()))
            n += 1
        return n

    def neighbour_only(mesh, label):
        kinds = mesh.traffic(label)
        return bool(kinds) and set(kinds) == {"ppermute"}

    # (a) the distributed setup at 512^2, f64, 8 shards: every level equal
    # on the curved-velocity sibling, which puts no entry on a decision's
    # edge; on the main path's matrix equal until a one-point-W tie
    t_a = time.perf_counter()
    curved = tpf.adv_diff_2d(PHASE15_CURVED, curved_velocity=True)
    b512 = np.random.default_rng(3).standard_normal(A512.shape[0])
    for matrix, A, (label, extra) in [("curved", curved, st_)
                                      for st_ in PHASE15_SETS] + [
            ("main path", A512, PHASE15_SETS[0])]:
        opts = bench_options(tpf).replace(**extra)
        ser = tpf.PCAIR(opts, dtype=torch.float64, device=dev)
        t0 = time.perf_counter()
        ser.setup(A)
        t_ser = time.perf_counter() - t0
        mesh = make_mesh(PHASE15_SHARDS["setup"])
        tops.MESH_PRODUCT_LOG = log = []
        try:
            dis = tpf.PCAIR(opts, dtype=torch.float64, device=dev)
            t0 = time.perf_counter()
            dis.setup(A, mesh=mesh)
            t_dis = time.perf_counter() - t0
        finally:
            tops.MESH_PRODUCT_LOG = None
        hs, hd = ser.hierarchy, dis.hierarchy
        tag = f"phase 15 (a) {matrix} {label}"
        parted, r_rel = None, 0.0
        for i, (ls, ld) in enumerate(zip(hs.levels, hd.levels)):
            if not (np.array_equal(ls.fine, ld.fine)
                    and np.array_equal(ls.coarse, ld.coarse)):
                parted = f"level {i} CF splitting"
                break
            require(ls.R.nnz == ld.R.nnz, f"{tag}: level {i} R nnz "
                    f"{ld.R.nnz} against {ls.R.nnz}")
            r_rel = max(r_rel, abs(ls.R - ld.R).max() / abs(ls.R).max())
            rows = np.nonzero(np.diff((_pattern(ls.P) != _pattern(ld.P))
                                      .tocsr().indptr))[0]
            if len(rows):
                # each differing P row is a fine row whose two largest
                # |A_fc| entries tie: the one-point W's argmax
                fr = np.searchsorted(ls.fine, rows)
                require(np.array_equal(ls.fine[fr], rows), f"{tag}: level "
                        f"{i} P differs on coarse rows")
                for r in fr:
                    top = np.sort(np.abs(ls.A_fc[r].data))[-2:]
                    require(len(top) == 2 and top[1] - top[0]
                            <= 1e-12 * top[1], f"{tag}: level {i} P row "
                            f"{ls.fine[r]} differs without a tie")
                parted = (f"level {i} one-point W: {len(rows)} rows, each "
                          "a tie of |A_fc|")
                break
        require(r_rel <= 1e-11, f"{tag}: R differs by {r_rel:.3e} of its "
                "largest entry")
        names = {name for name, _ in log}
        want = {"Z", "AP", "RAP"} | ({"W"} if "one_point_classical_prolong"
                                     in extra else set())
        require(want <= names and all(sharded for _, sharded in log),
                f"{tag}: products {log}")
        traffic = {name: mesh.traffic(name) for name in sorted(names)}
        schedule = agglomeration_schedule(
            hd, [lv.n for lv in hd.levels], mesh.size, dis.options)
        res_s = ser.solve(b512, side="right", rtol=1e-10, max_it=60)
        res_d = dis.solve(b512, side="right", rtol=1e-10, max_it=60)
        require(res_s.converged and res_d.converged, f"{tag}: right GMRES "
                "did not converge")
        if matrix == "curved":
            require(parted is None and hs.n_levels == hd.n_levels
                    and res_s.iterations == res_d.iterations,
                    f"{tag}: parted at {parted}, right GMRES "
                    f"{res_d.iterations} its against {res_s.iterations}")
        print(f"# {tag}: {A.shape[0]} rows f64, {hd.n_levels} levels "
              f"{[lv.n for lv in hd.levels]} (serial {hs.n_levels}); serial "
              f"setup {t_ser:.3f} s, {mesh.size}-shard setup {t_dis:.3f} s; "
              + ("markers equal on every level" if parted is None else
                 f"equal until {parted}")
              + f", R within {r_rel:.3e} of its largest entry until then; "
              f"products {sorted(names)} ({len(log)}, all row-sharded), "
              f"their exchanges {traffic}; Luby rounds "
              f"{mesh.traffic('luby')}; agglomeration schedule {schedule}; "
              f"right GMRES to rtol 1e-10: {res_d.iterations} its, serial "
              f"{res_s.iterations}", flush=True)
        del ser, dis
    t_a = time.perf_counter() - t_a

    # (b) the main path sharded: phase 7's 2048^2 f32 hierarchy, 4 shards
    t_b = time.perf_counter()
    mesh = mesh_b = make_mesh(PHASE15_SHARDS["solve"])
    t0 = time.perf_counter()
    st = pc2k._distributed_state(mesh)
    torch.cuda.synchronize()
    t_shard = time.perf_counter() - t0
    print(f"# phase 15 (b) 2048^2 f32 on {mesh.size} shards: sharded in "
          f"{t_shard:.3f} s, agglomeration schedule {st.schedule}; "
          f"{describe(st)}", flush=True)
    n_checked = sum(check_blocks(op, label) for label, op in sharded_ops(st)
                    if label == "top" or label.startswith("level 0 ")
                    or label.startswith("level 1 "))
    require(n_checked > 0, "phase 15 (b): no DIA or banded shard block")
    runs, traffic = {}, None
    for tag, kw in (("serial", {}), ("mesh", {"mesh": mesh}),
                    ("mesh", {"mesh": mesh}), ("serial", {})):
        mesh.reset_log()
        runs.setdefault(tag, []).append(timed_solve(pc2k, b2k, **kw))
        if tag == "mesh" and traffic is None:
            traffic = {label: mesh.traffic(label)
                       for label, _ in sharded_ops(st)}
    (x_s, n_s, _, l_s), (x_m, n_m, _, l_m) = runs["serial"][0], \
        runs["mesh"][0]
    walls = {tag: " / ".join(f"{r[2]:.4f}" for r in rs)
             for tag, rs in runs.items()}
    require(np.all(np.abs(n_m - n_s) <= MESH_HISTORY_RTOL * n_s),
            f"phase 15 (b): sharded norms {n_m / n_s[0]} against serial "
            f"{n_s / n_s[0]}")
    require(l_m["dia"] > 0 and l_m["banded"] > 0,
            f"phase 15 (b): a kernel was not launched on the shards: {l_m}")
    halo = [label for label, op in sharded_ops(st)
            if isinstance(op, HaloELL)]
    require(halo and all(traffic[label] and set(traffic[label])
                         == {"ppermute"} for label in halo),
            "phase 15 (b): a HaloELL operator exchanged beyond its "
            "neighbours: " + str({label: traffic[label] for label in halo}))
    per_level = {}
    for label, kinds in traffic.items():
        key = label.rsplit(" ", 1)[0] if label != "top" else "top"
        for kind, (calls, nbytes) in kinds.items():
            c, b = per_level.get((key, kind), (0, 0))
            per_level[(key, kind)] = (c + calls / 10, b + nbytes / 10)
    true_m = float(np.linalg.norm(A2k @ x_m.double().cpu().numpy() - b2k)
                   / np.linalg.norm(b2k))
    true_s = float(np.linalg.norm(A2k @ x_s.double().cpu().numpy() - b2k)
                   / np.linalg.norm(b2k))
    print(f"# phase 15 (b) Richardson 10 its: wall to completion serial "
          f"{walls['serial']} s, sharded {walls['mesh']} s; launches "
          f"serial {l_s}, sharded {l_m} (an iteration dia "
          f"{l_m['dia'] / 10:.1f} against {l_s['dia'] / 10:.1f}, banded "
          f"{l_m['banded'] / 10:.1f} against {l_s['banded'] / 10:.1f}); "
          f"norms equal within {np.max(np.abs(n_m - n_s) / n_s):.3e}; "
          f"true residual sharded {true_m:.3e}, serial {true_s:.3e}; "
          f"shard blocks checked {n_checked}; exchanges a tenth of the "
          "solve (10 V-cycles, 11 top products) "
          + ", ".join(f"{key} {kind} {c:.1f} calls {b / 1e6:.3f} MB"
                      for (key, kind), (c, b) in sorted(per_level.items())),
          flush=True)
    prof_m = profile_solve(pc2k, b2k, "phase 15 (b) 2048^2 sharded",
                           mesh=mesh)
    prof_s = profile_solve(pc2k, b2k, "phase 15 (b) 2048^2 serial")
    out = {}
    for kind, cls in (("dia", DIA), ("banded", BandedSpMV)):
        shapes = sorted({f"{op.w} rows x K={blk.data.shape[0]}"
                         for _, op in sharded_ops(st) for blk in op.blocks
                         if isinstance(blk, cls)})
        out[kind] = {"shards": mesh.size, "schedule": st.schedule,
                     "launches_per_iteration": l_m[kind] / 10,
                     "serial_launches_per_iteration": l_s[kind] / 10,
                     "shard_shapes": shapes,
                     "solve_us_per_call": prof_m[kind],
                     "wall_s": prof_m["wall_s"],
                     "busy_ms": prof_m["busy_ms"],
                     "serial_wall_s": prof_s["wall_s"],
                     "serial_busy_ms": prof_s["busy_ms"]}
    # a shard block of the top A (the main path's DIA shape, K = 3) and
    # the widest banded block; each reads of its window only what its
    # offsets or band cover
    blocks = [(label, blk) for label, op in sharded_ops(st)
              for blk in op.blocks]
    for kind, cls in (("dia", DIA), ("banded", BandedSpMV)):
        found = [(label, blk) for label, blk in blocks
                 if isinstance(blk, cls)]
        if not found:
            continue
        label, blk = max(found, key=lambda lb: lb[1].data.numel())
        out[kind]["timing"] = measure(f"mesh {label} shard block", blk)
    del st, runs, x_s, x_m
    t_b = time.perf_counter() - t_b

    # (c) unstructured: phase 14's FV matrix and hierarchy, 4 shards
    t_c = time.perf_counter()
    A, b, pc = fv
    mesh = make_mesh(PHASE15_SHARDS["solve"])
    st = pc._distributed_state(mesh)
    require(isinstance(st.top, HaloELL) and all(
        isinstance(blk, BandedSpMV) for blk in st.top.blocks),
        "phase 15 (c): the FV top operator is not a HaloELL on the banded "
        f"kernel ({describe(st)})")
    check_blocks(st.top, "FV top")
    x_s, n_s, t_s, _ = timed_solve(pc, b)
    mesh.reset_log()
    x_m, n_m, t_m, l_m = timed_solve(pc, b, mesh=mesh)
    rel_x = float((x_m - x_s).norm() / x_s.norm())
    true_m = float(np.linalg.norm(A @ x_m.double().cpu().numpy() - b)
                   / np.linalg.norm(b))
    true_s = float(np.linalg.norm(A @ x_s.double().cpu().numpy() - b)
                   / np.linalg.norm(b))
    reparted = [i + 1 for i, lv in enumerate(pc.hierarchy.levels)
                if lv.coarse_order is not None and i + 1 < len(st.levels)]
    rep_labels = [label for label, op in sharded_ops(st)
                  if isinstance(op, HaloELL) and any(
                      label.startswith(f"level {i} ") for i in reparted)]
    require(neighbour_only(mesh, "top") and all(
        neighbour_only(mesh, label) for label in rep_labels),
        "phase 15 (c): exchanges beyond the neighbours on the top or a "
        "repartitioned level")
    require(np.all(np.abs(n_m - n_s) <= MESH_HISTORY_RTOL * n_s)
            and rel_x <= MESH_HISTORY_RTOL and true_m <= 1e-4
            and l_m["banded"] > 0,
            f"phase 15 (c): sharded against serial x {rel_x:.3e}, true "
            f"residuals {true_m:.3e} / {true_s:.3e}, launches {l_m}")
    print(f"# phase 15 (c) FV m={PHASE14_M['fv']} ({A.shape[0]} DoF) on "
          f"{mesh.size} shards: {describe(st)}; repartitioned levels "
          f"{reparted}, their HaloELL operators {len(rep_labels)} "
          f"neighbour-only; Richardson 10 its sharded {t_m:.4f} s (first "
          f"call), serial {t_s:.4f} s; x within {rel_x:.3e}, true residual "
          f"sharded {true_m:.3e}, serial {true_s:.3e}; launches {l_m}; "
          f"exchanges {dict(mesh.traffic())}", flush=True)
    t_c = time.perf_counter() - t_c
    print(f"# phase 15 (a) {t_a:.3f} s, (b) {t_b:.3f} s, (c) {t_c:.3f} s")
    return out, time.perf_counter() - t_phase, mesh_b


def phase15d_shard_ell(np, torch, dev, use, A2k, repeats=5):
    """Phase 15 (d) (3): ``shard_ell`` of (1)'s 2048^2 top A as an f32
    ``ELL``, and of the ELL of its first n/2 columns (``A[:, :n // 2]``,
    from scipy), on 4 shards over the cards ``use`` against the same 4
    shards on ``dev``, each given a plain x (one tensor of the padded
    rows comes back on the controller) and a ``shard_vec`` x (over the
    cards a ``Rows`` comes back): y equal bit for bit on both meshes and for both forms
    of x, the padded rows zero, within 1e-5 of scipy's f64 product of
    the same f32 values (relative to its largest entry); the gather
    kernel launched once a product on each card that holds a stacked
    block (``LAUNCHES_BY_DEVICE``).  Returns, for each mesh and form of
    x, the launches by card, the bytes across cards of a product
    (``Mesh.log``'s ``peer``) and the median wall of ``repeats`` products
    to completion."""
    import scipy.sparse as sp

    from pflare_tpu_torch.parallel import make_mesh, shard_ell, shard_vec
    from pflare_tpu_torch.parallel.mesh import Rows, gather
    from pflare_tpu_torch.sparse import ELL
    from pflare_tpu_torch.sparse import ell as sell
    from pflare_tpu_torch.utils.timers import device_sync_read

    def sync():
        if dev.type == "cuda":
            for c in use:
                torch.cuda.synchronize(c)

    n = A2k.shape[0]
    meshes = {"one card": make_mesh(4, device=dev),
              "cards": make_mesh(devices=[use[s * len(use) // 4]
                                          for s in range(4)])}
    rng = np.random.default_rng(5)
    out = {}
    for name, A in (("square", A2k), ("rectangular", A2k[:, :n // 2])):
        A = sp.csr_matrix(A, dtype=np.float32)
        x = torch.as_tensor(rng.standard_normal(A.shape[1]),
                            dtype=torch.float32, device=dev)
        ref = A.astype(np.float64) @ x.cpu().double().numpy()
        E = ELL.from_scipy(A, torch.float32).to(dev)
        ys, runs = [], {}
        for tag, mesh in meshes.items():
            op = shard_ell(E, mesh)
            want = {}
            for blk in op.blocks:
                if blk is not None:
                    idx = blk.data.device.index
                    want[idx] = want.get(idx, 0) + 1
            for form in ("plain", "sharded"):
                xin = x if form == "plain" else shard_vec(x, mesh)
                sync()
                sell.KERNEL_LAUNCHES = 0
                sell.LAUNCHES_BY_DEVICE.clear()
                mesh.reset_log()
                y = op.matvec(xin)
                launches = dict(sell.LAUNCHES_BY_DEVICE)
                peer = mesh.traffic().get("peer", (0, 0))
                require(isinstance(y, Rows) == (form == "sharded"
                                                and mesh.split),
                        f"phase 15 (d) (3): {name} {tag} {form} x gave a "
                        f"{type(y).__name__}")
                require(launches == want,
                        f"phase 15 (d) (3): {name} {tag} {form} x: gather "
                        f"launches by card {launches}, blocks by card "
                        f"{want}")
                ys.append(gather(y))
                sync()
                walls = []
                for _ in range(repeats):
                    t0 = time.perf_counter()
                    device_sync_read(gather(op.matvec(xin)))
                    sync()
                    walls.append(time.perf_counter() - t0)
                runs[f"{tag} {form}"] = {
                    "launches_by_card": launches, "peer": list(peer),
                    "wall_ms": 1e3 * float(np.median(walls))}
        m = A.shape[0]
        y0 = ys[0]
        same = all(torch.equal(y, y0) for y in ys[1:])
        got = y0.cpu().double().numpy()
        rel = float(np.abs(got[:m] - ref).max() / np.abs(ref).max())
        require(same and y0.shape[0] == 4 * -(-m // 4)
                and not got[m:].any() and rel <= 1e-5,
                f"phase 15 (d) (3): {name} {A.shape}: bit for bit across "
                f"meshes and forms of x {same}, {y0.shape[0]} rows, within "
                f"{rel:.3e} of scipy")
        print(f"# phase 15 (d) (3) shard_ell of the 2048^2 {name} f32 ELL "
              f"{A.shape} on 4 shards over {len(use)} cards: y bit for bit "
              f"the one-card mesh's with a plain and a sharded x: {same}; "
              f"within {rel:.3e} of scipy f64; "
              + "; ".join(f"{k}: launches {v['launches_by_card']}, peer "
                          f"{v['peer'][0]} copies {v['peer'][1]} B, wall "
                          f"{v['wall_ms']:.4f} ms" for k, v in runs.items()),
              flush=True)
        out[name] = {"shape": list(A.shape), "equal": same, "rel_err": rel,
                     "runs": runs}
    return out


def card_busy(torch, fn, label):
    """``fn()`` once under torch.profiler (device activity), to
    completion: its wall seconds and {card index: busy ms} from the
    kernels and copies the trace holds for each card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pflare_tpu_torch.utils.timers import device_sync_read

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        device_sync_read(*fn())
        wall = time.perf_counter() - t0
    busy = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            busy[evt.device_index] = (busy.get(evt.device_index, 0.0)
                                      + evt.self_device_time_total / 1e3)
    print(f"# {label} profiled: wall {wall:.4f} s, busy by card "
          + ", ".join(f"cuda:{k} {v:.3f} ms ({1 - v / 1e3 / wall:.1%} idle)"
                      for k, v in sorted(busy.items())), flush=True)
    return wall, busy


def phase15d(np, torch, tpf, tdia, tbanded, dev, cards, A512, pc2k, A2k,
             b2k):
    """Phase 15 (d): the row mesh over several cards (``cards``, the
    visible ones; with fewer than two it prints that it did not run and
    returns None).  (1) phase 7's 2048^2 f32 hierarchy on 4 shards over
    min(4, cards) cards against the same 4 shards on ``dev`` alone and
    the serial solve (serial, one card twice, cards twice, serial;
    eager, since ``jit=True`` raises on several cards, which is
    checked): norms within 1e-5 of the serial ones, x bit for bit the
    one-card mesh's, each shard's DIA and
    banded blocks on its own card and launched there as often as its
    operator's products (the per-card launch counters), the bytes that
    crossed cards an iteration by level (``Mesh.log``'s ``peer``), wall
    and busy time by card under torch.profiler; (2) phase 15 (a)'s
    8-shard 512^2 f64 distributed setup over the cards against the same
    8 shards on ``dev``: markers equal on every level, R within 1e-11 of
    its largest entry, equal right GMRES iterations; (3) ``shard_ell`` of
    (1)'s top A (``A2k``) and of its first n/2 columns over the cards
    (``phase15d_shard_ell``).  Returns its numbers."""
    from pflare_tpu_torch.parallel import HaloELL, make_mesh
    from pflare_tpu_torch.parallel.mesh import tensor_device
    from pflare_tpu_torch.sparse import DIA, BandedSpMV
    from pflare_tpu_torch.utils.timers import device_sync_read

    if len(cards) < 2:
        print(f"# phase 15 (d) not run ({len(cards)} card visible): the "
              "row mesh over several cards needs two", flush=True)
        return None
    t_phase = time.perf_counter()
    use = list(cards[:4])
    peer = {f"{a}->{b}": bool(torch.cuda.can_device_access_peer(a.index,
                                                                b.index))
            for a in use for b in use if a != b} if dev.type == "cuda" \
        else {}
    print(f"# phase 15 (d) {len(cards)} cards visible, {len(use)} used; "
          f"peer access {peer}", flush=True)
    out = {"cards": [str(c) for c in use], "peer_access": peer}

    # (1) the 2048^2 solve on 4 shards over the cards
    one = make_mesh(PHASE15_SHARDS["solve"], device=dev)
    multi = make_mesh(devices=[use[s * len(use) // 4] for s in range(4)])
    require(multi.split, "phase 15 (d): the mesh is not split")
    try:
        pc2k.solve_device(b2k, max_it=10, mesh=multi)
        raised = None
    except NotImplementedError as exc:
        raised = str(exc)
    require(not pc2k.jit or not dev.type == "cuda" or raised,
            "phase 15 (d): jit=True over several cards did not raise")

    def zero():
        for mod in (tdia, tbanded):
            mod.KERNEL_LAUNCHES = 0
            mod.LAUNCHES_BY_DEVICE.clear()

    def solve(mesh):
        zero()
        if mesh is not None:
            mesh.reset_log()
        t0 = time.perf_counter()
        x, norms = pc2k.solve_device(b2k, max_it=10, ksp="richardson",
                                     mesh=mesh)
        device_sync_read(x, norms)
        return (norms.cpu().numpy(), time.perf_counter() - t0,
                {k: dict(m.LAUNCHES_BY_DEVICE) for k, m in
                 (("dia", tdia), ("banded", tbanded))},
                None if mesh is None else
                {k: list(v) for k, v in mesh.log.items()}, x)

    jit, pc2k.jit = pc2k.jit, False
    try:
        # a PCAIR holds one mesh's sharded state: each mesh's runs
        # together, its state built before them
        runs = {}   # tag: [(norms, s, launches by card, log, x), ...]
        runs["serial"] = [solve(None)]
        pc2k._distributed_state(one)
        runs["one card"] = [solve(one), solve(one)]
        wall_1, busy_1 = card_busy(torch, lambda: pc2k.solve_device(
            b2k, max_it=10, ksp="richardson", mesh=one),
            "phase 15 (d) 2048^2 on 4 shards on one card (eager)")
        st = pc2k._distributed_state(multi)
        ops = [("top", st.top)] + [
            (f"level {i} {k}", getattr(v, "mat", v))
            for i, lev in enumerate(st.levels) for k, v in lev.items()]
        ops = list({id(op): (label, op) for label, op in ops
                    if hasattr(op, "blocks")}.values())
        holders = set()
        for _, op in ops:
            for s, blk in enumerate(op.blocks):
                if isinstance(blk, (DIA, BandedSpMV)):
                    require(blk.data.device
                            == tensor_device(multi.devices[s]),
                            f"phase 15 (d): shard {s}'s block on "
                            f"{blk.data.device}")
                    holders.add(multi.devices[s])
        require(holders == set(use), f"phase 15 (d): DIA and banded "
                f"shard blocks on {holders}, cards {use}")
        runs["cards"] = [solve(multi), solve(multi)]
        wall_m, busy_m = card_busy(torch, lambda: pc2k.solve_device(
            b2k, max_it=10, ksp="richardson", mesh=multi),
            "phase 15 (d) 2048^2 on 4 shards over the cards (eager)")
        runs["serial"].append(solve(None))
    finally:
        pc2k.jit = jit
    n_s, n_1, n_m = (runs[t][0][0] for t in ("serial", "one card", "cards"))
    for tag, n_x in (("cards", n_m), ("one card", n_1)):
        require(np.all(np.abs(n_x - n_s) <= MESH_HISTORY_RTOL * n_s),
                f"phase 15 (d): {tag} norms {n_x / n_s[0]} against serial "
                f"{n_s / n_s[0]}")
    _, _, launches, log, x_m = runs["cards"][0]
    # every row sums as on one card (the stacked blocks take one card's
    # lanes), so only the norms' partial sums differ
    same_x = bool(torch.equal(x_m, runs["one card"][0][4]))
    require(same_x, "phase 15 (d): x over the cards differs from the "
            "one-card mesh's")
    # each card launches its own shards' blocks once a product of their
    # operator; the controller also runs the whole levels
    want = {"dia": {}, "banded": {}}
    for _, op in ops:
        calls = (log.get((op.label, "ppermute"), [0])[0] // 2
                 if isinstance(op, HaloELL)
                 else log.get((op.label, "all_gather"), [0])[0])
        for s, blk in enumerate(op.blocks):
            kind = ("dia" if isinstance(blk, DIA) else "banded"
                    if isinstance(blk, BandedSpMV) else None)
            if kind:
                idx = blk.data.device.index
                want[kind][idx] = want[kind].get(idx, 0) + calls
    for kind in ("dia", "banded"):
        for idx, n in want[kind].items():
            got = launches[kind].get(idx, 0)
            require(got == n if idx != dev.index else got >= n,
                    f"phase 15 (d): {kind} launches on cuda:{idx} {got}, "
                    f"its shards' products {n}")
    per_level = {}
    for (label, kind), (calls, nbytes) in log.items():
        if kind == "peer":
            key = label.rsplit(" ", 1)[0] if label.startswith("level") \
                else label
            c, b = per_level.get(key, (0, 0))
            per_level[key] = (c + calls / 10, b + nbytes / 10)
    walls = {tag: " / ".join(f"{r[1]:.4f}" for r in rs)
             for tag, rs in runs.items()}
    print(f"# phase 15 (d) 2048^2 f32 Richardson 10 its on 4 shards over "
          f"{len(use)} cards (eager; jit=True raises: {bool(raised)}): "
          f"wall to completion serial {walls['serial']} s, one card "
          f"{walls['one card']} s, cards {walls['cards']} s; norms within "
          f"{np.max(np.abs(n_m - n_s) / n_s):.3e} of serial (one card "
          f"{np.max(np.abs(n_1 - n_s) / n_s):.3e}), x bit for bit the "
          f"one-card mesh's: {same_x}; launches by card "
          f"{launches}, the shards' products {want}; bytes across cards an "
          "iteration " + ", ".join(f"{k} {c:.1f} copies {b / 1e6:.4f} MB"
                                   for k, (c, b) in sorted(
                                       per_level.items())), flush=True)
    out["solve"] = {"walls_s": walls, "x_equals_one_card": same_x,
                    "launches_by_card": launches,
                    "shard_products_by_card": want,
                    "peer_per_iteration": per_level,
                    "profiled_wall_s": wall_m, "busy_ms_by_card": busy_m,
                    "one_card_profiled_wall_s": wall_1,
                    "one_card_busy_ms": busy_1}

    # (2) the 8-shard 512^2 f64 distributed setup over the cards
    b512 = np.random.default_rng(3).standard_normal(A512.shape[0])
    opts = bench_options(tpf).replace(**PHASE15_SETS[0][1])
    got = []
    for mesh in (make_mesh(PHASE15_SHARDS["setup"], device=dev),
                 make_mesh(devices=[use[s * len(use) // 8]
                                    for s in range(8)])):
        pc = tpf.PCAIR(opts, dtype=torch.float64, device=dev)
        t0 = time.perf_counter()
        pc.setup(A512, mesh=mesh)
        t_set = time.perf_counter() - t0
        # the host levels, read before the solve's upload releases them
        levels = [(lv.fine, lv.coarse, lv.R.copy())
                  for lv in pc.hierarchy.levels]
        res = pc.solve(b512, side="right", rtol=1e-10, max_it=60)
        got.append((levels, t_set, res, mesh))
    (h1, t1, r1, _), (hm, tm, rm, mm) = got
    require(len(h1) == len(hm), f"phase 15 (d): levels {len(hm)} against "
            f"{len(h1)}")
    r_rel = 0.0
    for i, ((f1, c1, R1), (fm, cm, Rm)) in enumerate(zip(h1, hm)):
        require(np.array_equal(f1, fm) and np.array_equal(c1, cm),
                f"phase 15 (d): level {i} markers differ")
        r_rel = max(r_rel, abs(R1 - Rm).max() / abs(R1).max())
    require(r_rel <= 1e-11 and r1.converged and rm.converged
            and r1.iterations == rm.iterations,
            f"phase 15 (d): R within {r_rel:.3e}, right GMRES "
            f"{rm.iterations} its against {r1.iterations}")
    setup_peer = {k: v for k, v in mm.traffic().items()}
    print(f"# phase 15 (d) 512^2 f64 setup on 8 shards over {len(use)} "
          f"cards: {len(hm)} levels, markers equal on every level, "
          f"R within {r_rel:.3e} of its largest entry, right GMRES "
          f"{rm.iterations} its (one card {r1.iterations}); setup "
          f"{tm:.3f} s (one card {t1:.3f} s); exchanges {setup_peer}",
          flush=True)
    out["setup"] = {"levels": len(hm), "r_rel": r_rel,
                    "iterations": rm.iterations, "setup_s": tm,
                    "one_card_setup_s": t1, "traffic": setup_peer}

    # (3) shard_ell over the cards, square and rectangular
    out["shard_ell"] = phase15d_shard_ell(np, torch, dev, use, A2k)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"# phase 15 (d): {out['seconds']:.3f} s", flush=True)
    return out


# ~~~~~~~~~~ phase 16: the example and notebook twins ~~~~~~~~~~

# (twin, main's arguments) of phase 16: the main path at sizes users run
# (ex_airg_advection at 1024^2, ex_scaling up to 1024^2), the others at
# their JAX examples' own sizes
PHASE16_EXAMPLES = (
    ("ex_airg_advection", (1024,)),
    ("ex_scaling", ((256, 512, 1024),)),
    ("ex_cf_splitting", ()),
    ("ex_complexities", ()),
    ("ex_device_setup", (64,)),
    ("ex_getcoeffs", ()),
    ("ex_pflareinv_options", ()),
    ("ex_reuse", ()),
)
PHASE16_MAIN_PATH = ("ex_airg_advection", "ex_scaling")
PHASE16_NOTEBOOKS = ("01_intro_pcair", "02_polynomial_inverses",
                     "03_cf_splittings", "04_parallel_mesh",
                     "05_reuse_device_resetup", "06_meshes_and_fem")


def _twin_rule(np, tpf, name, out):
    """(passed, iterations, what was checked) of a twin's result against
    its example's own rule."""
    if name == "ex_airg_advection":
        n = int(round(out["unknowns"] ** 0.5))
        A = tpf.adv_diff_2d(n)
        b = np.random.default_rng(0).standard_normal(A.shape[0])
        true = float(np.linalg.norm(A @ out["x"] - b) / np.linalg.norm(b))
        return (out["converged"] and true <= 1e-8, out["iterations"],
                f"right GMRES rtol 1e-10 converged {out['converged']}, "
                f"{out['levels']} levels, true residual {true:.3e} <= 1e-8")
    if name == "ex_scaling":
        rows = out["rows"]
        return (all(r["converged"] and r["iterations"] <= 6 for r in rows),
                [r["iterations"] for r in rows],
                "<= 6 right GMRES its at rtol 1e-10 at every size: " + ", ".join(
                    f"{r['n']}^2 {r['iterations']} its, setup "
                    f"{r['setup_s']:.3f} s, solve {r['solve_s']:.4f} s"
                    for r in rows))
    if name == "ex_cf_splitting":
        return (out["diag_dom_max_ratio"] < 0.5, None,
                f"diag-dom submatrix {out['diag_dom_rows']} rows, max ratio "
                f"{out['diag_dom_max_ratio']:.3f} < 0.5; splittings "
                f"{out['splittings']}")
    if name == "ex_complexities":
        return (out["ci_grid_complexity"] < 3.0, None,
                f"8^2 grid complexity {out['ci_grid_complexity']:.3f} < 3")
    if name == "ex_device_setup":
        h, hs = out["norms"], out["sharded_norms"]
        same = bool(np.all(np.abs(hs - h) <= MESH_HISTORY_RTOL * h))
        return (out["device_true_residual"] <= 1e-4 and same,
                out["device_n_levels"],
                f"device setup {out['device_setup_s']:.3f} s, true residual "
                f"{out['device_true_residual']:.3e} <= 1e-4; sharded norms "
                f"within {MESH_HISTORY_RTOL} of unsharded {same}, max abs "
                f"diff {out['sharded_max_abs_diff']:.3e}, schedule "
                f"{out['schedule']}")
    if name == "ex_getcoeffs":
        return (out["restored_identical"], None,
                f"restored preconditioner identical (max abs diff "
                f"{out['restore_max_abs_diff']:.3e}), level orders "
                f"{out['level_orders']}")
    if name == "ex_pflareinv_options":
        return (all(c for c, _ in out.values()),
                {f"{k[0]} {k[1]}": its for k, (_, its) in out.items()},
                "every inverse type converges to rtol 1e-8 within 100 its")
    if name == "ex_reuse":
        return (out["reuse_setup_s"] < out["full_setup_s"]
                and abs(out["iterations_reuse"] - out["iterations"]) <= 1,
                (out["iterations"], out["iterations_reuse"]),
                f"reuse setup {out['reuse_setup_s']:.4f} s < full "
                f"{out['full_setup_s']:.4f} s, equal iterations (+-1)")
    r = out["results"]
    if name == "01_intro_pcair":
        its = {n: v[0] for n, v in r["airg"].items()}
        return (max(its.values()) <= 6, its,
                "AIRG right GMRES <= 6 its at rtol 1e-10 at every size")
    if name == "02_polynomial_inverses":
        its = list(r["mf"].values()) + [r["assembled"][1]]
        return (max(its) < 100, its, "every GMRES converges within 100 its")
    if name == "03_cf_splittings":
        its = {k: v[0] for k, v in r["solves"].items()}
        return (max(its.values()) < 40 and r["diag_dom"][1] < 0.6, its,
                "every splitting converges within 40 its; diag-dom max "
                f"ratio {r['diag_dom'][1]:.3f} < 0.6")
    if name == "04_parallel_mesh":
        return (r["sharded_spmv_matches"] and r["tsqr_matches"]
                and r["halo_max_err"] <= 1e-12
                and math.isfinite(r["vcycle_norm"]), None,
                f"sharded SpMV and TSQR match, halo error "
                f"{r['halo_max_err']:.3e}, V-cycle norm "
                f"{r['vcycle_norm']:.6f}, schedule {r['schedule']}")
    if name == "05_reuse_device_resetup":
        its = [r["host_resetup_iterations"]] + [s[1] for s in r["steps"]]
        return (max(its) <= its[0] + 1, its,
                "each device re-setup's solve within 1 it of the host "
                "re-setup's")
    if name == "06_meshes_and_fem":
        its = {"dg1": r["dg1"][2], "annulus": r["annulus"][2],
               "supg": r["supg"][False], "supg diag-scaled": r["supg"][True]}
        return (its["dg1"] <= 4 and its["annulus"] <= 4
                and its["supg diag-scaled"] <= its["supg"], its,
                "DG(1) and annulus Richardson <= 4 its (the reference's "
                "cap), diag scaling no worse")
    raise KeyError(name)


def phase16(np, torch, tpf, tdia, tbanded, dev, plain_matvec, err):
    """The 8 example twins (examples/torch/) and the 6 notebook twins
    (notebooks/torch/) on the card, in this process: each with the
    launch counters at 0 before it, its output printed under "# |", its
    seconds, iterations and its example's own rule (``_twin_rule``);
    ex_airg_advection and ex_scaling must launch both kernels, each
    held once against its plain version on their hierarchy's level-0 A
    and level-1 P.  Returns ({twin: {"launches", "iterations"}}, seconds).
    """
    import contextlib
    import importlib.util
    import io

    from pflare_tpu_torch.sparse import DIA, BandedSpMV

    t_phase = time.perf_counter()
    jobs = [(name, os.path.join(HERE, "examples", "torch", name + ".py"),
             args) for name, args in PHASE16_EXAMPLES]
    jobs += [(name, os.path.join(HERE, "notebooks", "torch", name + ".py"),
              None) for name in PHASE16_NOTEBOOKS]
    runs = {}
    for name, path, args in jobs:
        tdia.KERNEL_LAUNCHES = 0
        tbanded.KERNEL_LAUNCHES = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            if args is None:
                out = run_notebook(path, device=str(dev))
            else:
                spec = importlib.util.spec_from_file_location(
                    "_twin_" + name, path)
                module = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(module)
                out = module.main(*args, device=str(dev))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"dia": tdia.KERNEL_LAUNCHES,
                    "banded": tbanded.KERNEL_LAUNCHES}
        for line in buf.getvalue().splitlines():
            print(f"# | {line}")
        ok, its, note = _twin_rule(np, tpf, name, out)
        print(f"# phase 16 {name}: {seconds:.3f} s, iterations {its}, "
              f"launches {launches}, {'pass' if ok else 'FAIL'}: {note}",
              flush=True)
        require(ok, f"phase 16 {name}: its example's rule failed: {note}")
        runs[name] = {"launches": launches, "iterations": its,
                      "seconds": seconds}
        if name not in PHASE16_MAIN_PATH:
            continue
        require(launches["dia"] > 0 and launches["banded"] > 0,
                f"phase 16 {name}: a kernel of the main path was not "
                f"launched: {launches}")
        dh = out["pc"].upload()
        for label, op, cls, group in (
                ("level-0 A", dh.top, DIA, "aligned"),
                ("level-1 P", dh.levels[1]["P"], BandedSpMV, "banded")):
            require(isinstance(op, cls), f"phase 16 {name}: the {label} is "
                    f"a {type(op).__name__}, not a {cls.__name__}")
            x = torch.as_tensor(np.random.default_rng(3).standard_normal(
                op.shape[1]), dtype=op.dtype, device=dev)
            y, ref = op.matvec(x), plain_matvec(op, x)
            torch.cuda.synchronize()
            rel = float((y - ref).norm() / ref.norm())
            tol = TOL[str(op.dtype).split(".")[-1]]
            require(rel <= tol, f"phase 16 {name} {label}: kernel vs plain "
                    f"relative error {rel:.3e} > {tol}")
            err[group] = max(err[group], float((y - ref).abs().max()))
            print(f"# phase 16 {name}: {label} {cls.__name__} {op.shape} "
                  f"{op.dtype}, kernel vs plain rel err {rel:.3e}")
        del out, dh
    return runs, time.perf_counter() - t_phase


# ~~~~~~~~~~ phase 17: the one-program solve ~~~~~~~~~~

def _device_ops(dh):
    """(label, container) of every operator of a device hierarchy, each
    once: the top, the levels' operators, their inverses' and the coarse
    inverse's (a matrix-free inverse runs on its level's operator)."""
    seen, ops = set(), []

    def add(label, op):
        if id(op) not in seen:
            seen.add(id(op))
            ops.append((label, op))

    add("top A", dh.top)
    for i, lev in enumerate(dh.levels):
        for key, val in lev.items():
            if key.startswith("inv_"):
                if val.kind not in ("diagonal", "dense"):
                    add(f"level {i} {key}", val.mat)
            elif key not in ("mask_f", "mask_c", "coarse"):
                add(f"level {i} {key}", val)
    if dh.coarse_inv.kind not in ("diagonal", "dense"):
        add("coarse inverse", dh.coarse_inv.mat)
    return ops


def phase17(np, torch, tdia, tbanded, sell, dev, cases, parity, mesh,
            install_check, measure, profile_solve, plain_matvec, err, timed):
    """The one-program solve (see the module docstring, phase 17).
    ``cases``: (label, PCAIR, b, A) of the 512^2 and 2048^2 f32 main
    path; ``parity``: phase 6's f64 PCAIR and matrix; ``mesh``: phase 15
    (b)'s.  Returns ({label: numbers}, seconds)."""
    from pflare_tpu_torch.solvers.jitted import gmres_stationary
    from pflare_tpu_torch.sparse import ELL, TELL
    from pflare_tpu_torch.utils import graphs
    from pflare_tpu_torch.utils.timers import device_sync_read

    t_phase = time.perf_counter()

    def counts():
        return {"dia": tdia.KERNEL_LAUNCHES, "banded": tbanded.KERNEL_LAUNCHES,
                "sell": sell.KERNEL_LAUNCHES}

    def run(pcx, jit, fn):
        """``fn()`` with ``pcx.jit`` set and the counters at 0: (its
        output, seconds to completion, launches)."""
        pcx.jit = jit
        tdia.KERNEL_LAUNCHES = tbanded.KERNEL_LAUNCHES = 0
        sell.KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        out = fn()
        device_sync_read(*(out if isinstance(out, tuple)
                           else [out if torch.is_tensor(out) else out.x]))
        seconds = time.perf_counter() - t0
        pcx.jit = True
        return out, seconds, counts()

    def same(a, b):
        return all(bool(torch.equal(u, v)) for u, v in zip(a, b))

    out = {}
    # (a) jit=True against jit=False on the main path, each warm
    for label, pcx, bx, A in cases:
        n = A.shape[0]
        rng = np.random.default_rng(17)
        r1, r2 = (torch.as_tensor(rng.standard_normal(n), dtype=pcx.dtype,
                                  device=dev) for _ in range(2))
        run(pcx, True, lambda: pcx.apply(r1))     # captures if not yet
        y1, t_ag, l_ag = run(pcx, True, lambda: pcx.apply(r1))
        keep = y1.clone()
        y2, _, _ = run(pcx, True, lambda: pcx.apply(r2))
        e1, t_ae, l_ae = run(pcx, False, lambda: pcx.apply(r1))
        e2, _, _ = run(pcx, False, lambda: pcx.apply(r2))
        require(same((y1, y2), (e1, e2)) and torch.equal(y1, keep)
                and l_ag == l_ae, f"phase 17 {label}: apply through its "
                "graph differs from the eager apply, aliases its last "
                f"result or counts other launches ({l_ag} / {l_ae})")
        sd = {True: [], False: []}
        for jit in (True, False, False, True):
            sd[jit].append(run(pcx, jit,
                               lambda: pcx.solve_device(bx, max_it=10)))
        (g, t_g1, l_g), (e, t_e1, l_e) = sd[True][0], sd[False][0]
        require(same(g, e) and same(sd[True][1][0], e) and l_g == l_e,
                f"phase 17 {label}: solve_device through its graph is not "
                f"the eager solve bit for bit (launches {l_g} / {l_e})")
        x0 = torch.as_tensor(rng.standard_normal(n), dtype=pcx.dtype,
                             device=dev)
        run(pcx, True, lambda: pcx.solve_device(bx, max_it=10, x0=x0))
        g0, _, _ = run(pcx, True,
                       lambda: pcx.solve_device(bx, max_it=10, x0=x0))
        e0, _, _ = run(pcx, False,
                       lambda: pcx.solve_device(bx, max_it=10, x0=x0))
        require(same(g0, e0), f"phase 17 {label}: solve_device(x0=) "
                "through its graph is not the eager solve bit for bit")
        walls = {jit: min(r[1] for r in rs) for jit, rs in sd.items()}
        sdp = profile_solve(pcx, bx, f"phase 17 {label} solve_device")
        prof = {True: sdp, False: sdp["eager"]}
        # right GMRES: the graphs against the same stationary GMRES run
        # eagerly (bit for bit) and against jit=False's krylov.gmres
        kw = dict(rtol=1e-5, side="right")
        gm = {True: [], False: []}
        for jit in (True, False, False, True):
            gm[jit].append(run(pcx, jit, lambda: pcx.solve(bx, **kw)))
        rg, re_ = gm[True][1][0], gm[False][1][0]
        dh = pcx.upload()
        bi = pcx._to_internal(pcx._vector(bx))
        _, its_s, hist_s, _ = gmres_stationary(
            dh.top.matvec, pcx._precond(dh), bi, None, 1e-5, 1e-50, 10000,
            30, "right")
        require(rg.converged and rg.iterations == its_s
                and np.array_equal(rg.history, hist_s[:its_s + 1]),
                f"phase 17 {label}: GMRES through graphs ({rg.iterations} "
                f"its) is not the eager stationary GMRES ({its_s})")
        require(rg.iterations == re_.iterations, f"phase 17 {label}: GMRES "
                f"its {rg.iterations} with graphs, {re_.iterations} "
                "with jit=False")
        gap = float(np.max(np.abs(rg.history - re_.history) / re_.history))
        captures = {f"{key[0]} {key[1]}": prog.capture_s
                    for key, prog in pcx._programs.items()}
        nodes = graph_launches(pcx, f"phase 17 {label}")
        # the device busy and idle share of one warm apply and GMRES solve
        extra = {}
        for what, fn in (("apply", lambda: pcx.apply(r1)),
                         ("gmres", lambda: pcx.solve(bx, **kw))):
            for jit in (True, False):
                pcx.jit = jit
                try:
                    extra[(what, jit)] = profiled(
                        torch, fn, f"phase 17 {label} {what} "
                        f"({'graphs' if jit else 'eager'})")
                finally:
                    pcx.jit = True
        row = {
            "apply_ms": {"graph": t_ag * 1e3, "eager": t_ae * 1e3},
            "apply_launches": l_ag,
            "solve_device_s": {"graph": walls[True], "eager": walls[False]},
            "solve_device_launches_per_iteration": {
                k: v / 10 for k, v in l_g.items()},
            "profiled": {"graph": prof[True], "eager": prof[False]},
            "profiled_apply": {"graph": extra[("apply", True)],
                               "eager": extra[("apply", False)]},
            "profiled_gmres": {"graph": extra[("gmres", True)],
                               "eager": extra[("gmres", False)]},
            "gmres": {"iterations": rg.iterations,
                      "graph_s": min(r[1] for r in gm[True]),
                      "eager_s": min(r[1] for r in gm[False]),
                      "history_gap_to_jit_false": gap,
                      "launches_per_iteration": {
                          k: v / rg.iterations
                          for k, v in gm[True][1][2].items()}},
            "capture_s": captures,
            "graph_kernel_nodes": nodes,
        }
        out[label] = row
        print(f"# phase 17 {label} f32: apply graph {t_ag * 1e3:.3f} ms, "
              f"eager {t_ae * 1e3:.3f} ms (equal bits, launches {l_ag}); "
              f"solve_device 10 its graph {walls[True]:.4f} s, eager "
              f"{walls[False]:.4f} s (equal bits, x0 given too; launches an "
              f"iteration {row['solve_device_launches_per_iteration']}); "
              f"profiled wall / busy / idle graph "
              f"{prof[True]['wall_s']:.4f} s / {prof[True]['busy_ms']:.3f} "
              f"ms / {1 - prof[True]['busy_ms'] / 1e3 / prof[True]['wall_s']:.1%}"
              f", eager {prof[False]['wall_s']:.4f} s / "
              f"{prof[False]['busy_ms']:.3f} ms / "
              f"{1 - prof[False]['busy_ms'] / 1e3 / prof[False]['wall_s']:.1%}"
              f"; right GMRES rtol 1e-5 {rg.iterations} its (eager "
              f"stationary equal bit for bit, jit=False {re_.iterations} "
              f"its, histories within {gap:.3e}), graph "
              f"{row['gmres']['graph_s']:.4f} s, eager "
              f"{row['gmres']['eager_s']:.4f} s; capture s {captures}",
              flush=True)

    # phase 6's f64 parity configuration: phase 6's history rule
    pc64, A512 = parity
    n = A512.shape[0]
    kw = dict(x0=np.ones(n), rtol=1e-10, atol=1e-50, max_it=6, side="right")
    rg, _, _ = run(pc64, True, lambda: pc64.solve(np.zeros(n), **kw))
    re_, _, _ = run(pc64, False, lambda: pc64.solve(np.zeros(n), **kw))
    h, he = rg.history, re_.history
    require(rg.iterations == re_.iterations and len(h) == len(he)
            and np.all(np.abs(h - he) <= HISTORY_RTOL * he
                       + HISTORY_FLOOR * he[0]),
            "phase 17: f64 parity GMRES with graphs against jit=False: "
            f"{h} / {he}")
    out["512^2 f64 parity gmres"] = {
        "iterations": rg.iterations,
        "history_gap": float(np.max(np.abs(h - he) / he))}
    print(f"# phase 17 512^2 f64 parity right GMRES: {rg.iterations} its "
          f"with graphs and with jit=False, histories within "
          f"{out['512^2 f64 parity gmres']['history_gap']:.3e} of each norm")

    # (b) the install check, made at the end of phase 12 (b)
    out["install"] = install_check

    # (c) phase 15 (b)'s 4-shard solve_device: its graph against eager
    pcx, bx = cases[1][1], cases[1][2]
    sharded = {}
    for jit in (True, False, False, True):
        mesh.reset_log()
        res = run(pcx, jit, lambda: pcx.solve_device(bx, max_it=10,
                                                     mesh=mesh))
        sharded.setdefault(jit, []).append(
            res + ({k: tuple(v) for k, v in mesh.log.items()},))
    (g, _, l_g, log_g), (e, _, l_e, log_e) = sharded[True][0], \
        sharded[False][0]
    require(same(g, e) and same(sharded[True][1][0], e) and l_g == l_e
            and log_g == log_e,
            "phase 17 (c): the sharded solve through its graph is not the "
            f"eager one (launches {l_g} / {l_e}, exchanges equal "
            f"{log_g == log_e})")
    graph_launches(pcx, "phase 17 (c)")
    out["mesh"] = {"shards": mesh.size,
                   "graph_s": min(r[1] for r in sharded[True]),
                   "eager_s": min(r[1] for r in sharded[False]),
                   "launches_per_iteration": {k: v / 10
                                              for k, v in l_g.items()},
                   "exchanges": sum(c for c, _ in log_g.values())}
    print(f"# phase 17 (c) 2048^2 on {mesh.size} shards: graph equals eager "
          f"bit for bit, launches {l_g}, {out['mesh']['exchanges']} "
          f"exchanges logged in each; wall graph "
          f"{out['mesh']['graph_s']:.4f} s, eager "
          f"{out['mesh']['eager_s']:.4f} s", flush=True)

    # (d) the gather kernel against its plain version, bit for bit, on
    # every TELL and the coarse ELL
    for label, pcx, _, _ in cases:
        dh = pcx.upload()
        gathers = [(lab, op) for lab, op in _device_ops(dh)
                   if isinstance(op, (TELL, ELL))]
        tells = [(lab, op) for lab, op in gathers if isinstance(op, TELL)]
        require(tells and isinstance(dh.coarse_inv.mat, ELL),
                f"phase 17 {label}: the hierarchy has no TELL or no coarse "
                "ELL")
        rng = np.random.default_rng(5)
        for lab, op in gathers:
            for dtype in (torch.float32, torch.float64):
                M = type(op)(op.pattern, op.data.to(dtype), op.cols)
                x = torch.as_tensor(rng.standard_normal(op.shape[1]),
                                    dtype=dtype, device=dev)
                y, ref = M.matvec(x), plain_matvec(M, x)
                # the container's own product as the CPU runs it (the
                # slot loop, or the gather and row sum): its sum order
                # differs from the kernel's where a row has several lanes
                own = (sell.tell_spmv_plain(M.data, M.cols, x)
                       if isinstance(M, TELL) else
                       (M.data * x[M.cols.long()]).sum(dim=1))
                torch.cuda.synchronize()
                require(torch.equal(y, ref), f"phase 17 {label} {lab} "
                        f"{dtype}: the gather kernel differs from its plain "
                        f"version by {float((y - ref).abs().max()):.3e}")
                gap = float((y - own).abs().max() / own.abs().max())
                require(gap <= {torch.float32: 1e-6,
                                torch.float64: 1e-14}[dtype],
                        f"phase 17 {label} {lab} {dtype}: the kernel is "
                        f"{gap:.3e} of max |y| from the container's plain "
                        "product")
                err["sell"] = max(err["sell"], float((y - ref).abs().max()))
        # the upload's packing, again from the row lengths: each index
        # built anew on the card (the patterns' caches cleared) and each
        # container packed by it
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _, op in gathers:
            op.pattern._packs.clear()
            sell.pack(op)
        torch.cuda.synchronize()
        t_pack = time.perf_counter() - t0
        packed = sum(op.packed.nbytes for _, op in gathers)
        index = sum(op.packed.index.nbytes for _, op in gathers)
        stored = sum(op.data.numel() * (op.data.element_size() + 4)
                     for _, op in gathers)
        nnz = sum(op.nnz for _, op in gathers)
        out[f"{label} packed"] = {"operators": len(gathers),
                                  "nonzeros": nnz, "packed_bytes": packed,
                                  "index_bytes": index,
                                  "stored_bytes": stored,
                                  "index_and_pack_s": t_pack}
        print(f"# phase 17 {label}: the gather kernel equals its plain "
              f"version bit for bit in f32 and f64 on {len(gathers)} "
              "operators: " + ", ".join(
                  f"{lab} {type(op).__name__} {op.shape[0]} rows "
                  f"K={op.pattern.K} L={op.packed.lanes}"
                  for lab, op in gathers)
              + f"; packed copies {packed} B (index {index} B) for {nnz} "
              f"nonzeros, beside {stored} B of padded tensors; every index "
              f"built and copy packed again in {t_pack:.4f} s", flush=True)
        lab, op = max(tells, key=lambda lo: lo[1].data.numel())
        timed["sell"][:0] = [measure(f"{label} {lab}", op),
                             measure(f"{label} coarse inverse",
                                     dh.coarse_inv.mat)]

    # (e) a capture that fails raises, with no eager fallback
    prog = graphs.Programs(dev).get(None, ("sync",),
                                    lambda v: v * float(v.sum()))
    try:
        prog(torch.ones(4, device=dev))
        raised = False
    except RuntimeError as exc:
        raised = "capture" in str(exc)
    torch.cuda.synchronize()
    require(raised, "phase 17 (e): a capture with a host read did not raise")
    require(float((torch.ones(4, device=dev) * 2).sum()) == 8.0,
            "phase 17 (e): the card is not usable after a failed capture")
    print("# phase 17 (e) a capture with a host read raised; the card "
          "works after it")
    return out, time.perf_counter() - t_phase


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
