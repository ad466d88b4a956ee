"""``PCAIR(jit=)`` and its CUDA-graph programs (``utils/graphs.py``), on
the CPU.

There is no CUDA graph here, so ``RecordingGraph`` stands in for one:
its capture runs the function and records it with its static inputs, its
replay runs it again into the static outputs and then puts back what that
run counted, since a real replay runs no Python.  With it in
``graphs.GRAPH`` and ``graphs.enabled`` true for the CPU, a PCAIR takes
its card's path: these tests hold the helper's bookkeeping (static
buffers, counter replay, the cache and when it is dropped) and that a
replay after each change of operators equals an eager solve on the new
ones.  ``PCAIR(jit=False)`` is held to ``pflare_tpu.PCAIR(jit=False)``
(the host-driven GMRES in both).  The grids stay at 32^2 or less.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pflare_tpu as jpf
import pflare_tpu_torch as tpf
from pflare_tpu_torch.air import pcair as tpcair
from pflare_tpu_torch.parallel import make_mesh, mesh as tmesh
from pflare_tpu_torch.solvers import jitted, krylov
from pflare_tpu_torch.sparse import dia as tdia
from pflare_tpu_torch.sparse import ell as tell
from pflare_tpu_torch.utils import graphs
from torch_reference import host_kernels  # noqa: F401

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
HISTORY_RTOL = 1e-8     # tests/test_torch_solvers.py's rule
HISTORY_FLOOR = 1e-12


class RecordingGraph:
    """A CPU stand-in for ``graphs.TorchGraph``."""

    captures = replays = 0

    def __init__(self, pool, device):
        self.fn = self.args = self.out = None

    def capture(self, fn, args):
        RecordingGraph.captures += 1
        self.fn, self.args = fn, args
        self.out = fn(*args)
        return self.out

    def replay(self):
        RecordingGraph.replays += 1
        counters = graphs.read_counters()
        record = tmesh.Mesh.record
        tmesh.Mesh.record = lambda *a, **k: None
        try:
            out = self.fn(*self.args)
        finally:
            tmesh.Mesh.record = record
            graphs.write_counters(counters)
        for static, new in zip(graphs._tensors(self.out),
                               graphs._tensors(out)):
            static.copy_(new)


class FailingGraph(RecordingGraph):
    def capture(self, fn, args):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")


@pytest.fixture
def recorded(monkeypatch):
    """The card's path on the CPU: graphs on, ``RecordingGraph`` in."""
    monkeypatch.setattr(graphs, "enabled", lambda device: True)
    monkeypatch.setattr(graphs, "GRAPH", RecordingGraph)
    RecordingGraph.captures = RecordingGraph.replays = 0
    return RecordingGraph


def _opts(**kw):
    return tpf.AIROptions().replace(reuse_sparsity=True, reuse_amount=3,
                                    reuse_poly_coeffs=True, max_levels=4,
                                    **kw)


def _perturbed(A, seed):
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 0.05 * np.random.default_rng(seed)
                         .standard_normal(A2.nnz))
    return A2


def _rhs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


def _eager(pc, fn):
    """``fn()`` with ``pc.jit`` off: the eager path, no graph."""
    pc.jit = False
    try:
        return fn()
    finally:
        pc.jit = True


def test_program_static_buffers_and_no_aliasing(recorded):
    """A replay copies its input into the static buffer and clones its
    output: apply(r1) then apply(r2) leaves r1's result as it was, and no
    result is the static output."""
    prog = graphs.Program(lambda v: (2.0 * v + 1.0, v.sum()), None, "cpu")
    r1, r2 = torch.arange(5.0), torch.ones(5)
    first = prog(r1)                 # warm-up, then the capture
    assert prog.graph is not None and recorded.captures == 1
    y1, s1 = prog(r1)
    keep = y1.clone()
    y2, s2 = prog(r2)
    assert torch.equal(y1, keep) and torch.equal(y1, first[0])
    assert torch.equal(y2, 2.0 * r2 + 1.0) and float(s2) == 5.0
    assert y2.data_ptr() != prog._outputs[0].data_ptr()
    r2 += 1.0                        # the caller's tensor, not the buffer
    assert torch.equal(prog._inputs[0], torch.ones(5))
    assert recorded.replays == 2 and recorded.captures == 1
    with pytest.raises(ValueError, match="captured for"):
        prog(torch.ones(6))


def test_counters_advance_by_the_capture_delta_per_replay(recorded):
    """The launch counters and a mesh's exchange log read after replays
    what they would after eager runs: the warm-up counts once, the capture
    nothing, each replay its delta."""
    mesh = make_mesh(2, device="cpu")

    def fn(v):
        tdia.KERNEL_LAUNCHES += 2
        tell.KERNEL_LAUNCHES += 1
        mesh.record("top", "ppermute", 16)
        return v + 1.0

    prog = graphs.Program(fn, None, "cpu", meshes=(mesh,))
    tdia.KERNEL_LAUNCHES = tell.KERNEL_LAUNCHES = 0
    mesh.reset_log()
    for _ in range(4):
        prog(torch.zeros(3))
    assert recorded.captures == 1 and recorded.replays == 3
    assert tdia.KERNEL_LAUNCHES == 8 and tell.KERNEL_LAUNCHES == 4
    assert mesh.traffic("top") == {"ppermute": (4, 64)}


# three kernel nodes and a copy of a ``cudaGraphDebugDotPrint`` dump, as
# CUDA 12 prints them on an H100
DOT = r"""digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_0"[style="bold" shape="record" label="{KERNEL
| {ID | 0 (topoId: 3) | _ZN44_GLOBAL__N__b49cb0f2_11_dia_spmv_cu_07110b2915dia_spmv_kernelIfLi3ELb1EiEEvPKT_S3_PS1_T2_S5_NS_6ParamsE\<\<\<256,256,0\>\>\>}
| {{node handle | func handle} | {0x000000001E98D940 | 0x000000000A311380}}
| {cooperative | 0}
}"];

"graph_1_node_1"[style="bold" shape="record" label="{KERNEL
| {ID | 1 (topoId: 2) | _ZN45_GLOBAL__N__5c0e7d1a_12_sell_spmv_cu_2b9e41c716sell_spmv_kernelIfLi1EEEvPKT_PKiPKxS4_S3_PS1_x\<\<\<650,256,0\>\>\>}
| {{node handle | func handle} | {0x000000001E98E810 | 0x000000000A3B60F0}}
}"];

"graph_1_node_2"[style="bold" shape="record" label="{KERNEL
| {ID | 2 (topoId: 1) | _ZN45_GLOBAL__N__5c0e7d1a_12_sell_spmv_cu_2b9e41c716sell_spmv_kernelIfLi1EEEvPKT_PKiPKxS4_S3_PS1_x\<\<\<112,256,0\>\>\>}
}"];

"graph_1_node_3"[style="solid" shape="record" label="{MEMCPY
| {ID | 3 (topoId: 0) | node handle | 0x000000001E98F000}
}"];
}
}
"""


class DumpedGraph:
    """A kept ``torch.cuda.CUDAGraph`` whose dump is ``DOT``."""

    def debug_dump(self, path):
        with open(path, "w") as f:
            f.write(DOT)


def test_kernel_launch_registry():
    """The three kernel modules register their counters, by kernel name,
    with no module named twice."""
    assert sorted(k for k, _ in graphs.LAUNCH_COUNTERS) == [
        "banded_spmv_kernel", "dia_spmv_kernel", "sell_spmv_kernel"]
    assert dict((k, m) for k, m in graphs.LAUNCH_COUNTERS)[
        "sell_spmv_kernel"] is tell
    graphs.count_launches(tell, "sell_spmv_kernel")
    assert len(graphs.LAUNCH_COUNTERS) == 3


def test_graph_kernels_read_from_the_dump():
    """``Program.graph_kernels`` counts a kept graph's kernel nodes by
    kernel, apart from the counters (``counted``); a graph that was not
    kept raises."""
    graph = object.__new__(graphs.TorchGraph)
    graph.keep, graph.graph = True, DumpedGraph()
    names = graph.kernel_names()
    assert sum(names.values()) == 3 and len(names) == 2
    prog = graphs.Program(lambda v: v, None, "cpu")
    prog.graph = graph
    counts = {"dia_spmv_kernel": 1, "sell_spmv_kernel": 2}
    prog._delta = ([counts.get(k, 0) for k, _ in graphs.LAUNCH_COUNTERS], [])
    assert prog.graph_kernels() == {"dia_spmv_kernel": 1,
                                    "banded_spmv_kernel": 0,
                                    "sell_spmv_kernel": 2}
    assert prog.graph_kernels() == prog.counted()
    graph.keep = False
    with pytest.raises(RuntimeError, match="KEEP_GRAPHS"):
        graph.kernel_names()


def test_cache_key_and_owner():
    """``Programs.get`` keeps one program a key for one owner; another
    owner drops them all, and so does ``clear``."""
    progs = graphs.Programs("cpu")
    owner, other = object(), object()
    fn = lambda v: v
    a = progs.get(owner, ("apply", 4), fn)
    assert progs.get(owner, ("apply", 4), fn) is a
    assert progs.get(owner, ("apply", 8), fn) is not a and len(progs) == 2
    assert progs.get(other, ("apply", 4), fn) is not a and len(progs) == 1
    progs.clear()
    assert len(progs) == 0


def test_failed_capture_raises(monkeypatch):
    """A capture that fails raises: neither the helper nor PCAIR falls
    back to the eager path."""
    monkeypatch.setattr(graphs, "enabled", lambda device: True)
    monkeypatch.setattr(graphs, "GRAPH", FailingGraph)
    prog = graphs.Program(lambda v: v + 1.0, None, "cpu")
    with pytest.raises(RuntimeError, match="CUDA graph capture of"):
        prog(torch.zeros(2))
    assert prog.graph is None
    A = tpf.adv_diff_2d(16)
    pc = tpf.PCAIR(_opts(), **F64).setup(A)
    with pytest.raises(RuntimeError, match="capture"):
        pc.apply(_rhs(A.shape[0]))
    with pytest.raises(RuntimeError, match="capture"):
        pc.solve_device(_rhs(A.shape[0]), max_it=2)


def test_graphs_equal_eager(recorded):
    """apply, solve_device (with and without x0, Richardson and GMRES) and
    solve through the programs equal the eager path bit for bit, one
    capture a program; the default GMRES through its programs equals the
    stationary GMRES run eagerly bit for bit."""
    A = tpf.adv_diff_2d(32)
    n = A.shape[0]
    pc = tpf.PCAIR(_opts(), **F64).setup(A)
    b, r, x0 = _rhs(n, 1), torch.as_tensor(_rhs(n, 2)), _rhs(n, 3)
    for _ in range(3):
        y = pc.apply(r)
    assert torch.equal(y, _eager(pc, lambda: pc.apply(r)))
    for ksp in ("richardson", "gmres"):
        for kw in ({}, {"x0": x0}):
            for _ in range(2):
                x, norms = pc.solve_device(b, max_it=4, ksp=ksp, **kw)
            xe, ne = _eager(pc, lambda: pc.solve_device(b, max_it=4,
                                                        ksp=ksp, **kw))
            assert torch.equal(x, xe) and torch.equal(norms, ne)
    res = pc.solve(b, rtol=1e-10, side="right")
    stationary = jitted.gmres_stationary(
        pc.upload().top.matvec, pc._precond(pc.upload()),
        pc._vector(b), None, 1e-10, 1e-50, 10000, 30, "right")
    assert res.converged and res.iterations == stationary[1]
    np.testing.assert_array_equal(res.history,
                                  stationary[2][:res.iterations + 1])
    for ksp in ("fgmres", "richardson"):
        kw = dict(ksp=ksp, rtol=1e-8, max_it=40)
        h = pc.solve(b, **kw).history
        np.testing.assert_array_equal(
            h, _eager(pc, lambda: pc.solve(b, **kw)).history)
    # apply (1), solve_device (4), the right GMRES's op, resid and
    # precond (3), the left preconditioner of FGMRES and Richardson (1)
    assert recorded.captures == len(pc._programs) == 9


def test_graph_dropped_on_every_change(recorded):
    """The programs are dropped by every change of the device form they
    read (setup, setup(A2, "same"), a device re-setup's install,
    set_options), and the next replay then equals an eager solve on the
    new operators; set_poly_coefficients (for the next setup) and on (a
    twin) change none of this PCAIR's operators, so its program stays
    and its replay still equals the eager solve."""
    A = tpf.adv_diff_2d(32)
    n = A.shape[0]
    b = _rhs(n, 1)
    pc = tpf.PCAIR(_opts(), **F64).setup(A)

    def check(label):
        assert len(pc._programs) == 0, label
        for _ in range(2):
            x, norms = pc.solve_device(b, max_it=3)
        xe, ne = _eager(pc, lambda: pc.solve_device(b, max_it=3))
        assert torch.equal(x, xe) and torch.equal(norms, ne), label
        assert len(pc._programs) == 1
        return ne

    first = check("first")
    pc.setup(_perturbed(A, 1))
    setup = check("setup")
    pc.setup(_perturbed(A, 2), "same")
    same = check("setup same")
    pc.build_device_resetup().install(pc, _perturbed(A, 3))
    installed = check("install")
    assert len({tuple(v.tolist()) for v in (first, setup, same,
                                            installed)}) == 4
    kept = [prog for _, prog in pc._programs.items()]
    pc.set_poly_coefficients(-1, pc.get_poly_coefficients(-1))
    pc.on("cpu")
    assert [prog for _, prog in pc._programs.items()] == kept
    captures = recorded.captures
    x, norms = pc.solve_device(b, max_it=3)
    xe, ne = _eager(pc, lambda: pc.solve_device(b, max_it=3))
    assert recorded.captures == captures
    assert torch.equal(x, xe) and torch.equal(norms, ne)
    assert torch.equal(ne, installed)
    pc.set_options(max_levels=3)
    assert len(pc._programs) == 0
    pc.setup(A)
    check("set_options")


def test_sharded_solve_graph_counts_exchanges(recorded):
    """solve_device on a 2-shard mesh through its program: x, norms and
    the mesh's exchange log equal the eager run's."""
    A = tpf.adv_diff_2d(32)
    b = _rhs(A.shape[0], 1)
    mesh = make_mesh(2, device="cpu")
    pc = tpf.PCAIR(_opts(), **F64).setup(A)
    pc.solve_device(b, max_it=3, mesh=mesh)          # run, then capture
    mesh.reset_log()
    x, norms = pc.solve_device(b, max_it=3, mesh=mesh)
    log = {k: list(v) for k, v in mesh.log.items()}
    mesh.reset_log()
    xe, ne = _eager(pc, lambda: pc.solve_device(b, max_it=3, mesh=mesh))
    assert log and log == {k: list(v) for k, v in mesh.log.items()}
    assert torch.equal(x, xe) and torch.equal(norms, ne)


def test_jit_false_gmres_matches_reference_jit_false(monkeypatch,
                                                     host_kernels):
    """``PCAIR(opts, jit=False)`` runs GMRES on the host-driven
    ``krylov.gmres`` (a read a Gram-Schmidt dot, never the stationary
    GMRES), as ``pflare_tpu.PCAIR(opts, jit=False)`` does: equal
    iterations and histories within 1e-8 of each norm plus 1e-12 of the
    first."""
    A = tpf.adv_diff_2d(24)
    b = _rhs(A.shape[0], 1)
    kw = dict(rtol=1e-10, atol=1e-50, max_it=30)
    pc = tpf.PCAIR(tpf.AIROptions(max_levels=4), jit=False, **F64).setup(A)
    assert pc.jit is False

    def boom(*a, **k):
        raise AssertionError("jit=False ran the stationary GMRES")

    monkeypatch.setattr(tpcair, "gmres_stationary", boom)
    dots = krylov.HOST_READS
    res = pc.solve(b, **kw)
    assert krylov.HOST_READS - dots > 2 * res.iterations
    jpc = jpf.PCAIR(jpf.AIROptions(max_levels=4), jit=False).setup(A)
    jres = jpc.solve(jnp.asarray(b), **kw)
    assert res.converged and res.iterations == jres.iterations
    h, jh = res.history, np.asarray(jres.history)
    assert np.all(np.abs(h - jh) <= HISTORY_RTOL * jh + HISTORY_FLOOR * jh[0])


def test_jit_true_equals_jit_false_on_cpu():
    """On the CPU there is no graph: jit=True runs the eager code, so
    apply and solve_device give jit=False's bits, and the two GMRES
    (stationary and host-driven) agree in iterations and histories."""
    A = tpf.adv_diff_2d(32)
    b = _rhs(A.shape[0], 1)
    pc = tpf.PCAIR(_opts(), **F64).setup(A)
    y, (x, norms) = pc.apply(b), pc.solve_device(b, max_it=4)
    assert len(pc._programs) == 0
    pc.jit = False
    assert torch.equal(y, pc.apply(b))
    xe, ne = pc.solve_device(b, max_it=4)
    assert torch.equal(x, xe) and torch.equal(norms, ne)
    he = pc.solve(b, rtol=1e-10).history
    pc.jit = True
    h = pc.solve(b, rtol=1e-10).history
    assert len(h) == len(he)
    assert np.all(np.abs(h - he) <= HISTORY_RTOL * he + HISTORY_FLOOR * he[0])
