"""CUDA graphs over the solve's device programs (``PCAIR(jit=True)``).

The reference traces its V-cycle, its GMRES and its fixed-iteration
solve into jitted XLA programs (pflare_tpu/air/pcair.py:26-44, 285-319,
460-466), where eager PyTorch issues every SpMV, axpy and gather from
Python.  A ``Program`` captures a function of fixed-shape tensors into a
``torch.cuda.CUDAGraph`` at its first call and replays it at every later
one:

* static buffers: a replay copies its inputs into the capture's input
  tensors and clones its outputs out of the capture's, so two calls never
  alias;
* warm-up: the first call runs the function eagerly on a side stream,
  which loads the kernel libraries (``cuda.py``), creates the cuBLAS
  handles and fills the caching allocator, and returns that run's result;
  the capture follows on the calling thread alone
  (``capture_error_mode="thread_local"``: other threads may use the card
  meanwhile), in the memory pool of its ``Programs`` (one per PCAIR);
* counters: the kernels' launch counters (the ``KERNEL_LAUNCHES`` of
  each module that registers with ``count_launches``), the counters by
  kind registered with ``count_kinds`` (``ell.EPILOGUE_LAUNCHES``) and
  the meshes' exchange logs (``parallel.mesh.Mesh.record``) change only
  while Python runs.  The capture's changes are taken back (it launched nothing) and
  added at every replay, so they read as they would without graphs;
* no fallback: a capture or replay that fails raises;
* spans (``timers.collect``): each call is a ``program`` span tagged
  with the program's name; inside it ``graph.launch`` covers a replay's
  ``replay()`` alone and ``graph.capture`` the first call's warm-up and
  capture, whose clock reads also give ``capture_s``.

With ``KEEP_GRAPHS`` set before a capture, the captured graph is kept
beside its instantiation, and ``Program.graph_kernels`` reads from it the
kernel nodes that every replay launches: a count that does not come from
the counters, to hold them against (``Program.counted``).

Every graph of a pool keeps its static inputs and outputs alive (the
``Program`` holds them) and replays on the caller's stream, never two at
once, so the graphs of one pool may replay in any order.  A ``Program``
also holds the function it captured, and with it every operator the
graph reads: they cannot be freed under it.  The owner drops its programs
whenever its operators change (``Programs.get``'s ``owner``, ``clear``).
"""

from __future__ import annotations

import collections
import os
import re
import tempfile
import warnings

import torch

from .timers import Stopwatch, span

# (kernel name, module) of each kernel whose module's KERNEL_LAUNCHES a
# replay advances, in the order of registration (``count_launches``)
LAUNCH_COUNTERS: list = []

# counters by kind (``collections.Counter``s, changed in place) that a
# replay advances like the launch counters (``count_kinds``)
KIND_COUNTERS: list = []

# keep each captured cudaGraph_t, so that ``Program.graph_kernels`` can
# list its kernel nodes (a check's setting: off, the graph is freed once
# instantiated, as PyTorch does by default)
KEEP_GRAPHS = False

# a kernel node of ``cudaGraphDebugDotPrint``: "| {ID | 2 (topoId: 222) |
# <mangled name>\<\<\<grid,block,smem\>\>\>}"
_DOT_KERNEL = re.compile(r"\| \{ID \| \d+ \(topoId: \d+\) \| ([^|{}]+?)\\<")


def count_launches(module, kernel: str) -> None:
    """Register ``module``, whose ``KERNEL_LAUNCHES`` counts the launches
    of the CUDA kernel ``kernel`` (its name in csrc/), so that a replay
    adds what its capture counted there."""
    if all(m is not module for _, m in LAUNCH_COUNTERS):
        LAUNCH_COUNTERS.append((kernel, module))


def count_kinds(counter: collections.Counter) -> None:
    """Register ``counter`` (launches by kind), so that a replay adds to
    it what its capture counted."""
    if all(c is not counter for c in KIND_COUNTERS):
        KIND_COUNTERS.append(counter)


def enabled(device) -> bool:
    """Whether ``PCAIR(jit=True)`` captures graphs on ``device``: only a
    CUDA device has them; elsewhere the same code runs eagerly."""
    return torch.device(device).type == "cuda"


def read_counters(meshes=()):
    """The launch counters, each mesh's exchange log and the counters by
    kind, copied."""
    return ([m.KERNEL_LAUNCHES for _, m in LAUNCH_COUNTERS],
            [{k: list(v) for k, v in mesh.log.items()} for mesh in meshes],
            [collections.Counter(c) for c in KIND_COUNTERS])


def write_counters(state, meshes=()):
    """Set the counters and logs to ``state`` (from ``read_counters``)."""
    launches, logs, kinds = state
    for (_, module), count in zip(LAUNCH_COUNTERS, launches):
        module.KERNEL_LAUNCHES = count
    for counter, saved in zip(KIND_COUNTERS, kinds):
        counter.clear()
        counter.update(saved)
    for mesh, log in zip(meshes, logs):
        mesh.log.clear()
        for key, entry in log.items():
            mesh.log[key] = list(entry)


def _delta(after, before):
    launches = [a - b for a, b in zip(after[0], before[0])]
    kinds = [a - b for a, b in zip(after[2], before[2])]
    logs = []
    for log_a, log_b in zip(after[1], before[1]):
        logs.append({key: [a - b for a, b in zip(entry,
                                                log_b.get(key, (0, 0)))]
                     for key, entry in log_a.items()
                     if entry != log_b.get(key)})
    return launches, logs, kinds


def _advance(delta, meshes):
    """Add a replay's counts: what its capture would have counted."""
    launches, logs, kinds = delta
    for (_, module), count in zip(LAUNCH_COUNTERS, launches):
        module.KERNEL_LAUNCHES += count
    for counter, count in zip(KIND_COUNTERS, kinds):
        counter.update(count)
    for mesh, log in zip(meshes, logs):
        for key, (calls, nbytes) in log.items():
            entry = mesh.log[key]
            entry[0] += calls
            entry[1] += nbytes


def _tensors(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _map(fn, out):
    if isinstance(out, (tuple, list)):
        return type(out)(fn(t) for t in out)
    return fn(out)


class TorchGraph:
    """One ``torch.cuda.CUDAGraph`` in ``pool``: ``capture(fn, args)``
    records ``fn(*args)`` on a side stream and returns its (static)
    outputs; ``replay()`` runs it on the current stream;
    ``kernel_names()`` counts its kernel nodes by name (``KEEP_GRAPHS``).
    (The CPU tests put a stand-in with the first two methods in
    ``GRAPH``.)"""

    def __init__(self, pool, device):
        self.keep = KEEP_GRAPHS
        self.graph = torch.cuda.CUDAGraph(keep_graph=self.keep)
        self.pool = pool
        self.device = device

    def capture(self, fn, args):
        current = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=self.pool,
                                     capture_error_mode="thread_local")
            try:
                out = fn(*args)
            finally:
                self.graph.capture_end()
        if self.keep:
            self.graph.instantiate()
        current.wait_stream(stream)
        return out

    def replay(self):
        self.graph.replay()

    def kernel_names(self) -> collections.Counter:
        """{mangled kernel name: nodes} of the kept graph, read from its
        ``cudaGraphDebugDotPrint`` dump."""
        if not self.keep:
            raise RuntimeError("the graph was not kept: set "
                               "graphs.KEEP_GRAPHS before the capture")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "graph.dot")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")   # PyTorch's DEBUG notes
                self.graph.debug_dump(path)
            with open(path) as f:
                return collections.Counter(_DOT_KERNEL.findall(f.read()))


GRAPH = TorchGraph


class Program:
    """``fn`` (tensors in, a tensor or a tuple of tensors out, every shape
    fixed) as one CUDA graph, captured at the first call (see the module
    docstring).  ``meshes``: the row meshes whose exchange logs ``fn``
    writes."""

    def __init__(self, fn, pool, device, meshes=(), name="program"):
        self.fn = fn
        self.pool = pool
        self.device = torch.device(device)
        self.meshes = tuple(meshes)
        self.name = name
        self.graph = None
        self.capture_s = None   # seconds of warm-up + capture

    def __call__(self, *args):
        with span("program", self.name):
            if self.graph is None:
                return self._first_call(args)
            for buf, a in zip(self._inputs, args):
                if buf.shape != a.shape or buf.dtype != a.dtype:
                    raise ValueError(f"{self.name}: input {tuple(a.shape)} "
                                     f"{a.dtype}, captured for "
                                     f"{tuple(buf.shape)} {buf.dtype}")
                buf.copy_(a)
            try:
                with span("graph.launch"):
                    self.graph.replay()
            except Exception as exc:
                raise RuntimeError(f"replay of the CUDA graph of "
                                   f"{self.name} failed: {exc}") from exc
            _advance(self._delta, self.meshes)
            return _map(torch.clone, self._outputs)

    def counted(self) -> dict:
        """{kernel: launches} that each replay adds to the counters."""
        return {kernel: count for (kernel, _), count
                in zip(LAUNCH_COUNTERS, self._delta[0])}

    def graph_kernels(self) -> dict:
        """{kernel: nodes of the captured graph that launch it}, for each
        registered kernel: what each replay launches, read from the graph
        itself (captured under ``KEEP_GRAPHS``)."""
        names = self.graph.kernel_names()
        return {kernel: sum(c for name, c in names.items() if kernel in name)
                for kernel, _ in LAUNCH_COUNTERS}

    def _warm_up(self, args):
        if self.device.type != "cuda":
            return self.fn(*args)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.fn(*args)
        current.wait_stream(side)
        for t in _tensors(out):
            t.record_stream(current)
        return out

    def _first_call(self, args):
        with Stopwatch("graph.capture") as watch:
            inputs = [a.clone() for a in args]
            out = self._warm_up(inputs)
            before = read_counters(self.meshes)
            graph = GRAPH(self.pool, self.device)
            try:
                static = graph.capture(self.fn, inputs)
            except Exception as exc:
                raise RuntimeError(f"CUDA graph capture of {self.name} "
                                   f"failed: {exc}") from exc
            finally:
                after = read_counters(self.meshes)
                write_counters(before, self.meshes)
        self._delta = _delta(after, before)
        self._inputs, self._outputs = inputs, static
        self.graph = graph
        self.capture_s = watch.seconds
        return out


class Programs:
    """The programs of one PCAIR, by key, in one memory pool, for one
    ``owner`` (the solve form they captured): asking for another owner's
    program drops them all first, and ``clear`` drops them outright."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._pool = None
        self._owner = None
        self._programs = {}

    def get(self, owner, key, fn, meshes=(), name=None) -> Program:
        """The program of ``key`` for ``owner``, made from ``fn`` if
        there is none."""
        if owner is not self._owner:
            self.clear()
            self._owner = owner
        prog = self._programs.get(key)
        if prog is None:
            if self._pool is None and self.device.type == "cuda":
                self._pool = torch.cuda.graph_pool_handle()
            prog = Program(fn, self._pool, self.device, meshes,
                           name or str(key[0]))
            self._programs[key] = prog
        return prog

    def clear(self):
        """Drop every program (and with them their graphs and pool)."""
        self._programs = {}
        self._owner = None
        self._pool = None

    def __len__(self):
        return len(self._programs)

    def items(self):
        return self._programs.items()
