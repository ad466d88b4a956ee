"""One run of one benchmark cell, driven by data.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; everything that belongs to either lives in files of its own,
found by name:

* ``configs/<config>.json``: the deployment (its generator in
  ``problems.py`` and the generator's arguments, the PCAIR options, the
  dtype, the tolerance);
* ``traffic/<traffic>.json``: the request loop's parameters (the solver
  call's arguments, the warm and traced requests, the size of the sample
  that the reference judges);
* ``checks/<workload>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from;
* ``metrics/<metric>.py``: a reader ``read(record)`` of one metric from the
  run's record (``None``: nothing to read there).

``run_cell`` builds the record: set-up (operator, PCAIR, warm requests),
a measured window of closed-loop requests, with ``trace`` a profiled
segment after it, then the reference's judgement of a seeded sample of
the window's answers.  A generated operator is kept in the checkout's
``_cache/operators/`` (``operator``), so that only a cell's first run in
a checkout generates it.  ``run.py`` is the command; the tests call
``run_cell`` with ``device="cpu"``.
"""

from __future__ import annotations

import hashlib
import importlib.util
import inspect
import json
import os
import sys
import time
from contextlib import contextmanager

import numpy as np

from . import problems, reference, trace

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
OPERATOR_CACHE = os.path.join(BENCH, "_cache", "operators")
FORBIDDEN = ("jax", "jaxlib", "flax", "pflare_tpu")


def load_spec(workload: str, bench: dict | None = None,
              root: str = ROOT) -> dict:
    """The cell's entry, its configuration, traffic, checks and metrics."""
    if bench is None:
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            bench = json.load(f)
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the benchmark has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def load(*parts):
        with open(os.path.join(*parts)) as f:
            return json.load(f)

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    return {"workload": workload, "chips": cell["chips"],
            "config": load(root, entry["file"]),
            "traffic": load(BENCH, "traffic", cell["traffic"] + ".json"),
            "checks": load(BENCH, "checks", workload + ".json"),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def _load(folder: str, name: str):
    """The module ``<folder>/<name>.py`` of the benchmark."""
    path = os.path.join(BENCH, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"solverbench_{folder}_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _load("metrics", name).read


def generator(name: str):
    """A configuration's generator: one of ``problems.py``'s, or the
    ``generate`` function of ``generators/<name>.py``."""
    if name in problems.GENERATORS:
        return problems.GENERATORS[name]
    return _load("generators", name).generate


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


@contextmanager
def span(spans, name):
    """Record (name, start, end) in ``spans`` on the profiler's clock
    (``time.time_ns``), when a traced segment collects spans."""
    t0 = time.time_ns()
    try:
        yield
    finally:
        if spans is not None:
            spans.append((name, t0, time.time_ns()))


def operator(problem: dict, cache: str | None = None):
    """The configuration's operator, ``{"generator": name, "args": {...}}``:
    generated, or read back from ``cache`` where a run in this checkout
    saved it.  The file's name holds a hash of the generator, its
    arguments and the source file that defines it, so a changed generator
    never reads an old operator."""
    import scipy.sparse as sp

    make = generator(problem["generator"])
    if cache is None:
        return make(**problem["args"])
    key = hashlib.sha256(json.dumps(problem, sort_keys=True).encode())
    with open(inspect.getsourcefile(make), "rb") as f:
        key.update(f.read())
    path = os.path.join(cache, f"{problem['generator']}-"
                               f"{key.hexdigest()[:16]}.npz")
    if os.path.exists(path):
        return sp.csr_matrix(sp.load_npz(path))
    A = make(**problem["args"])
    os.makedirs(cache, exist_ok=True)
    part = path[:-len(".npz")] + ".part.npz"
    sp.save_npz(part, A, compressed=False)
    os.replace(part, path)
    return A


class Reservoir:
    """A uniform sample of at most ``size`` of the window's answers, drawn
    from the seed (reservoir sampling; the answers stay where they are)."""

    def __init__(self, size: int, rng):
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, item):
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def _device_ops(dh):
    """Every sparse operator of a device hierarchy, each once: the top,
    the levels' operators, their inverses' and the coarse inverse's (a
    matrix-free inverse runs on its level's operator)."""
    seen, ops = set(), []

    def add(op):
        if id(op) not in seen:
            seen.add(id(op))
            ops.append(op)

    add(dh.top)
    for lev in dh.levels:
        for key, val in lev.items():
            if key.startswith("inv_"):
                if val.kind not in ("diagonal", "dense"):
                    add(val.mat)
            elif key not in ("mask_f", "mask_c", "coarse"):
                add(val)
    if dh.coarse_inv.kind not in ("diagonal", "dense"):
        add(dh.coarse_inv.mat)
    return ops


class Cell:
    """The system under test, set up for one cell and one seed."""

    def __init__(self, spec: dict, seed: int, device: str,
                 cache: str | None = None):
        import torch

        import pflare_tpu_torch as pt

        self.torch = torch
        cfg, traffic = spec["config"], spec["traffic"]
        self.traffic = traffic
        self.device = torch.device(device)
        self.dtype = getattr(torch, cfg["dtype"])
        self.rtol = cfg["rtol"]
        t0 = time.perf_counter()
        self.A = operator(cfg["problem"], cache)
        self.n = self.A.shape[0]
        t1 = time.perf_counter()
        self.pc = pt.PCAIR(pt.AIROptions(**cfg["options"]), jit=True,
                           dtype=self.dtype, device=self.device)
        self.pc.setup_device(self.A)
        t2 = time.perf_counter()
        self.reseed(seed)
        self.setup_split = (f"operator {t1 - t0:.3f} s, PCAIR "
                            f"{t2 - t1:.3f} s")

    def reseed(self, seed: int):
        """Draw this seed's inputs: the generator of the right-hand sides
        and the sample the reference judges."""
        seeds = np.random.SeedSequence(seed % 2**64).generate_state(2)
        self.gen = self.torch.Generator(device=self.device)
        self.gen.manual_seed(int(seeds[0]))
        self.sample = Reservoir(self.traffic["check_sample"],
                                np.random.default_rng(int(seeds[1])))

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def _counters(self):
        from pflare_tpu_torch.solvers import jitted
        from pflare_tpu_torch.sparse import banded, dia, ell

        return (jitted.HOST_READS, dia.KERNEL_LAUNCHES
                + banded.KERNEL_LAUNCHES + ell.KERNEL_LAUNCHES)

    def _solve(self, b):
        """The traffic's solver call: the SolveResult."""
        return self.pc.solve(b, rtol=self.rtol, **self.traffic["solve"])

    def request(self, instrument: bool = False, spans=None):
        """One request, to completion: draw b on the device, solve, wait
        for x.  ``instrument``: read the counters around it.  Returns
        (record, (x, b))."""
        rec = {}
        if instrument:
            reads, launches = self._counters()
        t0 = time.perf_counter()
        with span(spans, "draw b"):
            b = self.torch.randn(self.n, generator=self.gen,
                                 dtype=self.dtype, device=self.device)
        with span(spans, "solve"):
            res = self._solve(b)
        with span(spans, "synchronise"):
            self.sync()
        rec.update(wall_s=time.perf_counter() - t0,
                   its=int(res.iterations), converged=bool(res.converged))
        if instrument:
            r2, l2 = self._counters()
            rec.update(host_reads=r2 - reads, launches=l2 - launches)
        return rec, (res.x, b)

    def window(self, seconds: float, instrument: bool):
        """Closed loop, one client: requests are issued while the window
        is open and each runs to its end.  Returns (records, seconds from
        the first request's start to the last one's end)."""
        recs = []
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end:
            rec, answer = self.request(instrument)
            recs.append(rec)
            self.sample.offer(answer)
        return recs, time.perf_counter() - t0

    def solve_bytes(self, bs) -> float:
        """Bytes that the sparse products of eager solves of ``bs`` need:
        each product of each operator counted by a wrapper around its
        ``matvec`` and charged ``roofline.product_bytes`` of its own
        nonzeros."""
        from pflare_tpu_torch.sparse import DIA
        from pflare_tpu_torch.utils import graphs

        from .roofline import product_bytes

        ops = _device_ops(self.pc.upload())
        calls = {id(op): 0 for op in ops}

        def wrap(op):
            inner = op.matvec

            def matvec(x):
                calls[id(op)] += 1
                return inner(x)
            op.matvec = matvec

        for op in ops:
            wrap(op)
        enabled = graphs.enabled
        graphs.enabled = lambda device: False
        _, launches = self._counters()
        try:
            for b in bs:
                self._solve(b)
            self.sync()
            _, after = self._counters()
        finally:
            graphs.enabled = enabled
            for op in ops:
                del op.matvec
        print(f"solverbench: the roofline's eager solves made "
              f"{sum(calls.values())} sparse products and "
              f"{after - launches} kernel launches", file=sys.stderr)
        total = 0
        for op in ops:
            if calls[id(op)]:
                total += calls[id(op)] * product_bytes(
                    op.to_scipy(), op.data.element_size(), isinstance(op, DIA))
        return float(total)


def run_cell(spec: dict, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: float | None = None,
             cache: str | None = None) -> dict:
    """One run of the cell: the result's line as a dict (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, with ``traced`` a
    ``breakdown``, and last ``checks``: each number compared with its
    limit).  ``cache``: where the operator is kept between runs."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    traffic = spec["traffic"]
    t0 = time.perf_counter()
    cell = Cell(spec, seed, device, cache)
    dev = cell.device
    t1 = time.perf_counter()
    for _ in range(traffic["warm_requests"]):
        cell.request()
    t2 = time.perf_counter()
    setup_s = t2 - t_start
    print(f"solverbench: set-up {setup_s:.3f} s: start-up and kernel "
          f"builds {t0 - t_start:.3f} s, {cell.setup_split}, warm requests "
          f"{t2 - t1:.3f} s", file=sys.stderr)

    recs, window_s = cell.window(seconds, instrument=traced)
    walls = np.array([r["wall_s"] for r in recs])
    print(f"solverbench: window {window_s:.3f} s, {len(recs)} requests, "
          f"wall min / median / max {walls.min():.6f} / "
          f"{np.median(walls):.6f} / {walls.max():.6f} s, iterations "
          f"{sorted({r['its'] for r in recs})}", file=sys.stderr)
    record = {"setup_s": setup_s, "window_s": window_s, "requests": recs,
              "profile": None}
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    if traced:
        segment = []

        def traced_requests(spans):
            for _ in range(traffic["trace_requests"]):
                segment.append(cell.request(spans=spans)[1][1])

        record["profile"] = trace.profile(traced_requests, dev)
        if record["profile"] is not None:
            record["profile"]["solve_bytes"] = cell.solve_bytes(segment)
        del segment

    names = spec["per_layer"] if traced else spec["end_to_end"]
    metrics = {}
    for m in names:
        value = reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    failed = sum(not r["converged"] for r in recs)
    result = {"attempted": len(recs), "failed": failed,
              "metrics": metrics, "device": device_info}
    prof = record["profile"]
    if prof is not None:
        device_info.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}

    # the reference judges the sample once the program's state is freed
    answers = [(x.double().cpu().numpy(), b.double().cpu().numpy())
               for x, b in cell.sample.items]
    A = cell.A
    del cell, recs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge(spec["checks"], A, answers, failed)
    result["correct"] = all(c["value"] is not None and c["value"] <= c["limit"]
                            for c in checks.values())
    result["checks"] = checks
    return {"correct": result.pop("correct"), **result}


def judge(limits: dict, A, answers, unconverged: int) -> dict:
    """The numbers compared, each with its limit: the largest relative
    residual of a sampled answer against the benchmark's own A and its b
    (None, which fails, where an answer is not finite or there is none),
    and the window's solves that did not reach the rtol (limit 0)."""
    worst = 0.0 if answers else None
    for x, b in answers:
        r = reference.relative_residual(A, x, b)
        worst = max(worst, r) if worst is not None and np.isfinite(r) \
            else None
    return {"max_rel_residual": {
                "value": worst, "limit": limits["max_rel_residual"]["limit"]},
            "unconverged": {"value": unconverged, "limit": 0}}
