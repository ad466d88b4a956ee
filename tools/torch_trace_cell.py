#!/usr/bin/env python3
"""A benchmark cell's set-up and traced segment with the program's spans
collected (``pflare_tpu_torch.utils.timers.collect``), every device idle
gap named by the innermost span that holds it.

    python3 tools/torch_trace_cell.py --workload <cell> --seed <n>
        [--segments 2] [--device cuda] [--out FILE]

Builds the cell as ``solverbench/run.py`` does (``harness.Cell`` and its
warm requests) with a collector open, which gives ``setup_device`` by
phase and level.  Then runs the cell's traced segment
(``trace_requests`` requests under ``torch.profiler``, device activity
only, as ``solverbench/trace.py::profile`` does) ``--segments`` times with
the collector closed and as often with it open (closed, open, open,
closed, ...), and reads each open one: the gaps by span (``solverbench/spans.py::read_gaps``), the
share of the idle time inside the harness's ``solve`` spans that a
program span below ``pcair.solve`` names, the counts of ``gmres.read``
and ``graph.launch`` spans against the host reads and the graph replays
counted apart, the clocks' agreement (``spans.alignment``; where a
segment's device times wandered from the host's, its events are moved
back, ``spans.realign``, before the gaps are named), and the span
metrics' readers.  Also times a closed span (what a span costs with
no collector open) and prints, last, one JSON line of the numbers, also
written to ``--out`` where given.  With ``--device cpu`` (tiny cells in
the tests' sizes: ``--size n=32``) there is no device trace: only the
spans are read.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import timeit
from contextlib import nullcontext

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def closed_span_ns(timers, number=200_000) -> float:
    """Nanoseconds one span costs with no collector open, less an empty
    loop's, on this host."""
    loop = timeit.timeit("pass", number=number)
    spanned = timeit.timeit("with span('x'):\n    pass", number=number,
                            globals={"span": timers.span})
    return (spanned - loop) / number * 1e9


def by_level(spans) -> list:
    """[[tag, seconds, {phase: seconds}]] of each ``setup.level`` span."""
    out = []
    for i, (name, tag, t0, t1, _, _) in enumerate(spans):
        if name == "setup.level" and t1 is not None:
            phases = {}
            for child in spans:
                if child[4] == i and child[3] is not None:
                    phases[child[0]] = (phases.get(child[0], 0.0)
                                        + (child[3] - child[2]) / 1e9)
            out.append([tag, (t1 - t0) / 1e9, phases])
    return out


def launch_by_program(ps):
    """{program name: [replays, mean graph.launch us]}."""
    out = {}
    for name, _, t0, t1, parent, _ in ps:
        if name == "graph.launch":
            entry = out.setdefault(ps[parent][1], [0, 0.0])
            entry[0] += 1
            entry[1] += (t1 - t0) / 1e3
    return {k: [c, total / c] for k, (c, total) in out.items()}


def below_solve(named, summary):
    """The share of the idle time inside the harness's ``solve`` spans
    that a program span below ``pcair.solve`` names, in %."""
    idle = named["idle_by_span"]
    below = sum(v for name, v in idle.items()
                if name in summary and name != "pcair.solve")
    inside = below + idle.get("pcair.solve", 0.0) + idle.get("solve", 0.0)
    return below / inside * 100 if inside else None


def dump(folder, k, events, hspans, ps, w0, w1):
    """Write a segment's device events (short names), harness spans and
    program spans to ``<folder>/segment<k>.json.gz``."""
    import gzip

    from solverbench.trace import short

    os.makedirs(folder, exist_ok=True)
    with gzip.open(os.path.join(folder, f"segment{k}.json.gz"), "wt") as f:
        json.dump({"w0": w0, "w1": w1, "harness": hspans, "program": ps,
                   "events": [(a, b, short(name)) for a, b, name in events]},
                  f)


def segment(cell, n, timers, collecting, device):
    """One traced segment of ``n`` requests: (window s, device events,
    harness spans, program spans, w0, w1, host reads, replays)."""
    from pflare_tpu_torch.solvers import jitted
    from pflare_tpu_torch.utils import graphs

    replays = [0]
    replay = graphs.TorchGraph.replay

    def counted(self):
        replays[0] += 1
        replay(self)

    graphs.TorchGraph.replay = counted
    hspans, reads = [], jitted.HOST_READS
    cell.sync()
    prof = None
    try:
        if device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA])
        with prof or nullcontext():
            with timers.collect() if collecting else nullcontext([]) as ps:
                w0 = time.time_ns()
                t0 = time.perf_counter()
                for _ in range(n):
                    cell.request(spans=hspans)
                cell.sync()
                window_s = time.perf_counter() - t0
                w1 = time.time_ns()
    finally:
        graphs.TorchGraph.replay = replay
    events = []
    if prof is not None:
        from torch.autograd import DeviceType
        events = sorted(
            (e.start_ns(), e.end_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and e.end_ns() > e.start_ns())
    return (window_s, events, hspans, ps, w0, w1,
            jitted.HOST_READS - reads, replays[0])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--segments", type=int, default=2,
                    help="traced segments with the collector closed, and "
                    "as many with it open")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", action="append", default=[],
                    help="key=value: cut the configuration's problem "
                    "(CPU rehearsals)")
    ap.add_argument("--out", help="a JSON file for the numbers")
    ap.add_argument("--dump", help="a folder for each traced segment's "
                    "events and spans")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from solverbench import run as bench_run

    bench_run.checkout_env()
    import torch

    from pflare_tpu_torch.utils import timers
    from solverbench import harness, spans, trace

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device")
        from pflare_tpu_torch import cuda
        cuda.build_all()
    spec = harness.load_spec(args.workload)
    problem = spec["config"]["problem"]["args"]
    for kv in args.size:
        key, value = kv.split("=")
        problem[key] = type(problem[key])(value)
    traffic = spec["traffic"]
    out = {"workload": args.workload, "seed": args.seed, "card": card(),
           "device": str(device)}

    t0 = time.perf_counter()
    with timers.collect() as setup:
        cell = harness.Cell(spec, args.seed, args.device,
                            harness.OPERATOR_CACHE)
        for _ in range(traffic["warm_requests"]):
            cell.request()
    out["setup_wall_s"] = time.perf_counter() - t0
    out["setup_spans"] = timers.summary(setup)
    out["setup_levels"] = by_level(setup)
    record = {"setup_spans": out["setup_spans"]}
    out["setup_device_s"] = spans.setup_device_s(record)

    n = traffic["trace_requests"]
    out["segments"] = []
    for k in range(2 * args.segments):
        collecting = k % 4 in (1, 2)    # closed, open, open, closed, ...
        (window_s, events, hspans, ps, w0, w1, reads,
         replays) = segment(cell, n, timers, collecting, device)
        seg = {"collecting": collecting, "window_s": window_s,
               "host_reads": reads, "replays": replays}
        if events:
            plain = trace.read_events(events, hspans, w0, w1)
            seg.update(busy_s=plain["busy_s"],
                       idle_pct=(1 - plain["busy_s"] / window_s) * 100,
                       solve_idle_gaps=plain["idle_gaps"])
        if collecting:
            summary = timers.summary(ps)
            seg.update(spans=summary, n_spans=len(ps),
                       roots=sum(s[4] == -1 for s in ps),
                       launch_us=launch_by_program(ps))
            if events:
                if args.dump:
                    dump(args.dump, k, events, hspans, ps, w0, w1)
                seg["alignment"] = align = spans.alignment(events, ps)
                lo, hi = align["lo_ns"], align["hi_ns"]
                if (lo is not None and lo > 0) or (hi is not None
                                                   and hi < 0):
                    # the device's times wandered from the host's: move
                    # them back by the reads' copies
                    events, offsets = spans.realign(events, ps)
                    seg["realigned"] = spans.alignment(events, ps)
                    seg["offset_ns"] = [min(o for _, o in offsets),
                                        max(o for _, o in offsets)]
                named = spans.read_gaps(events, hspans, ps, w0, w1)
                seg.update(named)
                seg["named_below_solve_pct"] = below_solve(named, summary)
                idle = named["idle_by_span"]
                prof = {"window_s": window_s, "busy_s": plain["busy_s"],
                        "spans": summary, "idle_by_span": idle}
                rec = dict(record, profile=prof)
                seg["metrics"] = {
                    "replay_launch_us.rhs": spans.replay_launch_us(rec),
                    "replay_idle_pct.rhs": spans.replay_idle_pct(rec),
                    "gmres_host_idle_pct.rhs": spans.gmres_host_idle_pct(rec),
                    "setup_device_s": spans.setup_device_s(rec)}
        out["segments"].append(seg)
        print(f"segment {k}: collecting {collecting}, window "
              f"{window_s:.6f} s, reads {reads}, replays {replays}",
              file=sys.stderr, flush=True)

    walls = {c: [s["window_s"] for s in out["segments"]
                 if s["collecting"] == c] for c in (False, True)}
    out["window_closed_s"] = walls[False]
    out["window_open_s"] = walls[True]
    out["on_cost_pct"] = (statistics.median(walls[True])
                          / statistics.median(walls[False]) - 1) * 100
    span_ns = closed_span_ns(timers)
    per_solve = statistics.median(s["n_spans"] for s in out["segments"]
                                  if s["collecting"]) / n
    solve_s = statistics.median(walls[False]) / n
    out.update(closed_span_ns=span_ns, spans_per_solve=per_solve,
               off_cost_pct=per_solve * span_ns * 1e-9 / solve_s * 100)
    print(json.dumps(out, indent=1), file=sys.stderr)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
