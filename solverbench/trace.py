"""Reading a profiled segment: device busy time, the top device
operations and the idle gaps by what the harness was doing.

The arithmetic of ``chip_smoke.py::profiled`` (device activity alone,
``torch.profiler``): busy is the time in which some operation (kernel,
copy or set) ran on the card, here the union of their intervals so that
overlapping streams count once; the window is the segment's wall to
completion.  Each idle gap is named by the harness span it falls in and
the device operations on either side of it.
"""

from __future__ import annotations

import re
import time

TOP = 10


def short(name: str) -> str:
    """A kernel's name without its return type, template and argument
    lists, and with its innermost namespace; a copy's or set's kind."""
    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split()[:2])
    name = name.replace("(anonymous namespace)::", "")
    while True:   # drop template arguments, innermost first
        name, n = re.subn(r"<[^<>]*>", "", name)
        if not n:
            break
    name = name.split("(")[0].split()
    return "::".join(name[-1].split("::")[-2:])[:64] if name else "op"


def profile(fn, device):
    """Run ``fn(spans)`` under torch.profiler on a CUDA ``device`` and
    read the segment: {"busy_s", "window_s", "device_ops", "idle_gaps"},
    each list at most ``TOP`` [name, seconds] entries, longest first.
    None on any other device: it has no device trace to read."""
    if device.type != "cuda":
        fn(None)
        return None
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    spans = []
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        w0 = time.time_ns()
        t0 = time.perf_counter()
        fn(spans)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        w1 = time.time_ns()
    events = sorted(
        (e.start_ns(), e.end_ns(), e.name())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CUDA and e.end_ns() > e.start_ns())
    return {"window_s": window_s, **read_events(events, spans, w0, w1)}


def read_events(events, spans, w0, w1):
    """Busy seconds, top operations and named idle gaps of device
    ``events`` [(start_ns, end_ns, name)] sorted by start, between w0 and
    w1 (ns), with the harness ``spans`` [(name, start_ns, end_ns)]."""
    by_op = {}
    busy = 0
    gaps = {}

    def gap(start, end, after, before):
        if end <= start:
            return
        mid = (start + end) // 2
        where = next((s for s, a, b in spans if a <= mid < b), "harness")
        key = f"{where}: {after} -> {before}"
        gaps[key] = gaps.get(key, 0) + (end - start)

    cur = None    # the merged busy interval [start, end, last op's name]
    for start, end, name in events:
        name = short(name)
        by_op[name] = by_op.get(name, 0) + (end - start)
        if cur is not None and start <= cur[1]:
            if end >= cur[1]:
                cur[1], cur[2] = end, name
            continue
        if cur is None:
            gap(w0, start, "segment start", name)
        else:
            busy += cur[1] - cur[0]
            gap(cur[1], start, cur[2], name)
        cur = [start, end, name]
    if cur is not None:
        busy += cur[1] - cur[0]
        gap(cur[1], w1, cur[2], "segment end")

    def top(d):
        return [[k, v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"busy_s": busy / 1e9, "device_ops": top(by_op),
            "idle_gaps": top(gaps)}
