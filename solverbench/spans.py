"""Device idle time named by the program's own spans.

The program records spans while ``pflare_tpu_torch.utils.timers.collect``
is open: records ``(name, tag, start_ns, end_ns, parent, request)`` on
``time.time_ns``'s clock, the clock of ``torch.profiler``'s event times and
of the harness's own spans ``(name, start_ns, end_ns)``.  ``read_gaps``
finds the same idle gaps as ``trace.read_events`` (between the merged
intervals of device activity, and at either end of the segment) and names
each by the innermost span, the harness's or the program's, that holds
its midpoint, so that a gap inside a solve reads as, say, ``graph.launch``
or ``gmres.read`` and not as ``solve``.

On the H100 the device's times can wander from the host's by several
milliseconds within a traced second (torch.profiler maps them once a
trace): ``alignment`` measures how far from the orders the spans
impose, and ``realign`` moves the events back before they are named.

The readers below take a run's record as ``harness.run_cell`` builds it,
with three entries that a traced run collects beside its own:
``record["setup_spans"]`` (``timers.summary`` of the spans of the set-up:
the cell's construction and the warm requests),
``record["profile"]["spans"]`` (the summary of the traced segment's
spans) and ``record["profile"]["idle_by_span"]`` (``read_gaps``).  Each
returns None where the record has none of them, as on the CPU or with a
program that records no spans.
"""

from __future__ import annotations

import bisect

from .trace import TOP, short

# the spans of one program call, and GMRES's host work around them
PROGRAM_SPANS = ("program", "graph.launch", "graph.capture")
GMRES_SPANS = ("gmres.start", "gmres.orthogonalise", "gmres.read",
               "gmres.rotate", "gmres.update")


def _intervals(harness_spans, program_spans):
    """[(start, end, name)] of both kinds, parents before children."""
    out = [(a, b, name) for name, a, b in harness_spans]
    out += [(t0, t1, name) for name, _, t0, t1, _, _ in program_spans
            if t1 is not None]
    return out


def innermost(intervals, points):
    """For each of the sorted ``points`` (ns), the name of the innermost
    interval ``start <= point < end`` of the nested ``intervals``
    [(start, end, name)], or None.  Of two with the same start, the later
    in the list (a child, recorded after its parent) is the inner."""
    order = sorted(range(len(intervals)),
                   key=lambda i: (intervals[i][0], -intervals[i][1], i))
    stack, k, names = [], 0, []
    for p in points:
        while k < len(order) and intervals[order[k]][0] <= p:
            stack.append(intervals[order[k]])
            k += 1
        while stack and stack[-1][1] <= p:
            stack.pop()
        names.append(stack[-1][2] if stack else None)
    return names


def read_gaps(events, harness_spans, program_spans, w0, w1) -> dict:
    """The idle gaps of device ``events`` [(start_ns, end_ns, name)]
    sorted by start, between w0 and w1 (ns), each named by the innermost
    harness or program span holding its midpoint ("harness" where none
    does) and by the operations on either side: {"idle_gaps": the ``TOP``
    longest [name, seconds], "idle_by_span": {span name: idle seconds}
    over every gap, "idle_s": their sum}."""
    gaps = []         # (start, end, op before, op after)
    cur = None        # the merged busy interval [start, end, last op]
    for start, end, name in events:
        name = short(name)
        if cur is not None and start <= cur[1]:
            if end >= cur[1]:
                cur[1], cur[2] = end, name
            continue
        gaps.append((w0 if cur is None else cur[1], start,
                     "segment start" if cur is None else cur[2], name))
        cur = [start, end, name]
    if cur is not None:
        gaps.append((cur[1], w1, cur[2], "segment end"))
    gaps = [g for g in gaps if g[1] > g[0]]
    where = innermost(_intervals(harness_spans, program_spans),
                      [(a + b) // 2 for a, b, _, _ in gaps])
    named, by_span = {}, {}
    for (a, b, after, before), span in zip(gaps, where):
        span = span or "harness"
        key = f"{span}: {after} -> {before}"
        named[key] = named.get(key, 0) + (b - a)
        by_span[span] = by_span.get(span, 0) + (b - a)
    top = sorted(named.items(), key=lambda kv: -kv[1])[:TOP]
    return {"idle_gaps": [[k, v / 1e9] for k, v in top],
            "idle_by_span": {k: v / 1e9 for k, v in by_span.items()},
            "idle_s": sum(by_span.values()) / 1e9}


# where the clocks agree, a read's host returns 3-180 us after its copy
# ends (H100 traces of both cells)
WAKE_NS = 15_000


def _read_copies(events, kinds, spans):
    """[(copy, its gmres.read span (t0, t1))]: each device-to-host copy
    with the read span nearest to it."""
    reads = sorted((s[2], s[3]) for s in spans if s[0] == "gmres.read")
    starts = [t0 for t0, _ in reads]
    out = []
    for e, kind in zip(events, kinds):
        if kind != "Memcpy DtoH" or not reads:
            continue
        mid = (e[0] + e[1]) // 2
        i = bisect.bisect_right(starts, mid)
        out.append((e, min(reads[max(i - 1, 0):i + 1],
                           key=lambda r: max(r[0] - mid, mid - r[1]))))
    return out


def alignment(events, program_spans) -> dict:
    """How far the device trace's clock may sit from the spans', from two
    orders that hold whatever the device does: a device-to-host copy (the
    segment's only kind comes from ``gmres.read``) lies inside the read
    span nearest to it, and a replay's first operation (the one after its
    program's copy-in) starts after its ``graph.launch`` span does.  A
    shift added to every device time keeps both true only between
    "lo_ns" and "hi_ns": clocks that agree give lo_ns <= 0 <= hi_ns, and
    otherwise the device's times read early by at least lo_ns, or late by
    at least -hi_ns.  Also counts the "reads", "copies" and "launches"
    compared."""
    spans = [s for s in program_spans if s[3] is not None]
    kinds = [short(name) for _, _, name in events]
    pairs = _read_copies(events, kinds, spans)
    lo = [t0 - a for (a, _, _), (t0, _) in pairs]
    hi = [t1 - b for (_, b, _), (_, t1) in pairs]
    launches = 0
    for name, _, t0, _, parent, _ in spans:
        if name != "graph.launch":
            continue
        i = bisect.bisect_left(events, (program_spans[parent][2],))
        while i < len(events) and kinds[i] != "Memcpy DtoD":
            i += 1
        while i < len(events) and kinds[i] == "Memcpy DtoD":
            i += 1
        if i < len(events):
            launches += 1
            lo.append(t0 - events[i][0])
    return {"reads": sum(s[0] == "gmres.read" for s in spans),
            "copies": len(pairs), "launches": launches,
            "lo_ns": max(lo, default=None), "hi_ns": min(hi, default=None)}


def realign(events, program_spans):
    """The device ``events`` moved onto the spans' clock.  torch.profiler
    maps the device's times to the host's clock once a trace, and on
    the H100 they can wander from it by several milliseconds within a
    second or two (``alignment`` shows it).  Each read's host returns
    just after its copy ends, so each copy is moved to end ``WAKE_NS``
    before its read span does, and the events between two copies move by
    an offset interpolated between theirs.  Returns (the moved events,
    sorted by start, [(device ns, offset ns)] at the copies)."""
    spans = [s for s in program_spans if s[3] is not None]
    pairs = _read_copies(events, [short(e[2]) for e in events], spans)
    if not pairs:
        return list(events), []
    at = [a for (a, _, _), _ in pairs]
    off = [t1 - b - WAKE_NS for (_, b, _), (_, t1) in pairs]

    def shift(t):
        i = bisect.bisect_right(at, t)
        if i == 0 or i == len(at):
            return off[min(i, len(at) - 1)]
        f = (t - at[i - 1]) / (at[i] - at[i - 1])
        return round(off[i - 1] + f * (off[i] - off[i - 1]))

    moved = sorted((a + shift(a), b + shift(a), name)
                   for a, b, name in events)
    return moved, list(zip(at, off))


def _profile(record):
    prof = record.get("profile")
    return prof if prof and prof.get("spans") else None


def _idle_pct(record, names):
    prof = _profile(record)
    if (prof is None or "idle_by_span" not in prof or not prof["window_s"]
            or not any(n in prof["spans"] for n in names)):
        return None
    idle = sum(prof["idle_by_span"].get(n, 0.0) for n in names)
    return idle / prof["window_s"] * 100


def replay_launch_us(record):
    """replay_launch_us.rhs: the mean duration of the traced segment's
    ``graph.launch`` spans (the host's ``CUDAGraph.replay`` call), in
    microseconds."""
    prof = _profile(record)
    entry = prof and prof["spans"].get("graph.launch")
    return entry[1] / entry[0] * 1e6 if entry else None


def replay_idle_pct(record):
    """replay_idle_pct.rhs: the device idle time whose innermost span is
    a program call or its launch or capture, as a share of the traced
    window."""
    return _idle_pct(record, PROGRAM_SPANS)


def gmres_host_idle_pct(record):
    """gmres_host_idle_pct.rhs: the device idle time whose innermost span
    is GMRES's own host work (its start, orthogonalisation, reads,
    rotations, each cycle's update; not the program calls inside them), as
    a share of the traced window."""
    return _idle_pct(record, GMRES_SPANS)


def setup_device_s(record):
    """setup_device_s: the seconds of the set-up's ``pcair.setup_device``
    span."""
    entry = (record.get("setup_spans") or {}).get("pcair.setup_device")
    return entry[1] if entry else None
