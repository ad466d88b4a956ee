"""Idle gaps named by the program's spans (``spans.py``) on fixed event
and span lists, and the readers of the span metrics on synthetic
records."""

import pytest

from solverbench import spans, trace

# device operations [(start_ns, end_ns, name)], sorted by start: a copy-in
# and two kernels of a replay, a read's copy, then a second replay
EVENTS = [
    (100, 110, "Memcpy DtoD (Device -> Device)"),
    (150, 200, "void dia_spmv_kernel<float, 3>(float const*)"),
    (190, 260, "sell_spmv_kernel"),
    (300, 310, "Memcpy DtoH (Device -> Pageable)"),
    (400, 405, "Memcpy DtoD (Device -> Device)"),
    (420, 480, "sell_spmv_kernel"),
]
W0, W1 = 0, 520
HARNESS = [("draw b", 0, 50), ("solve", 50, 500),
           ("synchronise", 500, 520)]
# (name, tag, start_ns, end_ns, parent, request), as timers.collect records
PROGRAM = [
    ("pcair.solve", None, 60, 495, -1, 0),
    ("program", "op", 90, 265, 0, 0),
    ("graph.launch", None, 120, 140, 1, 0),
    ("gmres.read", None, 270, 320, 0, 0),
    ("gmres.rotate", None, 320, 340, 0, 0),
    ("program", "resid", 390, 490, 0, 0),
    ("graph.launch", None, 410, 415, 5, 0),
]


def test_a_gap_takes_the_innermost_span_holding_its_midpoint():
    got = spans.read_gaps(EVENTS, HARNESS, PROGRAM, W0, W1)
    names = dict(got["idle_gaps"])
    # 0-100: midpoint 50 opens "solve" (start inclusive)
    assert names["solve: segment start -> Memcpy DtoD"] == 100e-9
    assert names["graph.launch: Memcpy DtoD -> dia_spmv_kernel"] == 40e-9
    assert names["gmres.read: sell_spmv_kernel -> Memcpy DtoH"] == 40e-9
    # 310-400: between the rotation and the next program, the solve's own
    assert names["pcair.solve: Memcpy DtoH -> Memcpy DtoD"] == 90e-9
    assert names["graph.launch: Memcpy DtoD -> sell_spmv_kernel"] == 15e-9
    assert names["synchronise: sell_spmv_kernel -> segment end"] == 40e-9
    assert got["idle_by_span"] == pytest.approx(
        {"solve": 100e-9, "graph.launch": 55e-9, "gmres.read": 40e-9,
         "pcair.solve": 90e-9, "synchronise": 40e-9}, rel=0, abs=1e-18)


def test_idle_by_span_sums_to_the_idle_time_and_busy_reads_as_before():
    before = trace.read_events(EVENTS, HARNESS, W0, W1)
    got = spans.read_gaps(EVENTS, HARNESS, PROGRAM, W0, W1)
    idle = (W1 - W0) / 1e9 - before["busy_s"]
    assert got["idle_s"] == pytest.approx(idle, rel=1e-12)
    assert sum(got["idle_by_span"].values()) == pytest.approx(idle,
                                                              rel=1e-12)
    # without program spans the gaps read exactly as trace.read_events's
    plain = spans.read_gaps(EVENTS, HARNESS, [], W0, W1)
    assert plain["idle_gaps"] == before["idle_gaps"]
    assert trace.read_events(EVENTS, HARNESS, W0, W1) == before


def test_innermost_of_nested_intervals():
    intervals = [(0, 100, "a"), (10, 50, "b"), (10, 50, "c"),
                 (20, 30, "d"), (60, 70, "e")]
    points = [0, 5, 10, 25, 30, 55, 65, 99, 100]
    assert spans.innermost(intervals, points) == [
        "a", "a", "c", "d", "c", "a", "e", "a", None]


def test_alignment_of_reads_and_launches():
    got = spans.alignment(EVENTS, PROGRAM)
    assert got["reads"] == got["copies"] == 1 and got["launches"] == 2
    # the copy 300-310 in the read 270-320 may move 30 ns back, 10 on;
    # the first ops after the copy-ins start 30 and 10 ns after their
    # launches, so they may move 10 ns back
    assert (got["lo_ns"], got["hi_ns"]) == (-10, 10)
    late = [("graph.launch", None, 430, 440, 5, 0)
            if s[0] == "graph.launch" and s[2] == 410 else s
            for s in PROGRAM]
    assert spans.alignment(EVENTS, late)["lo_ns"] == 10
    # a copy dropped from the trace leaves the others paired with theirs
    reads = PROGRAM + [("gmres.read", None, 600, 650, 0, 0)]
    assert spans.alignment(EVENTS, reads)["hi_ns"] == 10


US = 1000


def test_realign_moves_wandering_device_times_back():
    """Device times 300 us late at the first read and 500 us late at the
    second: each copy moves to end WAKE_NS before its read does, and a
    kernel between them by the interpolated offset."""
    reads = [("pcair.solve", None, 0, 4000 * US, -1, 0),
             ("gmres.read", None, 1000 * US, 1200 * US, 0, 0),
             ("gmres.read", None, 3000 * US, 3100 * US, 0, 0)]
    end1, end2 = 1200 * US - spans.WAKE_NS, 3100 * US - spans.WAKE_NS
    true = [(end1 - 5 * US, end1, "Memcpy DtoH (Device -> Pageable)"),
            (2000 * US, 2500 * US, "sell_spmv_kernel"),
            (end2 - 5 * US, end2, "Memcpy DtoH (Device -> Pageable)")]
    late = [(true[0][0] + 300 * US, true[0][1] + 300 * US, true[0][2]),
            (true[1][0] + 400 * US, true[1][1] + 400 * US, true[1][2]),
            (true[2][0] + 500 * US, true[2][1] + 500 * US, true[2][2])]
    assert spans.alignment(late, reads)["hi_ns"] < 0
    moved, offsets = spans.realign(late, reads)
    assert [o for _, o in offsets] == [-300 * US, -500 * US]
    assert moved[0] == true[0] and moved[2] == true[2]
    # the kernel starts at 2400 us, 920/2100 of the way between the
    # copies' starts (1480 and 3580 us), so it moves back 387.6 us
    assert moved[1][0] == 2400 * US - round(300 * US + 920 / 2100 * 200 * US)
    fixed = spans.alignment(moved, reads)
    assert fixed["lo_ns"] <= 0 <= fixed["hi_ns"] == spans.WAKE_NS
    assert spans.realign(true[1:2], reads) == (true[1:2], [])


def record(prof=None, setup=None):
    out = {"profile": prof}
    if setup is not None:
        out["setup_spans"] = setup
    return out


PROFILE = {"window_s": 2.0, "busy_s": 1.5,
           "spans": {"pcair.solve": [10, 1.9, 0.1],
                     "program": [70, 1.2, 0.2],
                     "graph.launch": [70, 0.028, 0.028],
                     "gmres.read": [60, 0.3, 0.3]},
           "idle_by_span": {"graph.launch": 0.2, "program": 0.05,
                            "gmres.read": 0.1, "gmres.rotate": 0.02,
                            "solve": 0.01}}


def test_readers_of_the_span_metrics():
    rec = record(PROFILE, {"pcair.setup_device": [1, 19.5, 0.01],
                           "air_setup": [1, 18.0, 0.5]})
    assert spans.replay_launch_us(rec) == pytest.approx(400.0)
    assert spans.replay_idle_pct(rec) == pytest.approx(12.5)
    assert spans.gmres_host_idle_pct(rec) == pytest.approx(6.0)
    assert spans.setup_device_s(rec) == 19.5


@pytest.mark.parametrize("rec", [
    record(), record(None, {}),
    record({"window_s": 2.0, "busy_s": 1.5, "device_ops": [],
            "idle_gaps": []}),
    record(dict(PROFILE, spans={})),
], ids=["no profile", "no setup spans", "no program spans",
        "empty span summary"])
def test_readers_find_nothing_without_spans(rec):
    for read in (spans.replay_launch_us, spans.replay_idle_pct,
                 spans.gmres_host_idle_pct, spans.setup_device_s):
        assert read(rec) is None
