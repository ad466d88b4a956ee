"""Cumulative named wall-clock timers.

Reference: src/Timers.F90 -- cumulative timers keyed by setup phase
(air_setup, air_coarsen, air_extract, air_inverse, air_prolong,
air_restrict, air_rap), read with ``get_timers`` and ``timer_time``,
with the number of timed regions of each in ``_COUNTS``.  A same-pattern
re-setup by stored plans (air/host_resetup.py) splits its levels'
time into resetup_gather, resetup_coeffs, resetup_inverse and
resetup_products.

Spans: while ``collect()`` is open, every ``timer`` and every ``span``
of the thread that opened it appends one record ``(name, tag, start_ns,
end_ns, parent, request)`` to the list it yields, on ``time.time_ns``'s
clock, the one ``torch.profiler`` maps its event times to, so a span
lines up with the device operations of a trace.  ``parent`` is the index of the
enclosing open span (-1 for none) and ``request`` the index of the
outermost one (a ``pcair.solve`` or ``pcair.setup_device``), shared by
the spans of one request; ``summary`` sums them by name.  With no
collector open a ``span`` reads no clock and records nothing.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager, nullcontext

import torch

_TIMERS: dict[str, float] = {}
_COUNTS: dict[str, int] = {}

# the reference's printed timer names (src/Timers.F90:31-70), so output
# parsers carry over
LABELS = {
    "air_setup": "Total setup time",
    "air_coarsen": "CF splitting time",
    "air_extract": "Submatrix extraction time",
    "air_inverse": "Approximate inverse time",
    "air_prolong": "Prolongator time",
    "air_restrict": "Restrictor time",
    "air_rap": "RAP time",
    "air_drop": "Drop tolerance time",
    "air_identity": "Identity/IS time",
    "air_constrain": "Constraint time",
    "air_repartition": "Repartition time",
    "air_reuse_plan": "Reuse plan time",
    "resetup_gather": "Re-setup gather time",
    "resetup_coeffs": "Re-setup coefficient time",
    "resetup_inverse": "Re-setup inverse time",
    "resetup_products": "Re-setup product time",
}


_SPANS: list | None = None   # the open collector's records
_OPEN: list = []              # the indices of its open spans, innermost last
_THREAD = None                # the thread that opened it


@contextmanager
def collect():
    """Record every span while open: yields the list of records (see the
    module docstring), which grows as spans open and close.  Spans of
    other threads are not recorded.  Collectors do not nest."""
    global _SPANS, _THREAD
    if _SPANS is not None:
        raise RuntimeError("a span collector is already open")
    spans = []
    _SPANS, _THREAD = spans, threading.get_ident()
    try:
        yield spans
    finally:
        _SPANS, _THREAD = None, None
        _OPEN.clear()


def _open(name, tag, t0):
    """Append an open record; (its list, its index), or None when no
    collector of this thread is open."""
    spans = _SPANS
    if spans is None or threading.get_ident() != _THREAD:
        return None
    i = len(spans)
    parent = _OPEN[-1] if _OPEN else -1
    spans.append((name, tag, t0, None, parent,
                  spans[parent][5] if parent >= 0 else i))
    _OPEN.append(i)
    return spans, i


def _close(at, t1):
    spans, i = at
    name, tag, t0, _, parent, request = spans[i]
    spans[i] = (name, tag, t0, t1, parent, request)
    if i in _OPEN:      # children left open by an exception close with it
        del _OPEN[_OPEN.index(i):]


class Stopwatch:
    """A span that always reads the clock: ``seconds`` once it closes
    (for callers that keep the time), recorded when collecting."""

    __slots__ = ("name", "tag", "start_ns", "seconds", "_at")

    def __init__(self, name: str, tag=None):
        self.name, self.tag = name, tag
        self.seconds = None

    def __enter__(self):
        self.start_ns = time.time_ns()
        self._at = _open(self.name, self.tag, self.start_ns)
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.seconds = (t1 - self.start_ns) / 1e9
        if self._at is not None:
            _close(self._at, t1)
        return False


_NO_SPAN = nullcontext()   # what ``span`` gives with no collector open


def span(name: str, tag=None):
    """A context that records the span ``name`` (with ``tag``) while a
    collector is open; otherwise a shared no-op, which reads no clock."""
    if _SPANS is None:
        return _NO_SPAN
    return Stopwatch(name, tag)


class timer(Stopwatch):
    """The reference's cumulative timer ``name``: adds its seconds to
    ``get_timers()`` and one to ``_COUNTS``, and is a span when
    collecting."""

    __slots__ = ()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        _TIMERS[self.name] = _TIMERS.get(self.name, 0.0) + self.seconds
        _COUNTS[self.name] = _COUNTS.get(self.name, 0) + 1
        return False


def summary(spans) -> dict:
    """{name: [count, seconds, self seconds]} of the closed ``spans``
    (records of ``collect``): a span's self time is its duration less the
    durations of its child spans."""
    out = {}
    child = [0] * len(spans)
    for _, _, t0, t1, parent, _ in spans:
        if t1 is not None and parent >= 0:
            child[parent] += t1 - t0
    for i, (name, _, t0, t1, _, _) in enumerate(spans):
        if t1 is None:
            continue
        entry = out.setdefault(name, [0, 0.0, 0.0])
        entry[0] += 1
        entry[1] += (t1 - t0) / 1e9
        entry[2] += (t1 - t0 - child[i]) / 1e9
    return out


def timer_time(name: str) -> float:
    """The seconds timed under ``name`` so far (0 if none)."""
    return _TIMERS.get(name, 0.0)


def reset_timers():
    _TIMERS.clear()
    _COUNTS.clear()


def get_timers() -> dict:
    return dict(_TIMERS)


def print_timers():
    for name, label in LABELS.items():
        if name in _TIMERS:
            print(f" {label} : {_TIMERS[name]:.6f}")


def device_sync_read(*tensors) -> float:
    """The timing barrier: synchronise the device, then read back a value
    that depends on every given tensor (the sum, in float64), so a timed
    region ends when the work has finished and not when it was enqueued.
    Returns the sum, which also exposes a NaN."""
    if any(t.is_cuda for t in tensors):
        torch.cuda.synchronize()
    return float(sum(float(t.double().sum()) for t in tensors))


_SYNC_LOGS: list = []   # the warning lists of the active count_syncs


def _syncs_in(caught) -> int:
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def count_syncs(fn, *args, **kw):
    """(``fn(*args, **kw)``, the synchronisations of the host with a CUDA
    device it made): run under ``torch.cuda.set_sync_debug_mode("warn")``,
    which warns at each (a read of a device value, a pageable copy, a
    stream or device synchronise) with the message counted here.  Inside
    ``fn``, ``current_syncs`` reads the count so far."""
    import warnings

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        _SYNC_LOGS.append(caught)
        try:
            out = fn(*args, **kw)
        finally:
            _SYNC_LOGS.pop()
            torch.cuda.set_sync_debug_mode(prev)
    return out, _syncs_in(caught)


def current_syncs():
    """The synchronisations counted so far by the innermost active
    ``count_syncs``, or None outside one."""
    return _syncs_in(_SYNC_LOGS[-1]) if _SYNC_LOGS else None
