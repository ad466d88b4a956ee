"""Cumulative named wall-clock timers.

Reference: src/Timers.F90 -- cumulative timers keyed by setup phase
(air_setup, air_coarsen, air_extract, air_inverse, air_prolong,
air_restrict, air_rap), read with ``get_timers``.  A same-pattern
re-setup by stored plans (air/host_resetup.py) splits its levels'
time into resetup_gather, resetup_coeffs, resetup_inverse and
resetup_products.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch

_TIMERS: dict[str, float] = {}

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


@contextmanager
def timer(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _TIMERS[name] = _TIMERS.get(name, 0.0) + time.perf_counter() - t0


def reset_timers():
    _TIMERS.clear()


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
