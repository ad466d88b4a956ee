"""multilane_slot_pct.rhs: the share of the packed slots that the gather
kernel's launches read in the run (``pflare_tpu_torch.sparse.ell.
SLOTS_BY_LANES``: slots by the launch's lanes a row, counted where the
kernel is launched, a graph replay adding what its capture counted) that
launches of two or more lanes a row read.  None where the program keeps
no such counter or it is empty."""

import sys


def read(record):
    ell = sys.modules.get("pflare_tpu_torch.sparse.ell")
    slots = getattr(ell, "SLOTS_BY_LANES", None)
    total = sum(slots.values()) if slots else 0
    if not total:
        return None
    return sum(v for lanes, v in slots.items() if lanes >= 2) / total * 100
