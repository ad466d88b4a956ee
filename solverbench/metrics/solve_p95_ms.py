"""solve_p95_ms: the 95th percentile of the window's per-solve walls, in
milliseconds, over all the window's solves."""

import numpy as np


def read(record):
    walls = [r["wall_s"] for r in record["requests"]]
    return float(np.percentile(walls, 95)) * 1e3 if walls else None
