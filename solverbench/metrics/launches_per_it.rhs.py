"""launches_per_it.rhs: launches of the port's three kernels (DIA, banded,
gather: their ``KERNEL_LAUNCHES``, a graph replay adding what its capture
counted) an iteration, over the window's solves."""


def read(record):
    reqs = [r for r in record["requests"] if "launches" in r]
    its = sum(r["its"] for r in reqs)
    return sum(r["launches"] for r in reqs) / its if its else None
