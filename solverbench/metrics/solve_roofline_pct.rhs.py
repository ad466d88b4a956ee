"""solve_roofline_pct.rhs: the least time the traced solves' sparse
products need (their bytes, ``roofline.product_bytes`` of each product's
operator, over the H100's 3.35 TB/s) as a share of the device busy time of
the same solves."""

from solverbench.roofline import H100, least_seconds


def read(record):
    prof = record["profile"]
    if not prof or not prof.get("solve_bytes") or not prof["busy_s"]:
        return None
    return least_seconds(prof["solve_bytes"], H100) / prof["busy_s"] * 100
