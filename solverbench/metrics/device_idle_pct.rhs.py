"""device_idle_pct.rhs: the share of the traced solves' wall in which no
operation ran on the card."""


def read(record):
    prof = record["profile"]
    if not prof or not prof["busy_s"]:
        return None
    return (1 - prof["busy_s"] / prof["window_s"]) * 100
