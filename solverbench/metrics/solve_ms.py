"""solve_ms: milliseconds a solve, the window's wall from the first request's
start to the last one's end, over the solves it completed."""


def read(record):
    n = len(record["requests"])
    return record["window_s"] / n * 1e3 if n else None
