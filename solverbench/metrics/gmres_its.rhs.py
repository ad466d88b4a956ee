"""gmres_its.rhs: the mean iterations of the window's solves."""


def read(record):
    its = [r["its"] for r in record["requests"]]
    return sum(its) / len(its) if its else None
