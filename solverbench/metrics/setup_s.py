"""setup_s: seconds from the start of the run to the opening of the
measured window (imports, card start-up, kernel builds, the operator's
generation, the preconditioner's set-up, the warm requests)."""


def read(record):
    return record["setup_s"]
