"""host_reads.rhs: device-to-host reads a solve
(``pflare_tpu_torch.solvers.jitted.HOST_READS``), mean over the window."""


def read(record):
    reads = [r["host_reads"] for r in record["requests"] if "host_reads" in r]
    return sum(reads) / len(reads) if reads else None
