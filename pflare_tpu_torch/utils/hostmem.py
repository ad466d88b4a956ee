"""Host allocator tuning for repeated hierarchy setups.

Ported from ``pflare_tpu.utils.hostmem``.  glibc malloc serves
allocations above ~128 KB with mmap() and returns them with munmap() on
free, so every fresh setup faults its nnz-sized arrays (the levels'
indptr/indices/data, the products' scratch) in again at page-zeroing
speed.  Two mallopt calls keep those pages on the heap across setups,
the steady state PETSc reaches with its own slab allocator.  Call
:func:`tune_host_malloc` once at startup in a process that sets up
repeatedly.
"""

from __future__ import annotations

_APPLIED = False


def tune_host_malloc() -> bool:
    """Keep large allocations heap-resident across setups: glibc
    ``M_TRIM_THRESHOLD`` to its maximum (never give heap pages back to
    the kernel) and ``M_MMAP_MAX`` to 0 (never serve a large block from a
    fresh mmap).  Idempotent; True when applied, False where there is no
    glibc (a no-op there)."""
    global _APPLIED
    if _APPLIED:
        return True
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-1, 2**31 - 1)  # M_TRIM_THRESHOLD
        libc.mallopt(-4, 0)          # M_MMAP_MAX
    except (OSError, AttributeError):
        return False
    _APPLIED = True
    return True
