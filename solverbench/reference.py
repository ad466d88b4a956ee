"""The plain reference that decides ``correct``, and its control.

A solve's answer x is judged by what it says: the relative residual
||b - A x|| / ||b|| of x against the benchmark's own float64 operator A
(or A_k) and right-hand side b, in float64 by scipy.  The reference reads
the program's x only to judge it and takes nothing else from the program:
A comes from ``problems.py``, b from the benchmark's generator.

The control puts the reference's own answer in the program's place,
stored in the next precision below the configuration's float32: TF32
(10 explicit mantissa bits) and, below that, bfloat16 (7).  Its answer
is the exact solution of A x = b rounded to that precision, the best any
program computing in it could return, so its residual is a floor for
every such program.  The exact solution is known because the control
draws x first and makes b = A x in float64.

Imports numpy and scipy only.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

# explicit mantissa bits of the precisions below float32's 23
MANTISSA_BITS = {"tf32": 10, "bfloat16": 7}


def relative_residual(A: sp.spmatrix, x, b) -> float:
    """||b - A x||_2 / ||b||_2 in float64."""
    x = np.asarray(x, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    r = b - A @ x
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def round_mantissa(x, bits: int) -> np.ndarray:
    """float64 ``x`` rounded to nearest (ties to even) with ``bits``
    explicit mantissa bits and float32's exponent range."""
    x32 = np.asarray(x, dtype=np.float32)
    drop = 23 - bits
    if drop == 0:
        return x32.astype(np.float64)
    u = x32.view(np.uint32).astype(np.uint64)
    half = np.uint64(1 << (drop - 1))
    lsb = (u >> np.uint64(drop)) & np.uint64(1)
    u = (u + half - np.uint64(1) + lsb) >> np.uint64(drop) << np.uint64(drop)
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def control_residual(A: sp.spmatrix, seed: int, precision: str) -> float:
    """The control's reading on seed ``seed``: x drawn from the seed, b =
    A x in float64, the answer x rounded to ``precision``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(A.shape[0])
    b = A @ x
    return relative_residual(A, round_mantissa(x, MANTISSA_BITS[precision]),
                             b)
