"""The benchmark's table of peaks and its count of a sparse product's bytes.

A frozen copy of the bound in ``chip_smoke.py::measure``: a product
y = A x needs each nonzero of A once (its value, and a 4-byte column
index unless the operator is stored by diagonals), each entry of x that
a nonzero reads once, and each entry of y once.  Padded slots hold zeros
and add nothing, whatever a layout stores.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

# NVIDIA H100 SXM (data sheet): HBM3 bytes a second
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_s": 3.35e12}}
H100 = PEAKS["NVIDIA H100 80GB HBM3"]

INDEX_BYTES = 4


def product_bytes(A: sp.spmatrix, value_bytes: int,
                  diagonal_storage: bool = False) -> int:
    """Bytes one product ``A @ x`` needs: nonzeros x (value bytes + index
    bytes, none for an operator stored by diagonals) + (columns that hold
    a nonzero + rows) x value bytes.  Stored zeros are not nonzeros."""
    A = sp.csr_matrix(A)
    A.eliminate_zeros()
    n_rows = A.shape[0]
    cols_read = int(np.count_nonzero(np.bincount(A.indices,
                                                 minlength=A.shape[1])))
    index = 0 if diagonal_storage else INDEX_BYTES
    return int(A.nnz * (value_bytes + index)
               + (cols_read + n_rows) * value_bytes)


def least_seconds(n_bytes: float, peaks: dict = H100) -> float:
    """The least time the card's memory needs to move ``n_bytes``."""
    return n_bytes / peaks["hbm_bytes_s"]
