"""PETSc binary matrix/vector readers.

Copied from ``pflare_tpu.problems.io``: the reference's load tests read
PETSc binary files (reference: tests/Makefile:85-135, tests/ex12f.F90).
The format is big-endian: an int32 class id, header ints, then the
payload (int32 row counts and column indices, f8 values).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

MAT_FILE_CLASSID = 1211216
VEC_FILE_CLASSID = 1211214


def read_petsc_matrix(path, return_vecs: bool = False):
    """Read a PETSc binary (AIJ) matrix into scipy CSR float64.

    With ``return_vecs`` also returns the vectors appended after the
    matrix in the same file (the reference's test data stores the
    physical RHS this way, e.g. tests/data/mat_stream_2364)."""
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=">i4", count=4)
        if header[0] != MAT_FILE_CLASSID:
            raise ValueError(f"{path}: not a PETSc binary matrix (classid "
                             f"{header[0]})")
        n_rows, n_cols, nnz = int(header[1]), int(header[2]), int(header[3])
        row_nnz = np.fromfile(f, dtype=">i4", count=n_rows)
        indices = np.fromfile(f, dtype=">i4", count=nnz)
        data = np.fromfile(f, dtype=">f8", count=nnz)
        vecs = []
        if return_vecs:
            while True:
                vh = np.fromfile(f, dtype=">i4", count=2)
                if len(vh) < 2 or vh[0] != VEC_FILE_CLASSID:
                    break
                vecs.append(np.fromfile(f, dtype=">f8", count=int(vh[1]))
                            .astype(np.float64))
    indptr = np.concatenate([[0], np.cumsum(row_nnz)]).astype(np.int64)
    A = sp.csr_matrix(
        (data.astype(np.float64), indices.astype(np.int64), indptr),
        shape=(n_rows, n_cols))
    A.sort_indices()
    if return_vecs:
        return A, vecs
    return A


def read_petsc_vec(path) -> np.ndarray:
    """Read a PETSc binary vector into a float64 array."""
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=">i4", count=2)
        if header[0] != VEC_FILE_CLASSID:
            raise ValueError(f"{path}: not a PETSc binary vector")
        n = int(header[1])
        return np.fromfile(f, dtype=">f8", count=n).astype(np.float64)
