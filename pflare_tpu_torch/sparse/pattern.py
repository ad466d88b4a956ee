"""Static sparsity patterns.

A ``SparsityPattern`` is the host-side description of a sparse matrix's
structure: the "symbolic" half of a gather container, whose numeric half
is a device tensor laid out against it (the reference's
dynamically-assembled PETSc AIJ structure, kept apart so a same-pattern
re-setup can re-run numeric code only; reference: docs/reuse.md:11,
src/PETSc_Helper.F90:490).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


class SparsityPattern:
    """CSR structure + derived padded-ELL layout.

    The ELL layout pads every row to ``K = max_row_nnz`` entries (at least
    1).  ``ell_cols`` [n_rows, K] holds column indices, 0 in padded slots
    (whose values are 0, so they add nothing to a SpMV); ``slot_of_pos``
    maps each CSR entry position to its flat ELL position row*K + slot.
    """

    __slots__ = ("shape", "nnz", "K", "indptr", "indices", "ell_cols",
                 "slot_of_pos")

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, shape):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int64)
        self.shape = (int(shape[0]), int(shape[1]))
        self.nnz = int(self.indices.shape[0])
        n_rows = self.shape[0]
        row_len = np.diff(self.indptr)
        self.K = max(int(row_len.max(initial=0)), 1)
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), row_len)
        offs = np.arange(self.nnz, dtype=np.int64) - np.repeat(
            self.indptr[:-1], row_len)
        self.ell_cols = np.zeros((n_rows, self.K), dtype=np.int32)
        self.ell_cols[rows, offs] = self.indices.astype(np.int32)
        self.slot_of_pos = rows * self.K + offs

    def row_of_pos(self) -> np.ndarray:
        """The row of each CSR entry."""
        return np.repeat(np.arange(self.shape[0], dtype=np.int64),
                         np.diff(self.indptr))

    def csr_bool(self) -> sp.csr_matrix:
        """Boolean scipy CSR with this pattern."""
        return sp.csr_matrix(
            (np.ones(self.nnz, dtype=bool), self.indices, self.indptr),
            shape=self.shape)

    def find(self, rows, cols) -> np.ndarray:
        """CSR positions of the (rows, cols) entries; -1 where absent."""
        keys = self.row_of_pos() * np.int64(self.shape[1]) + self.indices
        q = (np.asarray(rows, dtype=np.int64) * np.int64(self.shape[1])
             + np.asarray(cols, dtype=np.int64))
        if self.nnz == 0:
            return np.full(np.shape(q), -1, dtype=np.int64)
        pos = np.minimum(np.searchsorted(keys, q), self.nnz - 1)
        return np.where(keys[pos] == q, pos, -1)

    def diag_positions(self) -> np.ndarray:
        """CSR position of each row's diagonal entry; -1 where absent."""
        n = min(self.shape)
        idx = np.arange(n, dtype=np.int64)
        out = np.full(self.shape[0], -1, dtype=np.int64)
        out[:n] = self.find(idx, idx)
        return out
