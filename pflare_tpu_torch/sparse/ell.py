"""Padded-ELL sparse matrices with plain PyTorch matvecs.

``ELL`` keeps values and columns as ``[n_rows, K]``; ``TELL`` as
``[K, n_rows]``, the layout of the solve-phase operators that are neither
DIA nor banded: slot k of every row is one contiguous row of the tensor,
so each slot row is one coalesced stream.  The reference computes its
product with XLA, not Pallas, and fuses the slot loop inside its jitted
solve; here, on a CUDA tensor, ``TELL.matvec`` launches the hand-written
kernel ``csrc/tell_spmv.cu`` (one launch for all K slots), and on a CPU
tensor it runs ``tell_spmv_plain``, the slot loop of gathers, multiplies
and adds.  Padded slots hold value 0 and column 0, so they add nothing.
"""

from __future__ import annotations

import sys

import numpy as np
import scipy.sparse as sp
import torch

from .. import cuda
from ..utils import graphs
from .pattern import SparsityPattern
from .dtypes import numpy_dtype
from .spgemm import segment_sum

KERNEL_LAUNCHES = 0  # launches of csrc/tell_spmv.cu since the last reset
graphs.count_launches(sys.modules[__name__], "tell_spmv_kernel")
BLOCK_THREADS = 256  # csrc/tell_spmv.cu's kThreads: one row a thread


def tell_spmv_plain(data, cols, x):
    """Plain PyTorch TELL product: one gather, one multiply and one add a
    slot, summed in slot order (the reference's XLA loop,
    pflare_tpu/sparse/ell.py:217-223)."""
    y = None
    for k in range(data.shape[0]):
        term = data[k] * x.index_select(0, cols[k])
        y = term if y is None else y + term
    if y is None:
        return x.new_zeros(data.shape[1])
    return y


def tell_spmv_cuda(data, cols, x):
    """Launch ``csrc/tell_spmv.cu`` on PyTorch's current stream (no
    synchronisation): ``data`` ``[K, n]`` float32/float64 and ``cols``
    ``[K, n]`` int32, both contiguous, every column inside x."""
    global KERNEL_LAUNCHES
    K, n = data.shape
    if not (data.is_cuda and cols.device == data.device
            and x.device == data.device):
        raise ValueError("tell_spmv_cuda: tensors must be on one CUDA "
                         "device")
    if data.dtype not in (torch.float32, torch.float64) or x.dtype != data.dtype:
        raise ValueError(f"tell_spmv_cuda: dtypes {data.dtype}/{x.dtype}; "
                         "need float32 or float64, equal")
    if cols.dtype != torch.int32 or tuple(cols.shape) != (K, n):
        raise ValueError("tell_spmv_cuda: cols must be int32 [K, n]")
    if not (data.is_contiguous() and cols.is_contiguous()
            and x.is_contiguous() and x.dim() == 1):
        raise ValueError("tell_spmv_cuda: inputs must be contiguous, x 1-D")
    if K < 1:
        raise ValueError("tell_spmv_cuda: no slots")
    y = torch.empty(n, dtype=data.dtype, device=data.device)
    cuda.launch("tell_spmv", data.dtype, data.data_ptr(), cols.data_ptr(),
                x.data_ptr(), y.data_ptr(), n, K,
                cuda.stream_handle(data.device))
    KERNEL_LAUNCHES += 1
    return y


class ELL:
    """Sparse matrix: static pattern + ``[n_rows, K]`` value and int32
    column tensors."""

    def __init__(self, pattern: SparsityPattern, data, cols):
        self.pattern = pattern
        self.data = data
        self.cols = cols

    @property
    def shape(self):
        return self.pattern.shape

    @property
    def nnz(self):
        return self.pattern.nnz

    @property
    def dtype(self):
        return self.data.dtype

    @staticmethod
    def from_scipy(mat, dtype=None) -> "ELL":
        """From a scipy matrix; ``dtype`` (torch) defaults to the matrix's."""
        csr = sp.csr_matrix(mat)
        csr.sort_indices()
        pattern = SparsityPattern(csr.indptr, csr.indices, csr.shape)
        ndt = numpy_dtype(dtype, csr.data.dtype)
        flat = np.zeros(pattern.shape[0] * pattern.K, dtype=ndt)
        flat[pattern.slot_of_pos] = csr.data.astype(ndt)
        data = torch.from_numpy(flat.reshape(pattern.shape[0], pattern.K))
        return ELL(pattern, data, torch.from_numpy(pattern.ell_cols))

    @staticmethod
    def from_flat(pattern: SparsityPattern, flat_csr_data) -> "ELL":
        """From values in CSR entry order ``[nnz]`` (a tensor), on their
        device."""
        n, K = pattern.shape[0], pattern.K
        dev = flat_csr_data.device
        dense = flat_csr_data.new_zeros(n * K)
        dense[torch.as_tensor(pattern.slot_of_pos, device=dev)] = \
            flat_csr_data
        return ELL(pattern, dense.reshape(n, K),
                   torch.as_tensor(pattern.ell_cols, device=dev))

    def flat_values(self):
        """The values in CSR entry order ``[nnz]``."""
        return self.data.reshape(-1)[torch.as_tensor(
            self.pattern.slot_of_pos, device=self.data.device)]

    def with_data(self, data) -> "ELL":
        return ELL(self.pattern, data, self.cols)

    def to(self, device) -> "ELL":
        return ELL(self.pattern, self.data.to(device), self.cols.to(device))

    def to_scipy(self) -> sp.csr_matrix:
        flat = self.data.cpu().numpy().reshape(-1)
        return sp.csr_matrix(
            (flat[self.pattern.slot_of_pos],
             self.pattern.indices.astype(np.int64), self.pattern.indptr),
            shape=self.pattern.shape)

    def matvec(self, x):
        """y = A @ x: one gather + row sums."""
        n, K = self.data.shape
        gathered = x.index_select(0, self.cols.reshape(-1)).reshape(n, K)
        return (self.data * gathered).sum(dim=1)

    def matvec_t(self, x):
        """y = A.T @ x: each column's terms summed in row order
        (``segment_sum``), so a card gives the CPU's bits; an
        ``index_add_`` there would add them atomically, in no fixed
        order."""
        pat = self.pattern
        by_col = np.argsort(pat.indices, kind="stable")
        slots = torch.as_tensor(pat.slot_of_pos[by_col], device=x.device)
        terms = (self.data.reshape(-1)[slots]
                 * x.index_select(0, torch.div(slots, pat.K,
                                               rounding_mode="floor")))
        return segment_sum(terms, torch.as_tensor(
            np.bincount(pat.indices, minlength=pat.shape[1]),
            device=x.device))

    def diagonal(self):
        """The diagonal, 0 where absent."""
        rows = torch.arange(self.shape[0], device=self.cols.device)
        return torch.where(self.cols == rows[:, None], self.data,
                           0).sum(dim=1)

    def __matmul__(self, x):
        return self.matvec(x)


class TELL:
    """K-transposed padded ELL: ``data``/``cols`` are ``[K, n_rows]``."""

    def __init__(self, pattern: SparsityPattern, data, cols):
        self.pattern = pattern
        self.data = data
        self.cols = cols

    @property
    def shape(self):
        return self.pattern.shape

    @property
    def nnz(self):
        return self.pattern.nnz

    @property
    def dtype(self):
        return self.data.dtype

    @staticmethod
    def _slot_t(pattern) -> np.ndarray:
        """Transposed flat position of each CSR entry: slot * n + row."""
        sop = pattern.slot_of_pos
        K = pattern.K
        return (sop % K) * pattern.shape[0] + sop // K

    @staticmethod
    def from_scipy(mat, dtype=None) -> "TELL":
        """From a scipy matrix; ``dtype`` (torch) defaults to the matrix's."""
        csr = sp.csr_matrix(mat)
        csr.sort_indices()
        pattern = SparsityPattern(csr.indptr, csr.indices, csr.shape)
        ndt = numpy_dtype(dtype, csr.data.dtype)
        n, K = pattern.shape[0], pattern.K
        slot_t = TELL._slot_t(pattern)
        flat = np.zeros(K * n, dtype=ndt)
        flat[slot_t] = csr.data.astype(ndt)
        cols = np.zeros(K * n, dtype=np.int32)
        cols[slot_t] = pattern.indices.astype(np.int32)
        return TELL(pattern, torch.from_numpy(flat.reshape(K, n)),
                    torch.from_numpy(cols.reshape(K, n)))

    @staticmethod
    def from_flat(pattern: SparsityPattern, flat_csr_data) -> "TELL":
        """From values in CSR entry order ``[nnz]`` (a tensor), on their
        device."""
        n, K = pattern.shape[0], pattern.K
        dev = flat_csr_data.device
        slot_t = TELL._slot_t(pattern)
        dense = flat_csr_data.new_zeros(K * n)
        dense[torch.as_tensor(slot_t, device=dev)] = flat_csr_data
        cols = np.zeros(K * n, dtype=np.int32)
        cols[slot_t] = pattern.indices.astype(np.int32)
        return TELL(pattern, dense.reshape(K, n),
                    torch.as_tensor(cols.reshape(K, n), device=dev))

    def flat_values(self):
        """The values in CSR entry order ``[nnz]``."""
        return self.data.reshape(-1)[torch.as_tensor(
            TELL._slot_t(self.pattern), device=self.data.device)]

    def with_data(self, data) -> "TELL":
        return TELL(self.pattern, data, self.cols)

    def to_ell(self) -> ELL:
        """The ``[n, K]`` layout of the same matrix."""
        return ELL(self.pattern, self.data.T.contiguous(),
                   self.cols.T.contiguous())

    def to(self, device) -> "TELL":
        return TELL(self.pattern, self.data.to(device), self.cols.to(device))

    def to_scipy(self) -> sp.csr_matrix:
        flat = self.data.cpu().numpy().reshape(-1)
        return sp.csr_matrix(
            (flat[TELL._slot_t(self.pattern)],
             self.pattern.indices.astype(np.int64), self.pattern.indptr),
            shape=self.pattern.shape)

    def matvec(self, x):
        """y = A @ x, summed in slot order: the kernel on a CUDA tensor,
        the plain slot loop on a CPU one."""
        if x.is_cuda and self.data.shape[0]:
            return tell_spmv_cuda(self.data, self.cols, x.contiguous())
        return tell_spmv_plain(self.data, self.cols, x)

    def diagonal(self):
        """The diagonal, 0 where absent."""
        rows = torch.arange(self.shape[0], device=self.cols.device)
        return torch.where(self.cols == rows, self.data, 0).sum(dim=0)

    def __matmul__(self, x):
        return self.matvec(x)


def spmv(A, x):
    """y = A @ x for any of the port's sparse containers."""
    return A.matvec(x)
