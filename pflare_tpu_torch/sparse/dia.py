"""DIA (offset-diagonal) sparse matrices and the DIA SpMV kernel.

Matrices whose entries lie on a few column offsets -- structured stencils,
and every full-space masked operator derived from them (air/fullspace.py)
-- store one length-n_rows row of values per offset:

    y[i] = sum_k data[k, i] * x[i + offset_k]

On a CUDA tensor ``DIA.matvec`` launches the hand-written kernel
``csrc/dia_spmv.cu``; on a CPU tensor it runs ``dia_spmv_plain``, the
reference's XLA loop (pflare_tpu/sparse/dia.py:197-205) in PyTorch.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from .. import cuda
from .dtypes import numpy_dtype

MAX_OFFSETS = 16     # the kernel takes its offsets by value
KERNEL_LAUNCHES = 0  # launches of csrc/dia_spmv.cu since the last reset
# csrc/dia_spmv.cu's grouping (kThreads, Chunk<T>::rows): a block of
# BLOCK_THREADS threads, each owning ROWS_PER_THREAD consecutive rows
BLOCK_THREADS = 256
ROWS_PER_THREAD = {torch.float32: 4, torch.float64: 2}


def dia_spmv_plain(data, offsets, x, n_rows: int, n_cols: int):
    """Plain PyTorch DIA product: x zero-padded so every shifted slice
    exists, one slice times one data row per offset, summed in ascending
    offset order."""
    pad_lo = max(0, -min(offsets))
    pad_hi = max(0, max(offsets) + n_rows - n_cols)
    xp = F.pad(x, (pad_lo, pad_hi))
    y = None
    for k, off in enumerate(offsets):
        term = data[k] * xp[pad_lo + off: pad_lo + off + n_rows]
        y = term if y is None else y + term
    return y


def dia_spmv_cuda(data, offsets, x, n_rows: int, n_cols: int):
    """Launch ``csrc/dia_spmv.cu`` on PyTorch's current stream (no
    synchronisation).  ``data`` is ``[K, n_rows]``, ``x`` ``[n_cols]``,
    both contiguous CUDA tensors of one float dtype, at any alignment: the
    kernel reads 16 bytes at a time where data is 16-byte aligned and
    n_rows a multiple of its rows per thread, and one value at a time
    otherwise."""
    global KERNEL_LAUNCHES
    K = len(offsets)
    if not (data.is_cuda and x.is_cuda and data.device == x.device):
        raise ValueError("dia_spmv_cuda: data and x must be on one CUDA "
                         "device")
    if data.dtype not in (torch.float32, torch.float64) or x.dtype != data.dtype:
        raise ValueError(f"dia_spmv_cuda: dtypes {data.dtype}/{x.dtype}; "
                         "need float32 or float64, equal")
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("dia_spmv_cuda: inputs must be contiguous")
    if tuple(data.shape) != (K, n_rows) or tuple(x.shape) != (n_cols,):
        raise ValueError(f"dia_spmv_cuda: shapes {tuple(data.shape)}, "
                         f"{tuple(x.shape)} for K={K}, n_rows={n_rows}, "
                         f"n_cols={n_cols}")
    if not 1 <= K <= MAX_OFFSETS:
        raise ValueError(f"dia_spmv_cuda: {K} offsets, the kernel takes "
                         f"1..{MAX_OFFSETS}")
    y = torch.empty(n_rows, dtype=data.dtype, device=data.device)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    cuda.launch("dia_spmv", data.dtype, data.data_ptr(), x.data_ptr(),
                y.data_ptr(), n_rows, n_cols, offs.ctypes.data, K,
                cuda.stream_handle(data.device))
    KERNEL_LAUNCHES += 1
    return y


class DIA:
    """offsets: tuple of ints; data: ``[len(offsets), n_rows]`` tensor."""

    def __init__(self, offsets, data, shape):
        self.offsets = tuple(int(o) for o in offsets)
        self.data = data
        self.shape = (int(shape[0]), int(shape[1]))

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self):
        return int(torch.count_nonzero(self.data))

    @staticmethod
    def from_scipy(M, dtype=None) -> "DIA":
        """From a scipy matrix; ``dtype`` (torch) defaults to the matrix's."""
        M = sp.csr_matrix(M)
        M.sort_indices()
        n_rows = M.shape[0]
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(M.indptr))
        offs = M.indices - rows
        uniq = np.unique(offs)
        ndt = numpy_dtype(dtype, M.data.dtype)
        data = np.zeros((len(uniq), n_rows), dtype=ndt)
        data[np.searchsorted(uniq, offs), rows] = M.data.astype(ndt)
        return DIA(uniq.tolist(), torch.from_numpy(data), M.shape)

    @staticmethod
    def viable(M, max_offsets: int = 8, max_fill_ratio: float = 3.0) -> bool:
        """Is the DIA form worth it for this matrix?"""
        M = sp.csr_matrix(M)
        if M.nnz == 0:
            return False
        rows = np.repeat(np.arange(M.shape[0], dtype=np.int64),
                         np.diff(M.indptr))
        n_off = len(np.unique(M.indices - rows))
        return (n_off <= max_offsets
                and n_off * M.shape[0] <= max_fill_ratio * M.nnz)

    def to(self, device) -> "DIA":
        return DIA(self.offsets, self.data.to(device), self.shape)

    def matvec(self, x):
        n_rows, n_cols = self.shape
        if not self.offsets:
            return torch.zeros(n_rows, dtype=self.data.dtype, device=x.device)
        if x.is_cuda:
            return dia_spmv_cuda(self.data, self.offsets, x, n_rows, n_cols)
        return dia_spmv_plain(self.data, self.offsets, x, n_rows, n_cols)

    def __matmul__(self, x):
        return self.matvec(x)

    def to_scipy(self) -> sp.csr_matrix:
        n_rows, n_cols = self.shape
        data = self.data.cpu().numpy()
        rows_l, cols_l, vals_l = [], [], []
        for k, off in enumerate(self.offsets):
            i = np.arange(n_rows)
            j = i + off
            ok = (j >= 0) & (j < n_cols) & (data[k] != 0)
            rows_l.append(i[ok])
            cols_l.append(j[ok])
            vals_l.append(data[k][ok])
        M = sp.csr_matrix(
            (np.concatenate(vals_l), (np.concatenate(rows_l),
                                      np.concatenate(cols_l))),
            shape=self.shape,
        )
        M.sort_indices()
        return M
