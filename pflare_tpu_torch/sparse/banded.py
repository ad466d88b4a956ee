"""Banded windowed-gather SpMV (``BandedSpMV``) and its kernel.

For matrices of bounded bandwidth w, rows go in tiles of ``TILE_ROWS``;
the columns tile t touches lie in two consecutive aligned W-blocks of the
zero-padded ``x_pad`` (``x_pad[i] = x[i - w]``), starting at block
j(t) = (t * TILE_ROWS) // W.  Slot k of row i stores ``data[k, i]`` and
the window-local column ``lcols[k, i]`` in [0, 2W).  This is the layout
of the reference (pflare_tpu/sparse/banded.py:110-136), so ``to_scipy``
carries over unchanged.

On a CUDA tensor ``matvec`` launches the hand-written kernel
``csrc/banded_spmv.cu``; on a CPU tensor it runs ``banded_spmv_plain``,
the same product as a PyTorch gather from ``x_pad``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from .. import cuda
from .dtypes import numpy_dtype

TILE_ROWS = 128
# The reference's size envelope (its one-hot blocks had to fit TPU VMEM);
# kept so both packages choose the same container for every operator.
_ENVELOPE_BYTES = 12 * 1024 * 1024
KERNEL_LAUNCHES = 0  # launches of csrc/banded_spmv.cu since the last reset


def banded_spmv_plain(data, lcols, x, n: int, w: int, W: int):
    """Plain PyTorch product: build x_pad, gather it at each row's window
    base + lcols, and sum data * gathered over the slots in order."""
    K, n_pad = data.shape
    j_last = ((n_pad // TILE_ROWS - 1) * TILE_ROWS) // W
    total = (j_last + 2) * W
    x_pad = F.pad(x, (w, max(total - w - x.shape[0], 0)))
    # x_pad index of each row's window slot 0: j(t) * W for its tile t
    rows = torch.arange(n_pad, device=x.device)
    base = (rows // TILE_ROWS * TILE_ROWS) // W * W
    y = None
    for k in range(K):
        term = data[k] * x_pad[base + lcols[k]]
        y = term if y is None else y + term
    return y[:n]


def banded_spmv_cuda(data, lcols, x, n: int, n_cols: int, w: int, W: int):
    """Launch ``csrc/banded_spmv.cu`` on PyTorch's current stream (no
    synchronisation)."""
    global KERNEL_LAUNCHES
    K, n_pad = data.shape
    if not (data.is_cuda and lcols.device == data.device
            and x.device == data.device):
        raise ValueError("banded_spmv_cuda: tensors must be on one CUDA "
                         "device")
    if data.dtype not in (torch.float32, torch.float64) or x.dtype != data.dtype:
        raise ValueError(f"banded_spmv_cuda: dtypes {data.dtype}/{x.dtype}; "
                         "need float32 or float64, equal")
    if lcols.dtype != torch.int32 or tuple(lcols.shape) != (K, n_pad):
        raise ValueError("banded_spmv_cuda: lcols must be int32 [K, n_pad]")
    if not (data.is_contiguous() and lcols.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("banded_spmv_cuda: inputs must be contiguous")
    if tuple(x.shape) != (n_cols,) or n_pad % TILE_ROWS or n_pad < n:
        raise ValueError(f"banded_spmv_cuda: x {tuple(x.shape)} for "
                         f"n_cols={n_cols}, n_pad={n_pad}, n={n}")
    if data.data_ptr() % 16 or lcols.data_ptr() % 16:
        raise ValueError("banded_spmv_cuda: data and lcols must be 16-byte "
                         "aligned (the kernel reads four rows at a time)")
    y = torch.empty(n, dtype=data.dtype, device=data.device)
    cuda.launch("banded_spmv", data.dtype, data.data_ptr(), lcols.data_ptr(),
                x.data_ptr(), y.data_ptr(), n, n_pad, n_cols, K, w, W,
                cuda.stream_handle(data.device))
    KERNEL_LAUNCHES += 1
    return y


class BandedSpMV:
    """data ``[K, n_pad]`` values; lcols ``[K, n_pad]`` int32 window-local
    columns (see module docstring); pad slots hold data 0."""

    def __init__(self, data, lcols, n: int, n_cols: int, w: int, W: int):
        self.data = data
        self.lcols = lcols
        self.n = int(n)
        self.n_cols = int(n_cols)
        self.w = int(w)          # one-sided bandwidth
        self.W = int(W)          # aligned block width (multiple of 128)

    @property
    def shape(self):
        return (self.n, self.n_cols)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self):
        return int(torch.count_nonzero(self.data))

    @staticmethod
    def bandwidth(A: sp.csr_matrix) -> int:
        A = sp.csr_matrix(A)
        if A.nnz == 0:
            return 0
        rows = np.repeat(np.arange(A.shape[0], dtype=np.int64),
                         np.diff(A.indptr))
        return int(np.abs(A.indices - rows).max())

    @staticmethod
    def viable(A) -> bool:
        """Square, at least four tiles, and inside the reference's size
        envelope -- the predicate of pflare_tpu/sparse/banded.py:95-107."""
        A = sp.csr_matrix(A)
        if A.nnz == 0 or A.shape[0] < 4 * TILE_ROWS:
            return False
        if A.shape[0] != A.shape[1]:
            return False
        K = int(np.diff(A.indptr).max())
        w = BandedSpMV.bandwidth(A)
        W = -(-(2 * w + TILE_ROWS) // 128) * 128
        return 2 * TILE_ROWS * K * W * 4 <= _ENVELOPE_BYTES

    @staticmethod
    def from_scipy(A, dtype=None) -> "BandedSpMV":
        """From a scipy matrix; ``dtype`` (torch) defaults to the matrix's."""
        A = sp.csr_matrix(A)
        A.sort_indices()
        n, n_cols = A.shape
        w = BandedSpMV.bandwidth(A)
        W = -(-(2 * w + TILE_ROWS) // 128) * 128
        K = max(1, int(np.diff(A.indptr).max()))
        n_pad = -(-n // TILE_ROWS) * TILE_ROWS
        ndt = numpy_dtype(dtype, A.data.dtype)
        data = np.zeros((K, n_pad), dtype=ndt)
        lcols = np.zeros((K, n_pad), dtype=np.int32)
        counts = np.diff(A.indptr)
        rows = np.repeat(np.arange(n, dtype=np.int64), counts)
        slot = np.arange(A.nnz, dtype=np.int64) - np.repeat(
            A.indptr[:-1], counts)
        # x_pad[i] = x[i - w]; tile t touches x_pad[t*TR, t*TR + TR + 2w),
        # inside blocks j(t) and j(t)+1 with j(t) = (t*TR) // W
        j = (rows // TILE_ROWS * TILE_ROWS) // W
        local = (A.indices + w - j * W).astype(np.int64)
        if A.nnz and (local.min() < 0 or local.max() >= 2 * W):
            raise ValueError("bandwidth accounting failed")
        data[slot, rows] = A.data.astype(ndt)
        lcols[slot, rows] = local.astype(np.int32)
        return BandedSpMV(torch.from_numpy(data), torch.from_numpy(lcols),
                          n, n_cols, w, W)

    def to(self, device) -> "BandedSpMV":
        return BandedSpMV(self.data.to(device), self.lcols.to(device),
                          self.n, self.n_cols, self.w, self.W)

    def matvec(self, x):
        if x.is_cuda:
            return banded_spmv_cuda(self.data, self.lcols, x, self.n,
                                    self.n_cols, self.w, self.W)
        return banded_spmv_plain(self.data, self.lcols, x, self.n, self.w,
                                 self.W)

    def __matmul__(self, x):
        return self.matvec(x)

    def to_scipy(self) -> sp.csr_matrix:
        data = self.data.cpu().numpy().T        # [n_pad, K]
        lcols = self.lcols.cpu().numpy().T
        n_pad, K = data.shape
        rows = np.repeat(np.arange(n_pad), K)
        j = (rows // TILE_ROWS * TILE_ROWS) // self.W
        cols = lcols.reshape(-1) + j * self.W - self.w
        vals = data.reshape(-1)
        ok = ((vals != 0) & (cols >= 0) & (cols < self.n_cols)
              & (rows < self.n))
        M = sp.csr_matrix((vals[ok], (rows[ok], cols[ok])),
                          shape=(self.n, self.n_cols))
        M.sort_indices()
        return M
