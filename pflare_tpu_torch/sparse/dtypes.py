"""The numpy dtype of a torch float dtype, and back."""

from __future__ import annotations

import numpy as np
import torch

_TO_NUMPY = {torch.float32: np.dtype(np.float32),
             torch.float64: np.dtype(np.float64)}


def numpy_dtype(dtype, default) -> np.dtype:
    """The numpy dtype of a torch (or numpy) ``dtype``; ``default`` when
    ``dtype`` is None."""
    if dtype is None:
        return np.dtype(default)
    if isinstance(dtype, torch.dtype):
        if dtype not in _TO_NUMPY:
            raise ValueError(f"unsupported dtype {dtype}")
        return _TO_NUMPY[dtype]
    return np.dtype(dtype)


def torch_dtype(dtype) -> torch.dtype:
    """The torch float dtype of a numpy float32 or float64 ``dtype``."""
    for t, n in _TO_NUMPY.items():
        if n == np.dtype(dtype):
            return t
    raise ValueError(f"unsupported dtype {dtype}")
