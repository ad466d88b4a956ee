"""Operators shared by the port's CPU and card tests.  Imports neither jax
nor pflare_tpu, so the card tests can use it where only PyTorch runs."""

import functools

import numpy as np
import torch

import pflare_tpu_torch as tpf
from pflare_tpu_torch.air.fullspace import _map_both, make_op
from pflare_tpu_torch.sparse import BandedSpMV


@functools.cache
def _masked_level1():
    opts = tpf.AIROptions(a_lump=True, a_drop=1e-5, strong_threshold=0.99,
                          max_levels=6,
                          coarsest_inverse_type=tpf.InverseType.NEWTON,
                          coarsest_poly_order=24,
                          coarsest_matrix_free_polys=True)
    pc = tpf.PCAIR(opts, dtype=torch.float64, device="cpu")
    lvl = pc.setup(tpf.adv_diff_2d(128)).hierarchy.levels[1]
    fine = np.asarray(lvl.fine)
    A = _map_both(lvl.A_ff, fine, fine, lvl.n)
    assert isinstance(make_op(A), BandedSpMV)
    return A


def masked_level1():
    """The full-space level-1 A_ff of the 128^2 main-path hierarchy, as
    make_op receives it: 10,281 rows (not a multiple of 4), K = 2, w = 203,
    W = 640, and most slots pads (the rows of C points are empty).  A fresh
    copy on every call."""
    return _masked_level1().copy()
