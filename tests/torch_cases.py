"""Operators shared by the port's CPU and card tests.  Imports neither jax
nor pflare_tpu, so the card tests can use it where only PyTorch runs."""

import functools

import numpy as np
import scipy.sparse as sp
import torch

import pflare_tpu_torch as tpf
from pflare_tpu_torch.air.fullspace import (_map_both, _map_cols, _map_rows,
                                            make_op)
from pflare_tpu_torch.sparse import DIA, BandedSpMV

LEVEL0_OPERATORS = ("A_ff", "A_fc", "R", "P")


@functools.cache
def _levels128():
    """The host levels of the 128^2 main-path hierarchy (f64)."""
    opts = tpf.AIROptions(a_lump=True, a_drop=1e-5, strong_threshold=0.99,
                          max_levels=6,
                          coarsest_inverse_type=tpf.InverseType.NEWTON,
                          coarsest_poly_order=24,
                          coarsest_matrix_free_polys=True)
    pc = tpf.PCAIR(opts, dtype=torch.float64, device="cpu")
    return pc.setup(tpf.adv_diff_2d(128)).hierarchy.levels


@functools.cache
def _masked_level1():
    lvl = _levels128()[1]
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


@functools.cache
def _masked_level0(name):
    lvl = _levels128()[0]
    fine, coarse, n = np.asarray(lvl.fine), np.asarray(lvl.coarse), lvl.n
    A = {"A_ff": lambda: _map_both(lvl.A_ff, fine, fine, n),
         "A_fc": lambda: _map_both(lvl.A_fc, fine, coarse, n),
         "R": lambda: _map_rows(lvl.R, coarse, n),
         "P": lambda: _map_cols(lvl.P, coarse, n)}[name]()
    assert isinstance(make_op(A), DIA)
    return A


def masked_level0(name):
    """One of the full-space level-0 operators ``LEVEL0_OPERATORS`` of the
    128^2 main-path hierarchy, as make_op receives it: 16,384 rows, DIA
    with 1-3 offsets, half or more of the slots zero (the rows or columns
    of the other point set).  A fresh copy on every call."""
    return _masked_level0(name).copy()


def dia_odd_rows(n, seed=0):
    """A square 5-offset DIA of n rows with n not a multiple of 4, so the
    DIA kernel takes its scalar instantiation, and offsets that reach past
    both ends."""
    rng = np.random.default_rng(seed)
    offs = [-37, -1, 0, 2, 37]
    A = sp.diags([rng.standard_normal(n - abs(o)) for o in offs], offs,
                 format="csr")
    A.sort_indices()
    return A
