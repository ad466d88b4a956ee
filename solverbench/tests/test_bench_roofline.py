"""The bytes of a product, counted by hand."""

import numpy as np
import pytest
import scipy.sparse as sp

from solverbench import roofline


def hand_matrix():
    # 3 nonzeros, one stored zero (row 1), columns 0 and 2 read, 4 rows
    data = np.array([1.0, 2.0, 0.0, 3.0])
    indices = np.array([0, 2, 1, 2])
    indptr = np.array([0, 2, 3, 4, 4])
    return sp.csr_matrix((data, indices, indptr), shape=(4, 3))


@pytest.mark.parametrize("value_bytes, diagonal, want", [
    (4, False, 3 * (4 + 4) + (2 + 4) * 4),   # 48
    (4, True, 3 * 4 + (2 + 4) * 4),          # 36
    (8, False, 3 * (8 + 4) + (2 + 4) * 8),   # 84
])
def test_product_bytes_by_hand(value_bytes, diagonal, want):
    assert roofline.product_bytes(hand_matrix(), value_bytes,
                                  diagonal) == want


def test_least_seconds_at_the_h100s_bandwidth():
    assert roofline.least_seconds(3.35e12) == pytest.approx(1.0)
    assert roofline.H100["hbm_bytes_s"] == 3.35e12
