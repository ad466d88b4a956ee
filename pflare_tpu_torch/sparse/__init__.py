from .pattern import SparsityPattern
from .ell import ELL, TELL
from .dia import DIA
from .banded import BandedSpMV
from .dell import DELL
from .ops import remove_from_sparse_match, remove_small_from_sparse

__all__ = ["SparsityPattern", "ELL", "TELL", "DIA", "BandedSpMV", "DELL",
           "remove_from_sparse_match", "remove_small_from_sparse"]
