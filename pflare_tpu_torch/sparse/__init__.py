from .pattern import SparsityPattern
from .ell import ELL, TELL, spmv
from .dia import DIA
from .banded import BandedSpMV
from .dell import DELL
from .ops import (diag_dominance_ratio, duplicate_plus_diag, identity_csr,
                  one_point_strongest, remove_from_sparse_match,
                  remove_small_from_sparse, symbolic_matmat)
from .spgemm import (FixedSparsityPolyPlan, SpGEMMPlan, build_spgemm_plan,
                     scipy_matmat)

__all__ = ["SparsityPattern", "ELL", "TELL", "DIA", "spmv",
           "remove_small_from_sparse", "remove_from_sparse_match",
           "duplicate_plus_diag", "one_point_strongest", "identity_csr",
           "diag_dominance_ratio", "symbolic_matmat", "SpGEMMPlan",
           "build_spgemm_plan", "FixedSparsityPolyPlan", "scipy_matmat",
           "DELL", "BandedSpMV"]
