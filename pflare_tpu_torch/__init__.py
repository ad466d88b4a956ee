"""pflare_tpu_torch: the PyTorch and CUDA port of ``pflare_tpu``.

Reduction multigrid with approximate ideal restriction (PCAIR, AIRG) and
one-level approximate inverses (PCPFLAREINV) for nonsymmetric sparse
systems, on one NVIDIA GPU.  The host setup is numpy,
scipy and the shared native C++ kernels; the solve is PyTorch on the
device, with hand-written CUDA kernels for the DIA and banded SpMVs
(``csrc/``).  ``pflare_tpu`` (JAX) stays the reference every module is
tested against; this package imports neither it nor jax.
"""

from .params import InverseType, CFSplittingType, ZType, C_POINT, F_POINT
from .options import AIROptions, PFLAREINVOptions, parse_smooth_order
from .problems import (adv_1d, adv_diff_2d, adv_diff_3d,
                       anisotropic_diffusion_2d,
                       dg_upwind_advection_unstructured, random_diag_dominant)
from .sparse import remove_from_sparse_match, remove_small_from_sparse
from .solvers import fgmres, gmres, richardson
from .air import PCAIR
from .pcpflareinv import PCPFLAREINV
from .cf import compute_cf_splitting, compute_diag_dom_submatrix

__version__ = "0.1.0"

__all__ = ["InverseType", "CFSplittingType", "ZType", "C_POINT", "F_POINT",
           "AIROptions", "PFLAREINVOptions", "parse_smooth_order", "adv_1d",
           "adv_diff_2d", "adv_diff_3d", "anisotropic_diffusion_2d",
           "dg_upwind_advection_unstructured", "random_diag_dominant",
           "remove_from_sparse_match", "remove_small_from_sparse", "fgmres",
           "gmres", "richardson", "PCAIR", "PCPFLAREINV",
           "compute_cf_splitting", "compute_diag_dom_submatrix"]
