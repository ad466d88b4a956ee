"""pflare_tpu_torch: the PyTorch and CUDA port of ``pflare_tpu``.

Reduction multigrid with approximate ideal restriction (PCAIR, AIRG) and
one-level approximate inverses (PCPFLAREINV) for nonsymmetric sparse
systems, on one NVIDIA GPU, with the reference's problem generators,
Gmsh and PETSc readers and unstructured FV, DG(1) and SUPG assemblies.
The host setup is numpy, scipy and the shared native C++ kernels; the
solve is PyTorch on the device, with hand-written CUDA kernels for the
DIA and banded SpMVs (``csrc/``).  ``pflare_tpu`` (JAX) stays the reference every module is
tested against; this package imports neither it nor jax.
"""

from .params import InverseType, CFSplittingType, ZType, C_POINT, F_POINT
from .options import AIROptions, PFLAREINVOptions, parse_smooth_order
from .problems import (adv_1d, adv_diff_2d, adv_diff_3d,
                       advection_from_gmsh, anisotropic_diffusion_2d,
                       dg1_advection_from_gmsh, dg1_upwind_advection,
                       dg_upwind_advection_unstructured, fv_upwind_advection,
                       random_diag_dominant, read_gmsh, read_petsc_matrix,
                       supg_advection_diffusion, supg_from_gmsh)
from .sparse import (ELL, SparsityPattern, remove_from_sparse_match,
                     remove_small_from_sparse)
from .solvers import fgmres, gmres, richardson
from .inverse import Inverse, build_inverse
from .air import PCAIR
from .pcpflareinv import PCPFLAREINV
from .cf import compute_cf_splitting, compute_diag_dom_submatrix

__version__ = "0.1.0"

__all__ = ["InverseType", "CFSplittingType", "ZType", "C_POINT", "F_POINT",
           "AIROptions", "PFLAREINVOptions", "parse_smooth_order", "adv_1d",
           "adv_diff_2d", "adv_diff_3d", "anisotropic_diffusion_2d",
           "dg_upwind_advection_unstructured", "random_diag_dominant",
           "read_petsc_matrix", "read_gmsh", "fv_upwind_advection",
           "advection_from_gmsh", "dg1_upwind_advection",
           "dg1_advection_from_gmsh", "supg_advection_diffusion",
           "supg_from_gmsh", "ELL", "SparsityPattern",
           "remove_from_sparse_match", "remove_small_from_sparse", "fgmres",
           "gmres", "richardson", "build_inverse", "Inverse", "PCAIR",
           "PCPFLAREINV", "compute_cf_splitting",
           "compute_diag_dom_submatrix"]
