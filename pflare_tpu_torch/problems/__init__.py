from .generators import (adv_1d, adv_diff_2d, adv_diff_3d,
                         anisotropic_diffusion_2d,
                         dg_upwind_advection_unstructured,
                         random_diag_dominant)
from .io import read_petsc_matrix, read_petsc_vec
from .gmsh import read_gmsh, fv_upwind_advection, advection_from_gmsh
from .fem_dg import dg1_upwind_advection, dg1_advection_from_gmsh
from .fem_supg import supg_advection_diffusion, supg_from_gmsh

__all__ = ["adv_1d", "adv_diff_2d", "adv_diff_3d", "anisotropic_diffusion_2d",
           "dg_upwind_advection_unstructured", "random_diag_dominant",
           "read_petsc_matrix", "read_petsc_vec", "read_gmsh",
           "fv_upwind_advection", "advection_from_gmsh",
           "dg1_upwind_advection", "dg1_advection_from_gmsh",
           "supg_advection_diffusion", "supg_from_gmsh"]
