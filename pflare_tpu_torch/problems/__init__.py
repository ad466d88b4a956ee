from .generators import (adv_1d, adv_diff_2d, adv_diff_3d,
                         anisotropic_diffusion_2d,
                         dg_upwind_advection_unstructured,
                         random_diag_dominant)

__all__ = ["adv_1d", "adv_diff_2d", "adv_diff_3d", "anisotropic_diffusion_2d",
           "dg_upwind_advection_unstructured", "random_diag_dominant"]
