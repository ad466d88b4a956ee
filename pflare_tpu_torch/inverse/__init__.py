from .build import Inverse, build_inverse
from .gmres_poly import (arnoldi_host, box_muller, coefficients_arnoldi,
                         coefficients_power, horner)
from .newton import (build_newton_program, modified_leja, newton_apply,
                     newton_residual_apply, newton_roots)
from .sai import sai_inverse, sai_z

__all__ = ["Inverse", "build_inverse", "coefficients_power",
           "coefficients_arnoldi", "horner", "box_muller", "arnoldi_host",
           "newton_roots", "modified_leja", "build_newton_program",
           "newton_apply", "newton_residual_apply", "sai_z", "sai_inverse"]
