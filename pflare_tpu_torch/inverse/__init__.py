from .build import Inverse, build_inverse
from .gmres_poly import coefficients_arnoldi, coefficients_power, horner
from .newton import (build_newton_program, newton_apply, newton_residual_apply,
                     newton_roots)

__all__ = ["Inverse", "build_inverse", "coefficients_arnoldi",
           "coefficients_power", "horner", "build_newton_program",
           "newton_apply", "newton_residual_apply", "newton_roots"]
