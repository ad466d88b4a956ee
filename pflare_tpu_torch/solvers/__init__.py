from .krylov import SolveResult, as_operator, fgmres, gmres, richardson
from .jitted import (fgmres_fixed, gmres_right_fixed, gmres_stationary,
                     richardson_fixed)

__all__ = ["SolveResult", "as_operator", "fgmres", "gmres", "richardson",
           "fgmres_fixed", "gmres_right_fixed", "gmres_stationary",
           "richardson_fixed"]
