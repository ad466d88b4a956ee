from .krylov import SolveResult, fgmres, gmres, richardson
from .jitted import fgmres_fixed, gmres_right_fixed, richardson_fixed

__all__ = ["SolveResult", "fgmres", "gmres", "richardson", "fgmres_fixed",
           "gmres_right_fixed", "richardson_fixed"]
