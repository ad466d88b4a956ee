from .krylov import SolveResult, gmres, richardson
from .jitted import richardson_fixed

__all__ = ["SolveResult", "gmres", "richardson", "richardson_fixed"]
