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
from .options import AIROptions, PFLAREINVOptions
from .problems import adv_diff_2d, random_diag_dominant
from .air import PCAIR
from .pcpflareinv import PCPFLAREINV

__version__ = "0.1.0"

__all__ = ["InverseType", "CFSplittingType", "ZType", "C_POINT", "F_POINT",
           "AIROptions", "PFLAREINVOptions", "adv_diff_2d",
           "random_diag_dominant", "PCAIR", "PCPFLAREINV"]
