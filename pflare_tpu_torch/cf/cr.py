"""Compatible relaxation (CR) CF splitting, on the host.

Reference: src/CR_Splitting.F90, ported from ``pflare_tpu.cf.cr``.
Starting from all F, each pass runs nu applications of the assembled
approximate-inverse relaxation on A_ff to a random error with a zero RHS
(habituated CR), measures the CR rate rho = (||e_nu|| / ||e_0||)^(1/nu),
and promotes an independent set of the slowest-converging F rows (hypre's
candidate measure) to C until the target rate is met.  The inverse is the
port's ``build_inverse``, applied on the CPU in f64: setup is host work.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..params import C_POINT, F_POINT, InverseType
from .pmisr import pmisr_existing_measure

CR_NU = 10
CR_NU_POLY = 1
CR_POLY_ORDER = 6
CR_MAX_ITS = 100
CR_CANDIDATE = 0.1


def cr_pass(A, cf_markers: np.ndarray, target_cr_rate: float,
            cr_inverse_type=InverseType.ARNOLDI,
            cr_poly_order: int = CR_POLY_ORDER,
            cr_sparsity_order: int = 1, cr_diag_scale: bool = False,
            seed: int = 5):
    """One CR pass.  Returns (cf_markers, rate_achieved, n_swapped)."""
    from ..inverse.build import build_inverse

    A = sp.csr_matrix(A)
    cf = np.asarray(cf_markers, dtype=np.int64).copy()
    fine_idx = np.nonzero(cf == F_POINT)[0]
    fine_size = len(fine_idx)
    if fine_size == 0:
        return cf, 0.0, 0

    Aff = (sp.csr_matrix(A[fine_idx][:, fine_idx])
           if fine_size < A.shape[0] else A)

    forced_c = np.zeros(fine_size, dtype=bool)
    use_poly = (cr_inverse_type not in (InverseType.JACOBI,
                                        InverseType.WJACOBI)
                and fine_size > cr_poly_order + 1)
    nu = CR_NU_POLY if use_poly else CR_NU

    if use_poly:
        inv = build_inverse(Aff, cr_inverse_type, poly_order=cr_poly_order,
                            sparsity_order=cr_sparsity_order,
                            matrix_free=False, diag_scale=cr_diag_scale,
                            seed=seed).to(torch.device("cpu"), torch.float64)

        def apply_inv(v):
            return inv.apply(torch.from_numpy(np.asarray(v, np.float64))
                             ).numpy()
    else:
        d = Aff.diagonal().copy()
        forced_c = d == 0.0
        d[forced_c] = 1.0
        weight = 1.0
        if cr_inverse_type != InverseType.JACOBI:
            Dm = sp.diags(1.0 / np.sqrt(np.abs(d)))
            norm_inf = np.abs(Dm @ Aff @ Dm).sum(axis=1).max()
            if norm_inf != 0.0:
                weight = 3.0 / (4.0 * norm_inf)
        dinv = weight / d
        dinv[forced_c] = 0.0

        def apply_inv(v):
            return dinv * v

    rng = np.random.default_rng(seed)
    rand_full = rng.random(A.shape[0])
    e = rand_full[fine_idx].copy()
    norm_e0 = np.linalg.norm(e)
    for _ in range(nu):
        e = e - apply_inv(Aff @ e)
    norm_enu = np.linalg.norm(e)
    rate = (norm_enu / norm_e0) ** (1.0 / nu) if norm_e0 != 0.0 else 0.0

    n_swapped = 0
    if rate > target_cr_rate:
        e_inf = np.abs(e).max()
        meas = np.where(forced_c, 2.0,
                        np.abs(e) / e_inf if e_inf != 0.0 else 0.0)
        cf_aff = np.zeros(fine_size, dtype=np.int64)
        small = meas < CR_CANDIDATE
        cr_meas = 10.0 - (meas - rand_full[fine_idx] / 1e10)
        cr_meas[small] = np.finfo(np.float64).max
        cf_aff[small] = C_POINT
        cf_aff = pmisr_existing_measure(Aff, cr_meas, cf_aff,
                                        max_luby_steps=-1)
        swap = cf_aff == F_POINT
        n_swapped = int(swap.sum())
        cf[fine_idx[swap]] *= -1
    return cf, rate, n_swapped
