"""The first setup of a PCAIR hierarchy on the device: pattern discovery.

Ported from ``pflare_tpu.air.device_setup`` (the reference's Kokkos setup
for device-resident matrices: docs/gpus.md, src/PETSc_Helperk.kokkos.cxx,
src/PMISR_Modulek.kokkos.cxx, src/Gmres_Polyk.kokkos.cxx).  CF
splitting, submatrix extraction, the approximate inverses, Z, R and P,
AP and RAP run as torch ops on the device of the matrix, through the DELL
primitives (sparse/dell.py); the host seeds the random measures, reads a
few integers a level (the kept widths, n_f, the CF splitting's count) and
solves the tiny dense coefficient problems.  Everything O(nnz) stays on
the device, and the result is the solve form an upload gives
(``DeviceHierarchy``), so ``solve``, ``solve_device`` and the V-cycles
run on it unchanged.

The supported options are those of the reference's device envelope:
AIRG product, lAIR and SAI-lAIR Z (batched local least squares), strong-R
dropping, improve_z, one-point classical prolongation, PMISR(-DDC), PMIS,
PMIS_DIST2 and CR splittings, nonsymmetric transfers, and the
JACOBI/WJACOBI, NEUMANN, POWER, ARNOLDI and NEWTON inverses, assembled or
matrix-free.  Outside it ``PCAIR.setup_device`` prints the reason and runs
the host setup.  The setup computes in the dtype it is given.
"""

from __future__ import annotations

from contextlib import ExitStack
from dataclasses import dataclass, field

import numpy as np
import torch

from ..cf.device import luby_rounds
from ..inverse.build import Inverse
from ..inverse.gmres_poly import (arnoldi_fixed_device, box_muller,
                                  coefficients_arnoldi_from_h,
                                  coefficients_power, qr_r_device,
                                  reached_order, trim_high_order_zeros)
from ..inverse.newton import build_newton_program, newton_roots
from ..options import AIROptions
from ..params import (C_POINT, F_POINT, CFSplittingType, InverseType, ZType,
                      tolerances)
from ..sparse.dell import (DELL, OFFBIG, PADCOL, _pad_cols, apply_restrict_plan,
                           by_chunks, chunk_passes, compact, dell_spmv_plain,
                           distinct_offsets_device, drop_rows, extract_dell,
                           gather_at_pattern, max_row_count, newton_poly_dell,
                           onecol_product, pack_dells, poly_dell, sort_rows,
                           spgemm_drop_dell, transpose_pattern,
                           union_patterns)
from ..sparse.dia import DIA
from ..sparse.dtypes import numpy_dtype
from ..utils.timers import current_syncs, span, timer
from .fullspace import coarse_maps
from .hierarchy import DeviceHierarchy


def device_setup_supported(opts: AIROptions) -> bool:
    """True when the device first setup covers this option set."""
    return device_setup_unsupported_reason(opts) is None


def device_setup_unsupported_reason(opts: AIROptions) -> str | None:
    """Why the device first setup cannot cover this option set (None when
    it can): ``PCAIR.setup_device`` prints it before it takes the host
    setup."""
    checks = [
        (opts.symmetric, "symmetric (PtAP)"),
        (bool(opts.improve_w_its), "improve_w_its"),
        (opts.constrain_w, "constrain_w"),
        (opts.constrain_z, "constrain_z"),
        (opts.full_smoothing_up_and_down, "full_smoothing_up_and_down"),
        (not opts.one_point_classical_prolong, "ideal prolongator"),
        (opts.cf_splitting_type not in (CFSplittingType.PMISR_DDC,
                                        CFSplittingType.PMIS,
                                        CFSplittingType.PMIS_DIST2,
                                        CFSplittingType.CR),
         f"cf_splitting_type={opts.cf_splitting_type.name}"),
        (opts.inverse_sparsity_order != 1, "inverse_sparsity_order != 1"),
        (opts.c_inverse_sparsity_order_eff != 1,
         "c_inverse_sparsity_order != 1"),
        (opts.any_c_smooths, "C-point smoothing"),
        (opts.inverse_type in (InverseType.SAI, InverseType.ISAI,
                               InverseType.LU),
         f"inverse_type={opts.inverse_type.name}"),
        (opts.coarsest_inverse_type in (InverseType.SAI, InverseType.ISAI,
                                        InverseType.LU),
         f"coarsest_inverse_type={opts.coarsest_inverse_type.name}"),
    ]
    bad = [msg for cond, msg in checks if cond]
    return ", ".join(bad) if bad else None


_POLYNOMIALS = (InverseType.POWER, InverseType.ARNOLDI, InverseType.NEWTON,
                InverseType.NEWTON_NO_EXTRA)


def device_setup_fault_reason(opts: AIROptions) -> str | None:
    """Why the device first setup would build another preconditioner than
    the host setup for an option set inside the envelope (None when it
    would not): under ``diag_scale_polys`` an assembled polynomial
    inverse takes the coefficients of D^-1 A and is assembled in A
    (reference: pflare_tpu/air/device_setup.py:967,993; ROADMAP queue 3).
    AIRG's Z assembles the fine polynomial even when the smoother's is
    matrix-free.  ``PCAIR.setup_device`` prints it and takes the host
    setup."""
    if not opts.diag_scale_polys:
        return None
    fine = opts.inverse_type in _POLYNOMIALS and (
        not opts.matrix_free_polys or opts.z_type == ZType.PRODUCT)
    coarse = (opts.coarsest_inverse_type in _POLYNOMIALS
              and not opts.coarsest_matrix_free_polys)
    if fine or coarse:
        return ("diag_scale_polys with an assembled polynomial inverse "
                "(the device path assembles the polynomial of A with the "
                "coefficients of D^-1 A)")
    return None


def _arange(n: int, like, dtype=torch.int64):
    return torch.arange(n, dtype=dtype, device=like.device)


# ~~~~~~~~~~~~~~~~~~ CF splitting on the device ~~~~~~~~~~~~~~~~~~


def _strength_cols(A: DELL, theta: float):
    """Strength pattern |a_ij| >= theta * max_{j != i} |a_ij|, diagonal
    dropped (reference: src/SAbs.F90:16-144), as padded cols."""
    isd = A.cols == _arange(A.data.shape[0], A.cols, A.cols.dtype)[:, None]
    live = (A.cols < PADCOL) & ~isd
    av = torch.where(live, A.data.abs(), 0.0)
    rowmax = av.amax(dim=1, keepdim=True)
    keep = live & (av >= theta * rowmax) & (av > 0)
    return torch.where(keep, A.cols, PADCOL)


def _scatter_count(scols, vals2d, n: int):
    """Per node, the count of its in-edges (j -> i for scols[j, k] = i)
    that carry a true ``vals2d[j, k]``; dead slots land in a sentinel."""
    target = torch.where(scols < PADCOL, scols.long(), n).reshape(-1)
    acc = torch.zeros(n + 1, dtype=torch.int32, device=scols.device)
    acc.index_add_(0, target, vals2d.reshape(-1).to(torch.int32))
    return acc[:n]


def _symmetric_degree(scols):
    """Degree of each node in the symmetrised graph S + S^T from the
    directed strength cols, without building the transpose:
    |out| + |in| - |reciprocal|."""
    n = scols.shape[0]
    gidx = _arange(n, scols)
    maskl = scols < PADCOL
    safe = torch.clamp(scols, max=n - 1).long()
    out_deg = maskl.sum(dim=1, dtype=torch.int32)
    in_deg = _scatter_count(scols, maskl, n)
    recip = (maskl & (scols[safe] == gidx[:, None, None].to(scols.dtype))
             .any(dim=2)).sum(dim=1, dtype=torch.int32)
    return out_deg + in_deg - recip


def _luby_directed(scols, measure, cf0, n_rounds: int, pmis: bool = False):
    """PMISR/PMIS Luby rounds over S + S^T on the directed strength cols:
    out-edges are gathered, in-edges arrive by a scatter count, so no
    transpose is built.  A node is blocked when an undecided neighbour in
    either direction has a smaller measure (ties: the smaller index); new
    set members and their neighbours leave the pool; leftovers become C
    (reference: src/PMISR_Module.F90:200-473).  ``n_rounds`` rounds run
    with no host read: a round that adds no node changes nothing, so the
    reference's early stop gives the same markers."""
    n = measure.shape[0]
    gidx = _arange(n, measure)
    maskl = scols < PADCOL
    safe = torch.clamp(scols, max=n - 1).long()
    cf = cf0.to(torch.int32)
    removed0 = cf != 0
    zero_nodes = ~removed0 & (measure.abs() < 1)
    cf = torch.where(zero_nodes, C_POINT if pmis else F_POINT, cf)
    removed0 = removed0 | zero_nodes
    m_nb = measure[safe]                                 # [n, K]
    out_wins = maskl & ((measure[:, None] > m_nb)
                        | ((measure[:, None] == m_nb) & (gidx[:, None] > safe)))
    in_wins = maskl & ((m_nb > measure[:, None])
                       | ((m_nb == measure[:, None]) & (safe > gidx[:, None])))
    in_set = torch.zeros(n, dtype=torch.bool, device=measure.device)
    for _ in range(n_rounds):
        covered = (in_set | (maskl & in_set[safe]).any(dim=1)
                   | (_scatter_count(scols, in_set[:, None] & maskl, n) > 0)
                   | removed0)
        blocker = ~covered
        lose = (out_wins & blocker[safe]).any(dim=1)
        lose = lose | (_scatter_count(scols, in_wins & blocker[:, None], n)
                       > 0)
        in_set = in_set | (blocker & ~lose)
    cf = torch.where(in_set, F_POINT, cf)
    return torch.where(cf == 0, C_POINT, cf)


def _ddc_pass(A: DELL, cf, fraction_swap: float):
    """DDC second pass on the device (reference: src/DDC_Module.F90,
    src/DDC_Modulek.kokkos.cxx: the ratio without extracting A_ff),
    binned worst-fraction selection with 1000 bins, as the host."""
    n = A.data.shape[0]
    N_BINS = 1000
    is_f = cf == F_POINT
    isd = A.cols == _arange(n, A.cols, A.cols.dtype)[:, None]
    live = A.cols < PADCOL
    safe = torch.clamp(A.cols, max=n - 1).long()
    col_f = is_f[safe] & live & ~isd
    offsum = torch.where(col_f, A.data.abs(), 0.0).sum(dim=1)
    diag = torch.where(isd & live, A.data, 0.0).sum(dim=1)
    adiag = diag.abs()
    ratio = torch.where(adiag > 0, offsum / torch.where(adiag > 0, adiag,
                                                        1.0), torch.inf)
    ratio = torch.where(is_f, ratio, 0.0)
    search_size = (is_f.sum().double() * fraction_swap).to(torch.int64)
    capped = torch.where(torch.isfinite(ratio), ratio, float(N_BINS))
    bins = torch.clamp(torch.floor(capped * N_BINS).to(torch.int64), 0,
                       N_BINS - 1)
    counts = torch.zeros(N_BINS, dtype=torch.int64, device=cf.device)
    counts.index_add_(0, torch.where(is_f, bins, 0), is_f.to(torch.int64))
    csum = torch.cumsum(counts.flip(0), dim=0)
    boundary = N_BINS - (torch.searchsorted(csum, search_size.reshape(1))
                         + 1)
    swap_dom_val = boundary.to(ratio.dtype) / N_BINS
    swap = is_f & (ratio != 0) & (ratio >= swap_dom_val) & (search_size > 0)
    return torch.where(swap, -cf, cf)


def _sym_graph(A: DELL, theta: float, square: bool = False):
    """The symmetrised (for distance 2 also squared) strength graph as
    padded cols (reference: src/SAbs.F90 symmetrize/square)."""
    n = A.data.shape[0]
    scols = _strength_cols(A, theta)
    tcols = transpose_pattern(DELL(torch.zeros_like(A.data), scols, n))
    w = max(scols.shape[1], tcols.shape[1])
    gfull = union_patterns(_pad_cols(scols, w), _pad_cols(tcols, w))
    gcols = _compact_cols(gfull, max(max_row_count(gfull), 1))
    if square:
        # S S + S with the symmetric S, diagonal dropped
        S1 = DELL((gcols < PADCOL).to(A.dtype), gcols, n)
        S2 = spgemm_drop_dell(S1, S1, 0.0, relative=True, lump=False)
        isd = S2.cols == _arange(n, S2.cols, S2.cols.dtype)[:, None]
        c2 = torch.where(isd, PADCOL, S2.cols)
        w = max(c2.shape[1], gcols.shape[1])
        gfull = union_patterns(_pad_cols(gcols, w), _pad_cols(c2, w))
        gcols = _compact_cols(gfull, max(max_row_count(gfull), 1))
    return gcols


def _cr_split_device(A: DELL, opts: AIROptions):
    """Compatible-relaxation splitting on the device (reference:
    src/CR_Splitting.F90): habituated relaxation sweeps with the device
    inverse of A_ff; n_f, the rate and the swap count are read back each
    pass."""
    from ..cf.cr import CR_CANDIDATE, CR_MAX_ITS, CR_NU, CR_NU_POLY

    n = A.data.shape[0]
    target = opts.strong_threshold       # carries the CR rate target
    cf = torch.full((n,), F_POINT, dtype=torch.int32, device=A.device)
    rng = np.random.default_rng(opts.seed)
    rand_full = torch.as_tensor(rng.random(n), dtype=A.dtype, device=A.device)
    for _ in range(CR_MAX_ITS):
        is_f = cf == F_POINT
        fine_idx = torch.nonzero(is_f)[:, 0]
        n_f = fine_idx.shape[0]
        if n_f == 0:
            break
        f_newidx = torch.cumsum(is_f, dim=0) - 1
        Aff = extract_dell(A, fine_idx, is_f, f_newidx, n_f,
                           ensure_diag=True)
        use_poly = (opts.inverse_type not in (InverseType.JACOBI,
                                              InverseType.WJACOBI)
                    and n_f > opts.poly_order + 1)
        nu = CR_NU_POLY if use_poly else CR_NU
        forced_c = torch.zeros(n_f, dtype=torch.bool, device=A.device)
        if use_poly:
            # an assembled polynomial of the compressed A_ff
            inv_mat = _inverse_device(Aff, opts, opts.inverse_type,
                                      opts.poly_order, False, opts.seed,
                                      A.dtype).mat
            apply_inv = lambda v: dell_spmv_plain(inv_mat, v)
        else:
            d = Aff.diagonal()
            forced_c = d == 0.0
            dsafe = torch.where(forced_c, 1.0, d)
            weight = 1.0
            if opts.inverse_type != InverseType.JACOBI:
                dsq = torch.where(dsafe.abs() > 0,
                                  1.0 / dsafe.abs().sqrt(), 0.0)
                safe = torch.clamp(Aff.cols, max=n_f - 1).long()
                scaled = (Aff.data * dsq[:, None] * dsq[safe]).abs()
                norm_inf = scaled.sum(dim=1).max()
                weight = torch.where(norm_inf != 0,
                                     3.0 / (4.0 * norm_inf), 1.0)
            dinv = torch.where(forced_c, 0.0, weight / dsafe)
            apply_inv = lambda v: dinv * v
        e = rand_full[fine_idx]
        norm_e0 = torch.linalg.vector_norm(e)
        for _ in range(nu):
            e = e - apply_inv(dell_spmv_plain(Aff, e))
        rate = float((torch.linalg.vector_norm(e)
                      / torch.where(norm_e0 != 0, norm_e0, 1.0))
                     ** (1.0 / nu))
        if rate <= target:
            break
        e_inf = e.abs().max()
        meas = torch.where(forced_c, 2.0,
                           e.abs() / torch.where(e_inf != 0, e_inf, 1.0))
        small = meas < CR_CANDIDATE
        cr_meas = 10.0 - (meas - rand_full[fine_idx] / 1e10)
        cr_meas = torch.where(small, torch.finfo(A.dtype).max, cr_meas)
        cf_aff0 = torch.where(small, C_POINT, 0).to(torch.int32)
        # Luby over Aff + Aff^T
        tcols = transpose_pattern(Aff)
        w = max(Aff.cols.shape[1], tcols.shape[1])
        gfull = union_patterns(_pad_cols(Aff.cols, w), _pad_cols(tcols, w))
        gcols = _compact_cols(gfull, max(max_row_count(gfull), 1))
        swap = luby_rounds(gcols, cr_meas, cf_aff0, 25) == F_POINT
        # F rows that stay slowest become C on the full grid
        flip = torch.zeros(n, dtype=torch.bool, device=A.device)
        flip[fine_idx] = swap
        cf = torch.where(flip, -cf, cf)
        if not bool(swap.any()):
            break
    return cf


def _compact_cols(cols, w: int):
    """Left-pack a cols-only pattern and cut its width to ``w``."""
    return torch.sort(cols, dim=1).values[:, :w]


def _split_fused(A: DELL, scols, rand, ddc_frac: float, rounds: int,
                 pmis: bool, ddc_its: int):
    """Measure + Luby + DDC on the directed strength cols."""
    n = A.data.shape[0]
    measure = rand + _symmetric_degree(scols).to(A.dtype)
    if pmis:
        measure = -measure
    cf = _luby_directed(scols, measure,
                        torch.zeros(n, dtype=torch.int32, device=A.device),
                        rounds, pmis=pmis)
    if pmis:
        cf = -cf
    for _ in range(ddc_its):
        cf = _ddc_pass(A, cf, ddc_frac)
    return cf


def _cf_split_device(A: DELL, opts: AIROptions):
    """Device CF splitting: strength -> PMISR/PMIS Luby -> DDC, or the
    compatible-relaxation loop.  Only the random measure goes up; the
    markers stay on the device.  Returns (cf, the F count as a device
    scalar)."""
    n = A.data.shape[0]
    t = CFSplittingType(opts.cf_splitting_type)
    if t == CFSplittingType.CR:
        cf = _cr_split_device(A, opts)
        return cf, (cf == F_POINT).sum()
    pmis = t in (CFSplittingType.PMIS, CFSplittingType.PMIS_DIST2)
    rng = np.random.default_rng(opts.seed)
    rand = torch.as_tensor(rng.random(n), dtype=A.dtype, device=A.device)
    # 25 rounds stand for "until done": Luby decides every node in
    # O(log n) rounds with high probability; leftovers become C, as in
    # the fixed-step reference mode
    rounds = opts.max_luby_steps if opts.max_luby_steps > 0 else 25
    if t == CFSplittingType.PMIS_DIST2:
        gcols = _sym_graph(A, float(opts.strong_threshold), square=True)
        measure = rand + (gcols < PADCOL).sum(dim=1).to(A.dtype)
        cf = -luby_rounds(gcols, -measure,
                          torch.zeros(n, dtype=torch.int32,
                                      device=A.device), rounds, pmis=True)
        return cf, (cf == F_POINT).sum()
    # PMISR/PMIS ride the directed strength cols, compacted first (one
    # integer read) so that the Luby rounds run at the graph's width
    scols = _strength_cols(A, float(opts.strong_threshold))
    scols = _compact_cols(scols, max(max_row_count(scols), 1))
    ddc_its = (opts.ddc_its
               if (opts.strong_threshold != 0.0
                   and t in (CFSplittingType.PMISR_DDC,
                             CFSplittingType.DIAG_DOM)) else 0)
    cf = _split_fused(A, scols, rand, float(opts.ddc_fraction), rounds, pmis,
                      ddc_its)
    return cf, (cf == F_POINT).sum()


# ~~~~~~~~~~~~~~~~~~ the result ~~~~~~~~~~~~~~~~~~


@dataclass
class DeviceLevel:
    """Host record of one device-built level: its sizes, its F and C
    index tensors (on the device), the solve's level dict and the nnz
    census ([A, R, P, inverse] as a device tensor, read on demand).
    ``syncs``: the synchronisations the level made, when the setup ran
    under ``utils/timers.py::count_syncs``."""

    n: int
    n_f: int
    n_c: int
    fine: torch.Tensor
    coarse: torch.Tensor
    device: dict = field(default_factory=dict)
    nnz_dev: torch.Tensor | None = None
    syncs: int | None = None

    def _nnz(self, i):
        return int(self.nnz_dev[i]) if self.nnz_dev is not None else 0

    @property
    def nnz_A(self):
        return self._nnz(0)

    @property
    def nnz_R(self):
        return self._nnz(1)

    @property
    def nnz_P(self):
        return self._nnz(2)

    @property
    def nnz_inv(self):
        return self._nnz(3)


@dataclass
class DeviceSetupHierarchy:
    """What ``setup_hierarchy_device`` builds: the per-level records, the
    coarse matrix and the solve form ``solve_form`` (a ``DeviceHierarchy``:
    the level dicts, coarse inverse and top operator), which
    ``PCAIR.upload`` returns with no host copy.  It holds no host
    matrices, so the host's same-pattern reuse and ``stats`` do not apply
    to it."""

    levels: list
    coarse_A: DELL
    coarse_inv: Inverse
    options: AIROptions
    top_A: DELL
    solve_form: DeviceHierarchy
    auto_truncated: bool = False
    coarse_syncs: int | None = None

    @property
    def n_levels(self):
        return len(self.levels) + 1

    def to(self, device, dtype) -> DeviceHierarchy:
        """The solve form, which lives where it was built."""
        d, want = self.top_A.device, torch.device(device)
        if (want.type != d.type or want.index not in (None, d.index)
                or dtype != self.top_A.dtype):
            raise ValueError(
                f"a device-built hierarchy lives on {d} in "
                f"{self.top_A.dtype}; set it up with setup_device there "
                f"instead of moving it to {device} in {dtype}")
        return self.solve_form


# ~~~~~~~~~~~~~~~~~~ level building blocks ~~~~~~~~~~~~~~~~~~


def _ensure_diag(A: DELL) -> DELL:
    """Append a structural diagonal slot where a row lacks one (the
    polynomial's c0 term must land); one boolean read back."""
    n = A.data.shape[0]
    ridx = _arange(n, A.cols, A.cols.dtype)
    has = (A.cols == ridx[:, None]).any(dim=1)
    if bool(has.all()):
        return A
    cols = torch.cat([A.cols, torch.where(has, PADCOL, ridx)[:, None]],
                     dim=1)
    data = torch.cat([A.data, A.data.new_zeros((n, 1))], dim=1)
    c, v = sort_rows(cols, data)
    return DELL(v, c, A.n_cols)


def _split_indices(cf, n_f: int, n_c: int):
    """Every CF index structure at once: (is_f, is_c, fine_idx,
    coarse_idx, f_newidx, c_newidx); the index lists come from scatters
    into known sizes, so nothing is read back."""
    n = cf.shape[0]
    is_f = cf == F_POINT
    is_c = ~is_f
    ar = _arange(n, cf)
    cum_f = torch.cumsum(is_f, dim=0)
    f_newidx = cum_f - 1
    c_newidx = ar - cum_f            # == cumsum(is_c) - 1
    fine_idx = torch.zeros(n_f + 1, dtype=torch.int64, device=cf.device)
    fine_idx.scatter_(0, torch.where(is_f, f_newidx, n_f), ar)
    coarse_idx = torch.zeros(n_c + 1, dtype=torch.int64, device=cf.device)
    coarse_idx.scatter_(0, torch.where(is_c, c_newidx, n_c), ar)
    return is_f, is_c, fine_idx[:n_f], coarse_idx[:n_c], f_newidx, c_newidx


def _neumann_dell(A_ff: DELL, order: int) -> DELL:
    """Assembled Neumann-series inverse M = (sum_k (I - D^-1 A)^k)|_S(A)
    D^-1 (device sibling of the host build; reference:
    src/Neumann_Poly.F90:177-212).  A_ff carries a structural diagonal."""
    n = A_ff.shape[0]
    d = A_ff.diagonal()
    isd = A_ff.cols == _arange(n, A_ff.cols, A_ff.cols.dtype)[:, None]
    live = A_ff.cols < PADCOL
    ndata = torch.where(live, -A_ff.data / d[:, None], 0.0)
    ndata = torch.where(isd, 1.0 + ndata, ndata)
    M = poly_dell(DELL(ndata, A_ff.cols, n),
                  A_ff.data.new_ones(order + 1))
    safe = torch.clamp(M.cols, max=n - 1).long()
    return DELL(torch.where(M.cols < PADCOL, M.data / d[safe], 0.0), M.cols,
                M.n_cols)


def _inverse_device(A_ff: DELL, opts: AIROptions, inverse_type,
                    poly_order: int, matrix_free: bool, seed: int,
                    dtype) -> Inverse:
    """Approximate inverse of a device matrix: coefficients from device
    matvecs and tiny host solves, assembly on the device (reference:
    src/Approx_Inverse_Setup.F90 dispatch; src/Gmres_Polyk.kokkos.cxx,
    src/Gmres_Poly_Newtonk.kokkos.cxx).  As the reference's device path
    (pflare_tpu/air/device_setup.py:943-995), an assembled inverse under
    ``diag_scale_polys`` takes the coefficients of D^-1 A and assembles
    the polynomial in A, which is why ``setup_hierarchy_device`` refuses
    such option sets (``device_setup_fault_reason``)."""
    inverse_type = InverseType(inverse_type)
    n = A_ff.shape[0]
    np_dt = numpy_dtype(A_ff.dtype, np.float64)
    tol = tolerances(np.float64)
    dev = A_ff.device
    tensor = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt,
                                                 device=dev)
    if poly_order + 1 > n:
        poly_order = max(n - 1, 0)

    diag = A_ff.diagonal()
    if inverse_type in (InverseType.JACOBI, InverseType.WJACOBI):
        weight = 1.0
        if inverse_type == InverseType.WJACOBI:
            dsqrt = diag.abs().sqrt()
            inv_ds = torch.where(dsqrt > 0, 1.0 / dsqrt, 0.0)
            safe = torch.clamp(A_ff.cols, max=n - 1).long()
            scaled = (A_ff.data * inv_ds[:, None] * inv_ds[safe]).abs()
            weight = 3.0 / (4.0 * scaled.sum(dim=1).max())
        d = torch.where(diag != 0, weight / diag, 0.0)
        return Inverse("diagonal", diag=d.to(dtype))

    if inverse_type == InverseType.NEUMANN:
        ones = torch.ones(poly_order + 1, dtype=dtype, device=dev)
        if matrix_free:
            return Inverse("neumann_mf", mat=A_ff, coefficients=ones,
                           diag=diag)
        return Inverse("assembled", mat=_neumann_dell(A_ff, poly_order),
                       coefficients=ones)

    # the coefficients' products run plain: the compressed A_ff stays out
    # of the solve form, so it is never packed
    mv = lambda v: dell_spmv_plain(A_ff, v)
    if opts.diag_scale_polys:
        mv = lambda v: dell_spmv_plain(A_ff, v) / diag
    sdiag = diag if opts.diag_scale_polys else None

    if inverse_type in (InverseType.NEWTON, InverseType.NEWTON_NO_EXTRA):
        r0 = tensor(box_muller(n, np.float64, seed), A_ff.dtype)
        beta, H = arnoldi_fixed_device(mv, r0, poly_order + 1)
        m = reached_order(H, poly_order + 1, tol.lucky)
        wr, wi = newton_roots(
            None, n, poly_order, np_dt,
            add_roots=(inverse_type == InverseType.NEWTON), seed=seed,
            precomputed=(beta, H, m))
        steps = build_newton_program(wr, wi, tol.zero)
        roots = tensor(np.stack([wr, wi]))
        if matrix_free:
            return Inverse("newton_mf", mat=A_ff, steps=steps, diag=sdiag,
                           scaled=opts.diag_scale_polys, coefficients=roots)
        return Inverse("assembled", mat=newton_poly_dell(A_ff, wr, wi,
                                                         tol.zero),
                       coefficients=roots)

    if inverse_type == InverseType.POWER:
        # the power basis is factored on the device; only R comes back
        coeffs = coefficients_power(
            mv, n, poly_order, np_dt, seed=seed,
            start=tensor(box_muller(n, np.float64, seed), A_ff.dtype),
            qr_reduce=qr_r_device)
    elif inverse_type == InverseType.ARNOLDI:
        r0 = tensor(box_muller(n, np.float64, seed), A_ff.dtype)
        beta, H = arnoldi_fixed_device(mv, r0, poly_order + 1)
        coeffs = coefficients_arnoldi_from_h(beta, H, poly_order, np_dt)
    else:
        raise ValueError(f"device setup: unsupported inverse {inverse_type}")

    if matrix_free:
        return Inverse("poly_mf", mat=A_ff,
                       coefficients=tensor(trim_high_order_zeros(coeffs)),
                       diag=sdiag, scaled=opts.diag_scale_polys)
    return Inverse("assembled", mat=poly_dell(A_ff, tensor(coeffs,
                                                           A_ff.dtype)),
                   coefficients=tensor(coeffs))


# ~~~~~~~~~~~~~~~~~~ lAIR / SAI-lAIR on the device ~~~~~~~~~~~~~~~~~~

# elements of one chunk's local-block tensors in _lair_solve_all
_LAIR_CHUNK_ELEMENTS = 1 << 24


def _pattern_ones(M: DELL) -> DELL:
    """Pattern-only copy (live entries 1.0) for symbolic products."""
    return DELL((M.cols < PADCOL).to(M.dtype), M.cols, M.n_cols)


def _compact_pattern(cols, dtype):
    """Left-pack a cols-only pattern to its tight width (one integer
    read back)."""
    c, _ = compact(cols, torch.zeros(cols.shape, dtype=dtype,
                                     device=cols.device),
                   max(max_row_count(cols), 1))
    return c


def _lair_solve_all(affd1, affc1, S, I, acfd, acfc):
    """Batched local least-squares rows of Z (device sibling of the
    per-row Kokkos team solves, reference: src/SAI_Zk.kokkos.cxx:13 and
    src/SAI_Z.F90:24): for each coarse row b with allowed pattern J (an S
    row, over F columns) and shadow I (an I row), the transposed local
    block M[a, c] = A_ff[J_c, I_a] is built by compare-reduce, padded
    unknowns get unit rows of their own so they decouple to 0, and
    min || M z + A_cf[b, I] || is solved by one batched QR and a
    triangular solve a chunk.  affd1/affc1 carry a trailing sentinel row
    that dead J slots gather.  A block whose smallest |R_ii| is below
    1e-12 of its largest, or whose z is not finite, gives a zero row."""
    n_ff = affd1.shape[0] - 1
    n_c, kc = S.shape
    ic = I.shape[1]
    kff = affd1.shape[1]
    per_row = max(ic * kc * kff, (ic + kc) * kc, 1)
    ch = max(min(n_c, _LAIR_CHUNK_ELEMENTS // per_row), 1)
    eye = torch.eye(kc, dtype=affd1.dtype, device=affd1.device)
    out = []
    starts = range(0, n_c, ch)
    with chunk_passes("lair", len(starts)):
        for s in starts:
            J, Ib = S[s:s + ch], I[s:s + ch]
            Jm = J < PADCOL
            Jsafe = torch.where(Jm, torch.clamp(J, max=n_ff - 1),
                                n_ff).long()
            bc = affc1[Jsafe]                       # [CH, kc, Kff]
            bd = affd1[Jsafe]
            eq = (bc[:, None, :, :] == Ib[:, :, None, None]).to(bd.dtype)
            M = torch.einsum("back,bck->bac", eq, bd)    # [CH, ic, kc]
            live_I = (Ib < PADCOL).to(bd.dtype)
            M = M * live_I[:, :, None]
            req = (acfc[s:s + ch][:, None, :]
                   == Ib[:, :, None]).to(bd.dtype)
            rhs = -torch.einsum("bak,bk->ba", req, acfd[s:s + ch]) * live_I
            aug = eye[None, :, :] * (~Jm)[:, None, :].to(M.dtype)
            M_ext = torch.cat([M, aug], dim=1)
            rhs_ext = torch.cat([rhs, rhs.new_zeros((rhs.shape[0], kc))],
                                dim=1)
            Q, R = torch.linalg.qr(M_ext)
            qtb = torch.einsum("bij,bi->bj", Q, rhs_ext)
            z = torch.linalg.solve_triangular(R, qtb[..., None],
                                              upper=True)[..., 0]
            rdiag = torch.diagonal(R, dim1=1, dim2=2).abs()
            good = (rdiag.amin(dim=1)
                    > 1e-12 * torch.clamp(rdiag.amax(dim=1), min=1e-300))
            good = good & torch.isfinite(z).all(dim=1)
            out.append(torch.where(good[:, None] & Jm, z, 0.0))
    return torch.cat(out, dim=0)


def _lair_z_device(A_ff: DELL, A_cf: DELL, A_ff_drop: DELL,
                   A_cf_drop: DELL, distance: int,
                   incomplete: bool) -> DELL:
    """lAIR / SAI-lAIR Z on the device: the distance-d sparsity
    A_cf_drop A_ff_drop^(d-1) from the dropped matrices, local solves
    against the un-dropped ones (reference:
    src/AIR_Operators_Setup.F90:700-782).  Returns Z before its r_drop."""
    n_f = A_ff.shape[0]
    if distance == 1:
        Scols = _compact_pattern(A_cf_drop.cols, A_cf.dtype)
    else:
        P = _pattern_ones(A_ff_drop)
        for _ in range(3, distance + 1):
            P = _pattern_ones(spgemm_drop_dell(_pattern_ones(A_ff_drop), P,
                                               0.0, True, False))
        Scols = spgemm_drop_dell(_pattern_ones(A_cf_drop), P, 0.0, True,
                                 False).cols
    if incomplete:
        Icols = Scols
    else:
        # shadow(J): the pattern of S A_ff, every F column the allowed
        # rows reach
        Icols = spgemm_drop_dell(
            _pattern_ones(DELL(torch.zeros(Scols.shape, dtype=A_ff.dtype,
                                           device=A_ff.device), Scols, n_f)),
            _pattern_ones(A_ff), 0.0, True, False).cols
    affd1 = torch.cat([A_ff.data, A_ff.data.new_zeros((1, A_ff.K))], dim=0)
    affc1 = torch.cat([A_ff.cols, torch.full((1, A_ff.K), PADCOL,
                                             dtype=A_ff.cols.dtype,
                                             device=A_ff.device)], dim=0)
    zdata = _lair_solve_all(affd1, affc1, Scols, Icols, A_cf.data,
                            A_cf.cols)
    return DELL(zdata, Scols, n_f)


def _improve_z_device(Z: DELL, A_ff: DELL, A_cf: DELL, inv_diag,
                      its: int) -> DELL:
    """Fixed-sparsity Richardson improvement of Z on the device
    (reference: src/Grid_Transfer_Improve.F90:200-376):
    Z <- Z - (Z A_ff + A_cf)|_S(Z) D with D the diagonal of the
    approximate inverse of A_ff.  Every step restricts onto Z's pattern,
    so the steps share one restriction plan (``by_chunks``: each row's
    steps read that row alone)."""
    n_f = A_ff.shape[0]
    safe = torch.clamp(Z.cols, max=n_f - 1).long()
    dcol = torch.where(Z.cols < PADCOL, inv_diag[safe], 0.0)
    acf_at = gather_at_pattern(Z.cols, A_cf)

    def steps(rows, T):
        zv, acf, d = Z.data[rows], acf_at[rows], dcol[rows]
        for _ in range(its):
            zv = zv - (apply_restrict_plan(T, zv) + acf) * d
        return zv

    return DELL(by_chunks(Z.cols, A_ff, steps), Z.cols, Z.n_cols)


def _one_point_w(A_fc: DELL):
    """One-point classical W: the strongest |A_fc| entry of each F row
    becomes 1.0 (reference: src/Grid_Transfer.F90:26-220).  Returns the
    coarse column of each F row (PADCOL where the row is empty)."""
    live = A_fc.cols < PADCOL
    av = torch.where(live, A_fc.data.abs(), -1.0)
    best = torch.argmax(av, dim=1)
    has = av.amax(dim=1) > 0
    wcol = torch.gather(A_fc.cols, 1, best[:, None])[:, 0]
    return torch.where(has, wcol, PADCOL)


def _global_cols(cols, index):
    """Compressed columns mapped through ``index`` (dead stay PADCOL)."""
    safe = torch.clamp(cols, max=index.shape[0] - 1).long()
    return torch.where(cols < PADCOL, index[safe].to(torch.int32), PADCOL)


def _r_compressed(Z: DELL, fine_idx, coarse_idx, n: int) -> DELL:
    """R's rows in coarse numbering [n_c, Kz+1] with global columns: Z's
    row mapped to the global F positions plus the identity entry at the
    row's global C position.  The RAP product runs on these rows; R_ext's
    F rows are empty."""
    cols = torch.cat([_global_cols(Z.cols, fine_idx),
                      coarse_idx[:, None].to(torch.int32)], dim=1)
    vals = torch.cat([Z.data, Z.data.new_ones((Z.data.shape[0], 1))], dim=1)
    c, v = sort_rows(cols, vals)
    return DELL(v, c, n)


def _assemble_r_ext(Z: DELL, fine_idx, cf, n: int):
    """R_ext [n, n]: on global C row i, Z's row (columns mapped to global
    F positions) plus the identity entry at column i (reference:
    compute_R_from_Z, src/Grid_Transfer.F90:465, in the level's full
    space as air/fullspace.py)."""
    is_c = cf == C_POINT
    src = torch.where(is_c, torch.cumsum(is_c, dim=0) - 1, 0)
    zcols = torch.where(is_c[:, None], Z.cols[src], PADCOL)
    gvals = torch.where(zcols < PADCOL, Z.data[src], 0.0)
    ident = torch.where(is_c, _arange(n, cf, torch.int32), PADCOL)
    cols = torch.cat([_global_cols(zcols, fine_idx), ident[:, None]], dim=1)
    vals = torch.cat([gvals, is_c.to(gvals.dtype)[:, None]], dim=1)
    return sort_rows(cols, vals)


def _assemble_p_ext(wcol, coarse_idx, cf, n: int, dtype):
    """P_ext [n, n], one entry a row: the identity on C rows, the
    one-point W target (a global column) on F rows.  Returns the [n, 1]
    operator arrays and the 1-D (pcol, pval) relabelling that
    ``onecol_product`` takes."""
    is_c = cf == C_POINT
    is_f = cf == F_POINT
    wsrc = torch.where(is_f, torch.cumsum(is_f, dim=0) - 1, 0)
    wc = torch.where(is_f, wcol[wsrc], PADCOL)
    gw = _global_cols(wc, coarse_idx)
    cols = torch.where(is_c, _arange(n, cf, torch.int32), gw)
    vals = (is_c | (gw < PADCOL)).to(dtype)
    return cols[:, None], vals[:, None], cols, vals


def _mask_ext_ops(A: DELL, cf):
    """Full-space masked operators from the level matrix: A_ff_ext and
    A_fc_ext share A's layout with values zeroed outside their blocks
    (air/fullspace.py)."""
    n = A.data.shape[0]
    is_f = cf == F_POINT
    fmask = is_f.to(A.dtype)
    live = A.cols < PADCOL
    colf = is_f[torch.clamp(A.cols, max=n - 1).long()] & live
    aff = A.data * fmask[:, None] * colf.to(A.dtype)
    afc = A.data * fmask[:, None] * (~colf & live).to(A.dtype)
    return aff, afc, fmask


def _extend_inverse(inv: Inverse, A_ff_ext_op: DELL, fine_idx, cf, n: int,
                    dtype) -> Inverse:
    """Full-space form of a compressed-F inverse (device analogue of
    air/fullspace.py::inverse_to_fullspace)."""
    is_f = cf == F_POINT
    src = torch.where(is_f, torch.cumsum(is_f, dim=0) - 1, 0)
    if inv.kind == "diagonal":
        return Inverse("diagonal",
                       diag=torch.where(is_f, inv.diag[src], 0.0).to(dtype))
    if inv.kind == "assembled":
        icols = torch.where(is_f[:, None], inv.mat.cols[src], PADCOL)
        gvals = torch.where(icols < PADCOL, inv.mat.data[src], 0.0)
        return Inverse("assembled",
                       mat=DELL(gvals.to(dtype),
                                _global_cols(icols, fine_idx), n),
                       coefficients=inv.coefficients)
    # matrix-free: the extended operator, the diagonal extended with ones
    diag_ext = None
    if inv.diag is not None:
        diag_ext = torch.where(is_f, inv.diag[src], 1.0).to(dtype)
    coeffs = inv.coefficients
    if coeffs is not None:
        coeffs = coeffs.to(dtype)
    return Inverse(inv.kind, mat=A_ff_ext_op, coefficients=coeffs,
                   steps=inv.steps, diag=diag_ext, scaled=inv.scaled)


def _level_nnz(a_cols, r_cols, p_cols, inv_cols):
    """A level's nnz census [A, R, P, inverse] as one device tensor."""
    cnt = lambda c: ((c < PADCOL).sum() if c is not None
                     else torch.zeros((), dtype=torch.int64,
                                      device=a_cols.device))
    return torch.stack([cnt(a_cols), cnt(r_cols), cnt(p_cols),
                        cnt(inv_cols)])


# ~~~~~~~~~~~~~~~~~~ the level loop ~~~~~~~~~~~~~~~~~~


def setup_hierarchy_device(A, opts: AIROptions, dtype=torch.float32,
                           device="cuda") -> DeviceSetupHierarchy:
    """Build the AIR hierarchy with every O(nnz) step on ``device``.

    ``A``: a scipy matrix (uploaded once, in ``dtype``) or a ``DELL``
    (used on its own device, its values cast to ``dtype``).  On a CUDA
    device the solve form's DELLs are packed for the gather kernel at the
    end, with one host read (``solve_form_dells``, ``pack_dells``).
    """
    if not device_setup_supported(opts):
        raise ValueError("device setup does not support this option set; "
                         "use the host path")
    fault = device_setup_fault_reason(opts)
    if fault is not None:
        raise ValueError(f"device setup: {fault}; use the host path")
    if isinstance(A, DELL):
        A = DELL(A.data.to(dtype), A.cols, A.n_cols)
    else:
        A = DELL.from_scipy(A, dtype=dtype, device=device)
    top_A = A
    levels: list[DeviceLevel] = []
    auto_truncated = False
    coarse_inv = None
    # one setup.level span a level, tagged with its index; the coarsest
    # level's covers the probe or split that stopped the loop, and its
    # inverse
    level_span = ExitStack()
    while len(levels) < opts.max_levels - 1:
        level_span.enter_context(span("setup.level", len(levels)))
        n = A.shape[0]
        syncs0 = current_syncs()
        # auto-truncation probe (reference: src/AIR_MG_Setup.F90:158-256):
        # the coarse solver built here stops the hierarchy when it already
        # reduces a random residual below the tolerance (one read back)
        if (opts.auto_truncate_start_level > 0
                and len(levels) + 1 >= opts.auto_truncate_start_level):
            with timer("air_inverse"):
                probe_inv = _inverse_device(
                    _ensure_diag(A), opts, opts.coarsest_inverse_type,
                    opts.coarsest_poly_order,
                    opts.coarsest_matrix_free_polys, opts.seed, dtype)
            rng_p = np.random.default_rng(opts.seed + 101)
            b_p = torch.as_tensor(rng_p.standard_normal(n), dtype=A.dtype,
                                  device=A.device)
            r_p = b_p - A.matvec(probe_inv.apply(b_p))
            quality = float(torch.linalg.vector_norm(r_p)
                            / torch.linalg.vector_norm(b_p))
            if quality <= opts.auto_truncate_tol:
                auto_truncated = True
                coarse_inv = probe_inv
                break

        with timer("air_coarsen"):
            cf, nf_dev = _cf_split_device(A, opts)
            n_f = int(nf_dev)
            n_c = n - n_f
        if n_c <= opts.coarse_eq_limit or n_f == 0:
            break

        with timer("air_extract"):
            (is_f, is_c, fine_idx, coarse_idx, f_newidx,
             c_newidx) = _split_indices(cf, n_f, n_c)
            # an extraction only shrinks rows: the parent's width bounds
            # it, and no width is read back
            A_ff = extract_dell(A, fine_idx, is_f, f_newidx, n_f,
                                ensure_diag=True, compact_width=False)
            A_fc = extract_dell(A, fine_idx, is_c, c_newidx, n_c,
                                compact_width=False)
            A_cf = extract_dell(A, coarse_idx, is_f, f_newidx, n_f,
                                compact_width=False)

        # strong-R dropped copies, for the grid transfers only (reference:
        # src/AIR_Operators_Setup.F90:56-107); the smoother's inverse
        # stays on the un-dropped A_ff
        strong_r = float(opts.strong_r_threshold)
        if strong_r != 0.0:
            with timer("air_drop"):
                sdc, sdv = drop_rows(A.cols, A.data, strong_r, True, False)
                A_sdrop = DELL(sdv, sdc, n)
                A_ff_drop = extract_dell(A_sdrop, fine_idx, is_f, f_newidx,
                                         n_f, ensure_diag=True,
                                         compact_width=False)
                A_cf_drop = extract_dell(A_sdrop, coarse_idx, is_f,
                                         f_newidx, n_f, compact_width=False)
        else:
            A_ff_drop, A_cf_drop = A_ff, A_cf

        with timer("air_inverse"):
            inv_Aff = _inverse_device(
                A_ff, opts, opts.inverse_type, opts.poly_order,
                opts.matrix_free_polys, opts.seed, dtype)
            # AIRG's Z needs an assembled inverse of the dropped A_ff
            # (reference: src/AIR_Operators_Setup.F90:406-475)
            inv_for_z = None
            dinv_z = None
            if opts.z_type == ZType.PRODUCT:
                if inv_Aff.kind == "diagonal":
                    dinv_z = inv_Aff.diag   # the diagonal never drops
                    if (strong_r != 0.0
                            and opts.inverse_type == InverseType.WJACOBI):
                        # the hypre weight sees the dropped A_ff, as on
                        # the host path
                        dinv_z = _inverse_device(
                            A_ff_drop, opts, opts.inverse_type,
                            opts.poly_order, False, opts.seed, dtype).diag
                elif strong_r == 0.0 and inv_Aff.kind == "assembled":
                    inv_for_z = inv_Aff.mat
                else:
                    inv_for_z = _inverse_device(
                        A_ff_drop, opts, opts.inverse_type, opts.poly_order,
                        False, opts.seed, dtype).mat

        with timer("air_restrict"):
            drop_after = opts.improve_z_its > 0
            if opts.z_type != ZType.PRODUCT:
                Z = _lair_z_device(A_ff, A_cf, A_ff_drop, A_cf_drop,
                                   int(opts.lair_distance),
                                   incomplete=(opts.z_type == ZType.LAIR))
                drop_after = True
            elif dinv_z is not None:
                safe = torch.clamp(A_cf_drop.cols, max=n_f - 1).long()
                zdata = -A_cf_drop.data * torch.where(
                    A_cf_drop.cols < PADCOL, dinv_z[safe], 0.0)
                Z = DELL(zdata, A_cf_drop.cols, n_f)
                drop_after = True
            else:
                # the fused drop protects Z's (i, i) entry from the
                # relative drop, as the host remove_small_from_sparse
                tol_z = 0.0 if drop_after else float(opts.r_drop)
                Z = spgemm_drop_dell(A_cf_drop, inv_for_z, tol_z,
                                     relative=True, lump=False)
                Z = DELL(-Z.data, Z.cols, Z.n_cols)
            if opts.improve_z_its > 0:
                # D: the diagonal of the approximate inverse (reference:
                # src/Grid_Transfer_Improve.F90:60-66)
                if inv_for_z is not None:
                    inv_diag = inv_for_z.diagonal()
                elif dinv_z is not None:
                    inv_diag = dinv_z
                elif inv_Aff.kind == "assembled":
                    inv_diag = inv_Aff.mat.diagonal()
                elif inv_Aff.kind == "diagonal":
                    inv_diag = inv_Aff.diag
                else:
                    d0 = A_ff.diagonal()
                    inv_diag = torch.where(d0 != 0, 1.0 / d0, 0.0)
                Z = _improve_z_device(Z, A_ff, A_cf, inv_diag,
                                      int(opts.improve_z_its))
            if drop_after:
                zc, zv = drop_rows(Z.cols, Z.data, float(opts.r_drop),
                                   True, False)
                zc, zv = compact(zc, zv, max(max_row_count(zc), 1))
                Z = DELL(zv, zc, n_f)
            rcols, rvals = _assemble_r_ext(Z, fine_idx, cf, n)
            R_ext = DELL(rvals.to(dtype), rcols, n)

        with timer("air_prolong"):
            wcol = _one_point_w(A_fc)
            pcols, pvals, p1col, p1val = _assemble_p_ext(wcol, coarse_idx,
                                                         cf, n, dtype)
            P_ext = DELL(pvals, pcols, n)

        with timer("air_rap"):
            # AP = A P_ext: P has at most one entry a row, so the product
            # relabels A's columns at A's own width.  RAP then runs on the
            # coarse rows only, with the global C positions as protected
            # diagonals, and a column compression renumbers it to the
            # next level's matrix [n_c, n_c]
            AP = onecol_product(A, p1col, p1val.to(A.dtype), n)
            R_c = _r_compressed(Z, fine_idx, coarse_idx, n)
            RAP_c = spgemm_drop_dell(R_c, AP, float(opts.a_drop),
                                     relative=True, lump=opts.a_lump,
                                     diag_of_row=coarse_idx)
            A_next = extract_dell(RAP_c, _arange(n_c, cf), is_c, c_newidx,
                                  n_c, compact_width=False)

        aff_ext, afc_ext, fmask = _mask_ext_ops(A, cf)
        # each keeps all of A's slots, most of them zeroed: its packed
        # copy holds its nonzeros alone
        A_ff_ext_op = DELL(aff_ext, A.cols, n, nonzero_slots=True)
        dev = {
            "mask_f": fmask.to(dtype),
            "coarse": coarse_idx,
            "A_ff": A_ff_ext_op,
            "A_fc": DELL(afc_ext, A.cols, n, nonzero_slots=True),
            "inv_Aff": _extend_inverse(inv_Aff, A_ff_ext_op, fine_idx, cf,
                                       n, dtype),
            "R": R_ext,
            "P": P_ext,
        }
        syncs1 = current_syncs()
        levels.append(DeviceLevel(
            n=n, n_f=n_f, n_c=n_c, fine=fine_idx, coarse=coarse_idx,
            device=dev,
            nnz_dev=_level_nnz(
                A.cols, R_ext.cols, P_ext.cols,
                inv_Aff.mat.cols if inv_Aff.kind == "assembled" else None),
            syncs=None if syncs0 is None else syncs1 - syncs0))
        A = A_next
        level_span.close()
    else:   # the depth ran out: the coarsest level's span opens here
        level_span.enter_context(span("setup.level", len(levels)))

    syncs0 = current_syncs()
    with level_span:
        if not auto_truncated:
            with timer("air_inverse"):
                coarse_inv = _inverse_device(
                    A, opts, opts.coarsest_inverse_type,
                    opts.coarsest_poly_order,
                    opts.coarsest_matrix_free_polys, opts.seed, dtype)
    solve_form = DeviceHierarchy([lvl.device for lvl in levels], coarse_inv,
                                 top_A, False)
    _optimize_layouts(solve_form)
    if top_A.data.is_cuda:
        # before any capture: a CUDA graph of the solve cannot pack
        with span("dell.pack"):
            pack_dells(solve_form_dells(solve_form))
            solve_form.coarse_maps = coarse_maps(solve_form.levels)
    syncs1 = current_syncs()
    return DeviceSetupHierarchy(
        levels, A, coarse_inv, opts, top_A, solve_form, auto_truncated,
        coarse_syncs=None if syncs0 is None else syncs1 - syncs0)


def solve_form_dells(h: DeviceHierarchy) -> list:
    """Every DELL a device-built solve form multiplies by, each once: the
    top operator, each level's A_ff, A_fc, R, P and inverse's matrix
    (assembled, or the operator of a matrix-free one), and the coarse
    inverse's."""
    found = {}
    ops = [h.top, getattr(h.coarse_inv, "mat", None)]
    for dev in h.levels:
        ops += [dev.get(k) for k in ("A_ff", "A_fc", "R", "P")]
        inv = dev.get("inv_Aff")
        ops.append(getattr(inv, "mat", None))
    for op in ops:
        if isinstance(op, DELL):
            found.setdefault(id(op), op)
    return list(found.values())


# ~~~~~~~~~~~~~~~~~~ DIA layouts ~~~~~~~~~~~~~~~~~~


def _dia_census(op: DELL, cap: int = 16):
    """(block offset candidates [CENSUS_ROWS, cap+1], nnz) of a square
    pattern as device tensors, for ``_optimize_layouts``' single read."""
    return distinct_offsets_device(op.cols, cap=cap), \
        (op.cols < PADCOL).sum()


def _dia_rows(op: DELL, offsets) -> torch.Tensor:
    """The DIA data [len(offsets), n] of a DELL."""
    n = op.data.shape[0]
    ridx = _arange(n, op.cols, torch.int64)[:, None]
    offs = torch.where(op.cols < PADCOL, op.cols.long() - ridx, PADCOL)
    return torch.stack([torch.where(offs == int(o), op.data, 0.0).sum(dim=1)
                        for o in offsets])


def _dell_to_dia(op: DELL, census: np.ndarray, nnz: int):
    """DELL -> DIA when the offsets pay (at most 8 of them, fill at most
    3x the stored entries: the rule of ``DIA.viable``), else None."""
    n = op.data.shape[0]
    uniq = np.unique(census.astype(np.int64))
    uniq = uniq[uniq < OFFBIG]
    if len(uniq) == 0 or len(uniq) > 8 or len(uniq) * n > 3 * max(nnz, 1):
        return None
    return DIA(uniq.tolist(), _dia_rows(op, uniq), (n, n))


def _optimize_layouts(h: DeviceHierarchy):
    """Turn the square DELL operators of a device-built solve form into
    DIA where the offsets pay, so they run on the DIA kernel: each
    level's A_ff, A_fc, R, P and assembled inverse, and the top operator
    (which the reference keeps as a DELL; the upload of a host-built
    hierarchy makes it DIA by the same rule).  The offset censuses of
    every operator are computed on the device and read back at once."""
    cands = []
    if isinstance(h.top, DELL) and h.top.n_cols == h.top.data.shape[0]:
        cands.append((None, "top", h.top))
    for dev in h.levels:
        for key in ("A_ff", "A_fc", "R", "P"):
            op = dev.get(key)
            if isinstance(op, DELL) and op.n_cols == op.data.shape[0]:
                cands.append((dev, key, op))
        inv = dev.get("inv_Aff")
        if (inv is not None and inv.kind == "assembled"
                and isinstance(inv.mat, DELL)
                and inv.mat.n_cols == inv.mat.data.shape[0]):
            cands.append((dev, "_inv_mat", inv.mat))
    if not cands:
        return
    # operators that share one cols tensor (A_ff_ext and A_fc_ext keep
    # A's layout) share one census
    slots, rows = {}, []
    for _, _, op in cands:
        if id(op.cols) not in slots:
            slots[id(op.cols)] = len(rows)
            offs, nnz = _dia_census(op)
            rows.append(torch.cat([offs.reshape(-1), nnz.reshape(1)]))
    table = torch.stack(rows).cpu().numpy()
    for dev, key, op in cands:
        row = table[slots[id(op.cols)]]
        dia = _dell_to_dia(op, row[:-1], int(row[-1]))
        if dia is None:
            continue
        if key == "top":
            h.top = dia
        elif key == "_inv_mat":
            dev["inv_Aff"].mat = dia
        else:
            dev[key] = dia
    for dev in h.levels:
        # matrix-free inverses share the (possibly converted) A_ff
        inv = dev.get("inv_Aff")
        if (inv is not None and inv.kind in ("poly_mf", "newton_mf",
                                             "neumann_mf")
                and isinstance(dev.get("A_ff"), DIA)):
            inv.mat = dev["A_ff"]
