"""Full-space (mask-extended) level form: the solve's operators.

As in the reference (pflare_tpu/air/fullspace.py), each level keeps every
operator in the level's own index space, masked to the F/C blocks:

    A_ff_ext = Mf A Mf,  A_fc_ext = Mf A Mc,  inv_ext = embed(inv(A_ff))

so F smoothing moves no indices at all,

    t = mask_f * b - A_fc_ext @ x
    x <- x + inv_ext(t - A_ff_ext @ x)

and restriction/prolongation need one small gather/scatter each.  The
masked operators inherit the original ordering, so on structured problems
they stay few-offset banded and take the DIA or banded kernels.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .. import cuda
from ..inverse.build import Inverse
from ..sparse import ELL, TELL
from ..sparse.banded import BandedSpMV
from ..sparse.dia import DIA
from ..sparse.dell import DELL
from ..sparse.dtypes import numpy_dtype
from ..sparse.ell import Sell


def op_kind(M_host: sp.csr_matrix) -> str:
    """The solve-phase container of a host matrix, chosen by structure
    alone: "dia" when its offsets pay, else "banded" (the windowed SpMV)
    when the bandwidth allows, else "tell" (the [K, n] gather ELL).  The
    choice does not depend on the device, so a CPU run builds the
    containers a card runs, and a row-sharded operator gives each shard
    the kind of the whole (parallel/halo.py)."""
    if DIA.viable(M_host):
        return "dia"
    if BandedSpMV.viable(M_host):
        return "banded"
    return "tell"


def make_op(M_host: sp.csr_matrix, dtype=None):
    """The container ``op_kind`` chooses, built from the host matrix."""
    cls = {"dia": DIA, "banded": BandedSpMV, "tell": TELL}[op_kind(M_host)]
    return cls.from_scipy(M_host, dtype=dtype)


def _map_rows(M: sp.csr_matrix, row_map: np.ndarray, n_new: int):
    coo = M.tocoo()
    out = sp.csr_matrix(
        (coo.data, (row_map[coo.row], coo.col)), shape=(n_new, M.shape[1])
    )
    out.sort_indices()
    return out


def _map_cols(M: sp.csr_matrix, col_map: np.ndarray, n_new: int):
    coo = M.tocoo()
    out = sp.csr_matrix(
        (coo.data, (coo.row, col_map[coo.col])), shape=(M.shape[0], n_new)
    )
    out.sort_indices()
    return out


def _map_both(M: sp.csr_matrix, row_map, col_map, n: int):
    coo = M.tocoo()
    out = sp.csr_matrix(
        (coo.data, (row_map[coo.row], col_map[coo.col])), shape=(n, n)
    )
    out.sort_indices()
    return out


def inverse_to_fullspace(inv: Inverse, fine: np.ndarray, n: int,
                         A_ff_op, dtype, device) -> Inverse:
    """The device form of a compressed-F-space inverse, re-expressed in
    the level's full index space.  Applied vectors are F-supported
    throughout, so the matrix-free chains run unchanged over the masked
    operator."""
    if inv.kind == "diagonal":
        d = np.zeros(n)
        d[fine] = inv.diag
        return Inverse("diagonal", diag=d).to(device, dtype)
    if inv.kind in ("assembled", "dense"):
        # LU's dense inv(A_ff) is embedded like any assembled inverse
        M_ext = _map_both(inv.host_csr, fine, fine, n)
        return Inverse("assembled", host_csr=M_ext,
                       coefficients=inv.coefficients).to(
            device, dtype, mat=make_op(M_ext, dtype).to(device))
    # matrix-free kinds: swap the operator; extend the diagonal with ones
    # outside F so the divisions are harmless
    diag_ext = None
    if inv.diag is not None:
        diag_ext = np.ones(n)
        diag_ext[fine] = inv.diag
    return Inverse(inv.kind, coefficients=inv.coefficients, steps=inv.steps,
                   diag=diag_ext, scaled=inv.scaled).to(device, dtype,
                                                        mat=A_ff_op)


def build_fullspace_level(lvl, dtype, device) -> dict:
    """Device dict of one level in full-space form (see module docstring);
    ``lvl`` is a hierarchy ``LevelData`` (host matrices in compressed F/C
    spaces).  With C-point smoothing the level also carries ``mask_c``,
    A_cc, A_cf and inv(A_cc), masked alike.  ``coarse`` is the transfer
    order: the repartitioned order the next level lives in, when there is
    one (the basis change costs nothing, the transfer already gathers)."""
    n = lvl.n
    fine = np.asarray(lvl.fine)
    coarse = np.asarray(lvl.coarse)
    coarse_tx = coarse if lvl.coarse_order is None else lvl.coarse_order
    np_dtype = numpy_dtype(dtype, np.float64)
    mask_f = np.zeros(n, dtype=np_dtype)
    mask_f[fine] = 1.0
    A_ff_op = make_op(_map_both(lvl.A_ff, fine, fine, n), dtype).to(device)
    d = {
        "mask_f": torch.from_numpy(mask_f).to(device),
        "coarse": torch.as_tensor(coarse_tx, dtype=torch.int64,
                                  device=device),
        "A_ff": A_ff_op,
        "A_fc": make_op(_map_both(lvl.A_fc, fine, coarse, n),
                        dtype).to(device),
        "inv_Aff": inverse_to_fullspace(lvl.inv_Aff, fine, n, A_ff_op,
                                        dtype, device),
        "R": make_op(_map_rows(lvl.R, coarse, n), dtype).to(device),
        "P": make_op(_map_cols(lvl.P, coarse, n), dtype).to(device),
    }
    if lvl.A_cc is not None:
        mask_c = np.zeros(n, dtype=np_dtype)
        mask_c[coarse] = 1.0
        A_cc_op = make_op(_map_both(lvl.A_cc, coarse, coarse, n),
                          dtype).to(device)
        d["mask_c"] = torch.from_numpy(mask_c).to(device)
        d["A_cc"] = A_cc_op
        d["A_cf"] = make_op(_map_both(lvl.A_cf, coarse, fine, n),
                            dtype).to(device)
        d["inv_Acc"] = inverse_to_fullspace(lvl.inv_Acc, coarse, n, A_cc_op,
                                            dtype, device)
    return d


def _positions(coarse, n: int):
    """[n] int64: k at position coarse[k], -1 elsewhere."""
    pos = torch.full((n,), -1, dtype=torch.int64, device=coarse.device)
    pos[coarse] = torch.arange(coarse.shape[0], device=coarse.device)
    return pos


def coarse_maps(levels) -> list:
    """For each full-space level, the packed copies through which the
    V-cycle's R writes, and its P reads, the coarse vector itself
    (``smooth.vcycle_kaskade``; ``sparse/ell.py::Fused``): (R's, P's),
    each None where that operator is no gather container (TELL, ELL,
    DELL) with a packed copy beside the coarse list.  R's copy keeps R's
    index and values and names each output row by its position in
    ``coarse``, so it writes R(b)[coarse] (the other rows, dropped by
    that gather too, write nothing).  P's keeps P's index and values and
    renumbers each column by its position in ``coarse``, so it reads the
    coarse vector; where a live column of P is no coarse one (P z then
    reads more than z[coarse]) P keeps the scatter: checked for all
    levels with one host read a device.  None for a level of the
    full-smoothing form (no ``coarse``).  Made where the solve form's
    packed copies are made, never in a capture."""
    maps, checks = [], {}
    for i, lev in enumerate(levels):
        coarse = lev.get("coarse")
        if not isinstance(coarse, torch.Tensor):
            maps.append(None)
            continue
        n = lev["mask_f"].shape[0]
        pos = _positions(coarse, n)
        R, P = ((M.packed if isinstance(M, (TELL, ELL, DELL)) else None)
                for M in (lev["R"], lev["P"]))
        R_map = P_map = None
        if (R is not None and R.data.device == coarse.device
                and R.shape[0] == n):
            at = pos[R.row_of.clamp(min=0).long()]
            R_map = Sell(R.index, R.data, R.cols,
                         (coarse.shape[0], R.shape[1]),
                         row_of=torch.where(R.row_of >= 0, at, -1)
                         .to(torch.int32))
        if (P is not None and P.data.device == coarse.device
                and P.shape[1] == n):
            at = pos[P.cols.long()]
            live = P.index.src >= 0
            P_map = Sell(P.index, P.data,
                         torch.where(live, at, 0).to(torch.int32),
                         (P.shape[0], coarse.shape[0]))
            checks.setdefault(coarse.device, []).append(
                (i, (live & (at < 0)).sum()))
        maps.append((R_map, P_map))
    for dev, found in checks.items():
        with cuda.guard(dev):
            outside = torch.stack([c for _, c in found]).tolist()
        for (i, _), bad in zip(found, outside):
            if bad:
                maps[i] = (maps[i][0], None)
    return maps


def build_full_smoothing_level(lvl, dtype, device) -> dict:
    """Device dict of one level under full_smoothing_up_and_down: the
    level operator, the smoother's inverse of the whole A and the
    compressed transfers (R is n_c x n, P n x n_c), each built with
    ``make_op`` so that DIA and banded operators reach their kernels
    (the reference builds them as plain ELL,
    pflare_tpu/air/hierarchy.py:78-96)."""
    A_op = make_op(lvl.A, dtype).to(device)
    inv = lvl.inv_Aff
    if inv.kind == "assembled":
        inv_dev = inv.to(device, dtype,
                         mat=make_op(inv.host_csr, dtype).to(device))
    elif inv.kind in ("diagonal", "dense"):
        inv_dev = inv.to(device, dtype)
    else:   # matrix-free: the polynomial runs on the level operator
        inv_dev = inv.to(device, dtype, mat=A_op)
    return {"A": A_op, "inv_Aff": inv_dev,
            "R": make_op(lvl.R, dtype).to(device),
            "P": make_op(lvl.P, dtype).to(device)}
