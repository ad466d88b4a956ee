"""Neighbour-only distributed SpGEMM and submatrix extraction.

Ported from ``pflare_tpu.parallel.halo_spgemm``.  C = drop(A @ B) for
row-sharded DELL operands (``sparse/dell.py::ShardedDELL``): each shard's
expand gathers the B rows its A columns address; on a banded partition
those rows lie in the shard's own B block and one neighbour block on each
side, so the exchange is two neighbour copies of B's blocks -- the
PetscSF neighbour semantics of the reference's distributed
MatMatMult/MatPtAP (src/AIR_Operators_Setup.F90:993-1033,
src/PMISR_Module.F90:476-643).  Rectangular products (A_cf @ inv,
R @ AP) follow the per-space band rule: every A column's owner shard in
B's row partition lies within one of its row's shard.

The extraction A[row_idx][:, col_mask] is the same for the distributed
MatCreateSubMatrix (src/PETSc_Helperk.kokkos.cxx:1801-2403): each output
block's source rows lie in its own input block and one neighbour on each
side, and their columns within two blocks, so A's blocks move one shard
each way and the column mask and renumbering two.

Each shard runs the serial product or extraction on its rows, so the
values equal the serial path's.  When a band check fails these return
None and the caller takes the serial path over all of B (or A).  On a
split mesh (parallel/mesh.py) each shard runs on its own device: the
operands' row blocks are placed there from the controller device, the
neighbour blocks come over from the neighbouring devices, and each
shard's result rows go back to the controller device to be stacked.
"""

from __future__ import annotations

import torch

from ..sparse.dell import (DELL, PADCOL, ShardedDELL, _sentinel_rows,
                           spgemm_drop_parts)


def _mesh_of(x):
    """The mesh a row-sharded operator lives on, or None."""
    return x.mesh if isinstance(x, ShardedDELL) else None


def halo_mesh_for(A: DELL, B: DELL):
    """The shared mesh when both operands are row-sharded on one and
    their row counts divide it; else None."""
    ma, mb = _mesh_of(A), _mesh_of(B)
    if ma is None or ma is not mb:
        return None
    S = ma.size
    if A.data.shape[0] % S or B.data.shape[0] % S:
        return None
    return ma


def _band_ok(cols, w_rows: int, w_cols: int) -> bool:
    """Does every live entry's column owner (blocks of ``w_cols``) lie
    within one shard of its row's (blocks of ``w_rows``)?  One read."""
    live = cols < PADCOL
    rows = torch.arange(cols.shape[0], device=cols.device)[:, None]
    far = (torch.where(live, cols, 0) // w_cols - rows // w_rows).abs() > 1
    return not bool((live & far).any())


def spgemm_drop_halo(A: DELL, B: DELL, tol: float, relative: bool,
                     lump: bool, mesh, diag_of_row=None):
    """The fused product + drop shard by shard, B's blocks exchanged with
    the neighbours: the chunks of ``spgemm_drop_parts`` in row order, or
    None when the band check fails."""
    S = mesh.size
    n_a = A.data.shape[0]
    w_a, w_b = n_a // S, B.data.shape[0] // S
    if not _band_ok(A.cols, w_a, w_b):
        return None
    if diag_of_row is None:
        diag_of_row = torch.arange(n_a, dtype=A.cols.dtype, device=A.device)
    Kb = B.K
    label = getattr(A, "label", "")
    bd = mesh.halo(mesh.scatter(B.data.view(S, w_b, Kb), label), label)
    bc = mesh.halo(mesh.scatter(B.cols.view(S, w_b, Kb), label), label)
    parts = []
    for s in range(S):
        rows = slice(s * w_a, (s + 1) * w_a)
        g, i, own = _shard(mesh, s, label)
        ac = own(A.cols[rows])
        # A's columns in the shard's window of B rows [(s-1) w_b, (s+2) w_b)
        local = torch.where(ac < PADCOL, ac - (s - 1) * w_b, PADCOL)
        bc1, bd1 = _sentinel_rows(DELL(bd[g][i], bc[g][i], B.n_cols))
        parts += [_back(mesh, g, part, label) for part in spgemm_drop_parts(
            own(A.data[rows]), local, bc1, bd1, 3 * w_b, tol, relative,
            lump, own(diag_of_row[rows]))]
    return parts


def _shard(mesh, s: int, label: str):
    """Shard s's group, its index there, and a function that places a
    controller tensor on its device."""
    g = mesh.group_of(s)
    return (g, s - mesh.groups[g].start,
            lambda t: mesh._to_group(t, 0, g, label))


def _back(mesh, g: int, tensors, label: str):
    """A shard's result tensors on the controller device."""
    return tuple(mesh._to_group(t, g, 0, label) for t in tensors)


def extract_halo(A: DELL, row_idx, col_mask, col_newidx, ensure_diag: bool,
                 mesh):
    """A[row_idx][:, col_mask] with columns renumbered, shard by shard
    with neighbour exchanges: uncompacted (cols, vals) in row_idx order,
    or None when the band check fails or the sizes do not fit the mesh.
    The column window counts in A's row blocks, so the operator must be
    square (a rectangular source, as the coarse-compressed RAP's, takes
    the serial gather)."""
    S = mesh.size
    n_in = A.data.shape[0]
    n_new = row_idx.shape[0]
    if (n_in % S or n_new == 0 or col_mask.shape[0] != n_in
            or col_newidx.shape[0] != n_in or A.n_cols != n_in):
        return None
    w_in = n_in // S
    w_out = -(-n_new // S)
    ridx = torch.cat([row_idx.to(torch.int64), row_idx.new_full(
        (S * w_out - n_new,), PADCOL).to(torch.int64)])
    if not (_band_ok(ridx[:, None], w_out, w_in)
            and _band_ok(A.cols, w_in, w_in)):
        return None
    K = A.K
    label = getattr(A, "label", "")

    def halo(t, depth=1):
        return mesh.halo(mesh.scatter(t, label), label, depth=depth)

    ad = halo(A.data.view(S, w_in, K))
    ac = halo(A.cols.view(S, w_in, K))
    cm = halo(col_mask.to(torch.int32).view(S, w_in), depth=2)
    cn = halo(col_newidx.to(torch.int32).view(S, w_in), depth=2)
    outs_c, outs_v = [], []
    for s in range(S):
        g, i, own = _shard(mesh, s, label)
        r = own(ridx[s * w_out:(s + 1) * w_out])
        live_r = r < PADCOL
        # source rows in the window [(s-1) w_in, (s+2) w_in); dead rows
        # read the sentinel row appended past it
        loc = torch.where(live_r, r - (s - 1) * w_in, 3 * w_in)
        cols = torch.cat([ac[g][i], ac[g].new_full((1, K), PADCOL)])[loc]
        vals = torch.cat([ad[g][i], ad[g].new_zeros((1, K))])[loc]
        live = cols < PADCOL
        # columns in the window [(s-2) w_in, (s+3) w_in)
        cloc = torch.where(live, cols.to(torch.int64) - (s - 2) * w_in,
                           5 * w_in)
        cms = torch.cat([cm[g][i], cm[g].new_zeros(1)])
        cns = torch.cat([cn[g][i], cn[g].new_zeros(1)])
        keep = live & (cms[cloc] != 0)
        ncols = torch.where(keep, cns[cloc].to(cols.dtype), PADCOL)
        nvals = torch.where(keep, vals, 0.0)
        if ensure_diag:
            grow = s * w_out + torch.arange(w_out, dtype=cols.dtype,
                                            device=cols.device)
            has = (ncols == grow[:, None]).any(dim=1)
            extra = torch.where(has | ~live_r, PADCOL, grow)[:, None]
            ncols = torch.cat([ncols, extra], dim=1)
            nvals = torch.cat([nvals, nvals.new_zeros((w_out, 1))], dim=1)
        ncols, nvals = _back(mesh, g, (ncols, nvals), label)
        outs_c.append(ncols)
        outs_v.append(nvals)
    return torch.cat(outs_c)[:n_new], torch.cat(outs_v)[:n_new]
