"""Hierarchy statistics: grid, operator, cycle and storage complexities.

Reference: src/AIR_MG_Stats.F90:17-421, ported from
``pflare_tpu.air.stats``.  Complexities are relative to the finest grid;
the cycle complexity counts the nonzeros one V-cycle touches (matrix-free
polynomial matvecs included) relative to nnz(A).  Host matrices, or
the nnz/shape shims that ``Hierarchy.compact_host`` leaves of them.
"""

from __future__ import annotations


def _nnz(M):
    return M.nnz if M is not None else 0


def _inv_storage(inv):
    """Stored entries of an approximate inverse (0 for matrix-free)."""
    if inv is None:
        return 0
    if inv.kind == "assembled":
        return inv.host_csr.nnz
    if inv.kind == "dense":
        return int(inv.mat.shape[0]) ** 2
    if inv.kind == "diagonal":
        return int(inv.diag.shape[0])
    return 0


def _inv_nnz(inv, mat):
    """Nonzeros touched by one application of an approximate inverse;
    matrix-free kinds pay their matvecs with ``mat``."""
    if inv is None:
        return 0
    if inv.kind in ("assembled", "dense", "diagonal"):
        return _inv_storage(inv)
    return inv.num_matvecs * _nnz(mat)


def compute_stats(hierarchy) -> dict:
    levels = hierarchy.levels
    opts = hierarchy.options
    if not levels:
        return {"levels": 1, "grid_complexity": 1.0,
                "operator_complexity": 1.0, "cycle_complexity": 1.0,
                "storage_complexity": 1.0, "reuse_storage_complexity": 0.0}

    if not hasattr(levels[0], "A"):
        raise ValueError("stats need the host matrices of a host setup; a "
                         "device-built hierarchy has none")
    n_fine = levels[0].n
    nnz_fine = levels[0].A.nnz
    cm = hierarchy.coarse_matrix
    rows = [lvl.n for lvl in levels] + [cm.shape[0]]
    nnz_A = [lvl.A.nnz for lvl in levels] + [cm.nnz]

    # per-V-cycle nonzeros (reference: src/AIR_MG_Stats.F90:79-255)
    cycle_nnz = 0
    storage_nnz = 0
    for lvl in levels:
        cycle_nnz += lvl.R.nnz + lvl.P.nnz
        for group in opts.smooth_order:
            its = abs(group)
            if group > 0:
                per_it = lvl.A_ff.nnz + _inv_nnz(lvl.inv_Aff, lvl.A_ff)
                cycle_nnz += _nnz(lvl.A_fc) + its * per_it
            elif group < 0:
                per_it = _nnz(lvl.A_cc) + _inv_nnz(lvl.inv_Acc, lvl.A_cc)
                cycle_nnz += _nnz(lvl.A_cf) + its * per_it
        storage_nnz += (lvl.R.nnz + lvl.P.nnz + lvl.A_ff.nnz
                        + _nnz(lvl.A_fc) + _nnz(lvl.A_cf) + _nnz(lvl.A_cc)
                        + _inv_storage(lvl.inv_Aff)
                        + _inv_storage(lvl.inv_Acc))
    ci = hierarchy.coarse_inv
    cycle_nnz += _inv_nnz(ci, cm)
    storage_nnz += _inv_storage(ci) + cm.nnz
    reuse_nnz = sum(lvl.patterns[key].nnz for lvl in levels
                    for key in ("W_drop", "Z_drop", "RAP_drop")
                    if key in lvl.patterns)

    return {
        "levels": len(levels) + 1,
        "rows": rows,
        "nnz": nnz_A,
        "grid_complexity": sum(rows) / n_fine,
        "operator_complexity": sum(nnz_A) / nnz_fine,
        "cycle_complexity": cycle_nnz / nnz_fine,
        "storage_complexity": storage_nnz / nnz_fine,
        "reuse_storage_complexity": (reuse_nnz / nnz_fine
                                     if opts.reuse_sparsity else 0.0),
    }


def print_stats(hierarchy):
    s = compute_stats(hierarchy)
    print(f" Number of levels: {s['levels']}")
    print(f" Grid complexity: {s['grid_complexity']:.6f}")
    print(f" Operator complexity: {s['operator_complexity']:.6f}")
    print(f" Cycle complexity: {s['cycle_complexity']:.6f}")
    print(f" Storage complexity: {s['storage_complexity']:.6f}")
    print(f" Reuse storage complexity: {s['reuse_storage_complexity']:.6f}")
    return s
