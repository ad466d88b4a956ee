"""Carry a hierarchy or an inverse across as numpy/scipy arrays ("weights
carried across").

``hierarchy_from_numpy`` builds this package's device hierarchy, and
``inverse_from_numpy`` a device approximate inverse (a PCPFLAREINV's),
from plain arrays -- for instance those of a preconditioner set up by the
JAX reference and read back from it -- so the two solves can be held
against each other on the very same operators, independent of either
setup.  ``dell_from_numpy`` does the same for a padded device matrix
(the device setup's ``DELL``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .air.fullspace import make_op
from .air.hierarchy import DeviceHierarchy
from .inverse.build import Inverse
from .inverse.newton import build_newton_program
from .params import tolerances
from .sparse.dell import DELL
from .sparse.dtypes import numpy_dtype

_INVERSE_KINDS = ("diagonal", "assembled", "dense", "poly_mf", "newton_mf",
                  "neumann_mf")


def inverse_from_numpy(spec: dict, dtype, device, op=None) -> Inverse:
    """Device Inverse from a spec dict: ``kind`` plus ``diag`` (diagonal,
    the scaling of a scaled matrix-free kind, or neumann_mf's diagonal of
    A), ``matrix`` (the assembled or dense inverse, or the operator A of a
    matrix-free kind when ``op`` is not given), ``coefficients``
    (poly_mf, neumann_mf; for newton_mf the roots [wr, wi], when no
    ``steps``), ``steps`` (newton_mf, the program of
    ``build_newton_program``) and ``scaled``.  Operators are built with
    ``make_op``."""
    kind = spec["kind"]
    if kind not in _INVERSE_KINDS:
        raise ValueError(f"unknown inverse kind {kind!r}")
    matrix = spec.get("matrix")
    steps = tuple(spec.get("steps", ()))
    if kind == "newton_mf" and not steps:
        wr, wi = np.asarray(spec["coefficients"], dtype=np.float64)
        steps = build_newton_program(
            wr, wi, tolerances(numpy_dtype(dtype, np.float64)).zero)
    if kind == "dense":
        matrix = np.asarray(matrix)
    elif matrix is not None:
        matrix = sp.csr_matrix(matrix)
        if op is None:
            op = make_op(matrix, dtype).to(device)
    inv = Inverse(kind, mat=matrix if kind == "dense" else None,
                  coefficients=spec.get("coefficients"), steps=steps,
                  diag=spec.get("diag"),
                  scaled=bool(spec.get("scaled", False)))
    return inv.to(device, dtype, mat=op if kind != "diagonal" else None)


def hierarchy_from_numpy(levels, coarse_inverse: dict, dtype, device,
                         top=None) -> DeviceHierarchy:
    """Device hierarchy from numpy/scipy arrays.

    ``levels``: one dict per level, every operator already in full-space
    form (n x n, see air/fullspace.py): ``A_ff``, ``A_fc``, ``R``, ``P``
    (scipy matrices), ``inv_Aff`` (an inverse spec: ``{"kind":
    "diagonal", "diag": d}``, ``{"kind": "assembled", "matrix": M}``, or a
    matrix-free kind, which runs over ``A_ff``), ``mask_f`` ([n], 1 on F
    points), ``fine`` (the F indices) and ``coarse`` (the C indices in the
    next level's order).
    ``coarse_inverse``: the coarse solver's spec, e.g. ``{"kind":
    "newton_mf", "steps": steps, "matrix": coarse_A}``.
    ``top``: optional finest-level matrix for the Krylov operator.
    """
    out = []
    for lv in levels:
        mask_f = np.asarray(lv["mask_f"])
        fine = np.asarray(lv["fine"])
        if not np.array_equal(np.flatnonzero(mask_f), np.sort(fine)):
            raise ValueError("mask_f and fine disagree")
        A_ff = make_op(sp.csr_matrix(lv["A_ff"]), dtype).to(device)
        out.append({
            "mask_f": torch.tensor(mask_f, dtype=dtype, device=device),
            "coarse": torch.tensor(np.asarray(lv["coarse"]),
                                   dtype=torch.int64, device=device),
            "A_ff": A_ff,
            "A_fc": make_op(sp.csr_matrix(lv["A_fc"]), dtype).to(device),
            "inv_Aff": inverse_from_numpy(
                lv["inv_Aff"], dtype, device,
                op=(None if lv["inv_Aff"]["kind"] in ("assembled", "dense")
                    else A_ff)),
            "R": make_op(sp.csr_matrix(lv["R"]), dtype).to(device),
            "P": make_op(sp.csr_matrix(lv["P"]), dtype).to(device),
        })
    top_op = (None if top is None
              else make_op(sp.csr_matrix(top), dtype).to(device))
    return DeviceHierarchy(out, inverse_from_numpy(coarse_inverse, dtype,
                                                   device), top_op)


def dell_from_numpy(data, cols, n_cols: int, dtype=None,
                    device="cuda") -> DELL:
    """This package's ``DELL`` from the arrays of a padded device matrix
    (``data``/``cols`` ``[n, K]``, dead slots (0, 2**30), live columns
    sorted): for instance a JAX ``DELL``'s, read back with numpy, so that
    both packages' device setups start from the same matrices.  ``dtype``
    defaults to that of ``data``."""
    return DELL(torch.tensor(np.asarray(data), dtype=dtype, device=device),
                torch.tensor(np.asarray(cols), dtype=torch.int32,
                             device=device), int(n_cols))
