"""PCPFLAREINV: the one-level approximate-inverse preconditioner object.

The counterpart of the reference's PC type (reference: src/PCPFLAREINV.c)
and of ``pflare_tpu.pcpflareinv.PCPFLAREINV``: ``setup`` computes the
approximate inverse on the host in A's precision (reusing stored or
injected polynomial coefficients where asked), ``upload`` builds its
device form, ``apply`` is one application of it and ``solve`` runs GMRES
or Richardson with it.  The get/set coefficient protocol rebuilds a
preconditioner exactly (reference: src/PCPFLAREINV.c:484-563,
tests/ex6_getcoeffs.c).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import scipy.sparse as sp
import torch

from .air.fullspace import make_op
from .inverse import build_inverse
from .options import PFLAREINVOptions
from .solvers.krylov import gmres, richardson


class PCPFLAREINV:
    """One-level approximate inverse.

    Usage::

        pc = PCPFLAREINV(PFLAREINVOptions(...), dtype=torch.float32,
                         device="cuda")
        pc.setup(A)              # scipy matrix (host setup)
        y = pc.apply(r)          # one inverse application on the device
        res = pc.solve(b, ...)   # GMRES (or Richardson) with this PC

    The Krylov operator is ``make_op(A)``, so a structured A runs its
    matvecs through the DIA kernel; an assembled inverse is uploaded the
    same way, and a matrix-free one shares the Krylov operator.
    """

    def __init__(self, options: PFLAREINVOptions | None = None,
                 dtype=torch.float32, device="cuda", **kw):
        opts = options or PFLAREINVOptions()
        if kw:
            opts = replace(opts, **kw)
        self.options = opts
        self.dtype = dtype
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PCPFLAREINV: device 'cuda' asked for, but no "
                               "CUDA device is available")
        self.inverse = None       # host Inverse
        self.reuse_poly_coeffs = False
        self._A = None            # host matrix of the last setup
        self._device = None       # (Krylov operator, device Inverse)
        self._frozen = False
        self._injected = None

    def set_options(self, **kw):
        self.options = replace(self.options, **kw)
        self.reset()

    def reset(self):
        self.inverse = None
        self._A = None
        self._device = None
        self._injected = None

    def freeze(self, flag: bool = True):
        self._frozen = flag

    @staticmethod
    def _as_coefficients(c):
        """Polynomial coefficients (1-D) or Newton roots (wr, wi)."""
        c = np.asarray(c)
        return c if c.ndim == 1 else (c[0], c[1])

    def setup(self, A, structure: str = "different"):
        """Build the inverse of the scipy matrix ``A`` on the host.
        Coefficients injected by ``set_poly_coeffs`` skip the polynomial
        iteration; so does ``structure='same'`` with
        ``reuse_poly_coeffs`` (reference: src/PCPFLAREINV.c:689-781)."""
        if self._frozen and self.inverse is not None:
            return self
        A = sp.csr_matrix(A)
        A.sort_indices()
        coeffs = None
        if self._injected is not None:
            coeffs = self._as_coefficients(self._injected)
        elif (structure == "same" and self._A is not None
                and self.reuse_poly_coeffs and self.inverse is not None
                and self.inverse.coefficients is not None):
            coeffs = self._as_coefficients(self.inverse.coefficients)
        o = self.options
        self.inverse = build_inverse(
            A, o.inverse_type, poly_order=o.poly_order,
            sparsity_order=o.inverse_sparsity_order,
            matrix_free=o.matrix_free, diag_scale=o.diag_scale,
            coefficients=coeffs, seed=o.seed)
        self._A = A
        self._device = None
        return self

    def upload(self):
        """(Krylov operator, device inverse), built on first use."""
        if self.inverse is None:
            raise RuntimeError("PCPFLAREINV not set up")
        if self._device is None:
            op = make_op(self._A, self.dtype).to(self.device)
            inv = self.inverse
            if inv.kind == "assembled":
                mat = make_op(inv.host_csr, self.dtype).to(self.device)
            elif inv.kind in ("poly_mf", "newton_mf", "neumann_mf"):
                mat = op
            else:
                mat = None
            self._device = (op, inv.to(self.device, self.dtype, mat=mat))
        return self._device

    def _vector(self, v):
        if isinstance(v, torch.Tensor):
            return v.to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.asarray(v), dtype=self.dtype,
                               device=self.device)

    def apply(self, r):
        """y = M^-1 r."""
        return self.upload()[1].apply(self._vector(r))

    def __call__(self, r):
        return self.apply(r)

    # ~~~~~~~~~~ coefficient protocol ~~~~~~~~~~
    def get_poly_coeffs(self):
        if self.inverse is None or self.inverse.coefficients is None:
            return None
        return np.asarray(self.inverse.coefficients)

    def set_poly_coeffs(self, coeffs):
        """Inject coefficients: the next setup skips the polynomial
        iteration.  A built inverse takes them at once."""
        self._injected = np.asarray(coeffs)
        self.reuse_poly_coeffs = True
        if self.inverse is not None:
            self.inverse.coefficients = self._injected
            if self._device is not None:
                self._device[1].coefficients = torch.tensor(
                    self._injected, dtype=self.dtype, device=self.device)

    def get_inverse_mat(self):
        """The device container of an assembled inverse, borrowed
        (reference: PCPFLAREINVGetInverseMat, src/PCPFLAREINV.c:259)."""
        if self.inverse is None or self.inverse.kind != "assembled":
            return None
        return self.upload()[1].mat

    def view(self, out=print):
        """Print the configuration (PCView analogue)."""
        o = self.options
        lines = [
            "PCPFLAREINV (one-level approximate inverse)",
            f"  inverse type: {o.inverse_type.name}",
            f"  polynomial order: {o.poly_order}, sparsity order "
            f"{o.inverse_sparsity_order}",
            f"  application: {'matrix-free' if o.matrix_free else 'assembled'}"
            + (", diag-scaled" if o.diag_scale else ""),
            f"  solve: {self.dtype} on {self.device}",
        ]
        if self.inverse is not None:
            lines.append(f"  built: kind={self.inverse.kind}")
        for ln in lines:
            out(ln)
        return "\n".join(lines)

    def solve(self, b, ksp="gmres", rtol=1e-5, atol=1e-50, max_it=10000,
              side="left", restart=30, x0=None):
        """GMRES or Richardson with this preconditioner; returns a
        SolveResult whose ``x`` is a device tensor."""
        op, inv = self.upload()
        b = self._vector(b)
        x0 = None if x0 is None else self._vector(x0)
        if ksp == "gmres":
            return gmres(op, b, x0=x0, M=inv.apply, side=side, rtol=rtol,
                         atol=atol, max_it=max_it, restart=restart)
        if ksp == "richardson":
            return richardson(op, b, x0=x0, M=inv.apply, rtol=rtol,
                              atol=atol, max_it=max_it)
        raise ValueError(ksp)
