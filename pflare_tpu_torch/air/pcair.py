"""PCAIR: the reduction-multigrid preconditioner object.

The user-facing counterpart of the reference's PCAIR PETSc type
(reference: src/PCAIR.c, src/PCAIR_Shell.F90) and of
``pflare_tpu.air.pcair.PCAIR``: ``setup`` builds the hierarchy on the
host (or, with ``structure="same"`` and ``reuse_sparsity``, rebuilds it
numerically on the stored patterns), ``upload`` builds its device form,
``apply`` runs the V-cycle, ``solve`` runs GMRES, FGMRES or Richardson
with it and ``solve_device`` a fixed number of Richardson or right-GMRES
iterations with no host round trip.  Changing options resets the
preconditioner (reference: src/PCAIR_Interfaces.F90:1821-1882).  Under
``reorder="rcm"``/``"auto"`` the setup and solve run in the
bandwidth-reducing order and every vector comes back in the caller's.
With a row mesh (parallel/mesh.py) ``setup(A, mesh=)`` runs the
distributed setup and ``solve_device(b, mesh=)`` the sharded solve.
``jit=True`` (the default, as in the reference) runs the solve's device
programs, each captured once into a CUDA graph and replayed
(utils/graphs.py), where the reference runs jitted XLA programs.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..options import AIROptions
from ..solvers.jitted import (gmres_right_fixed, gmres_stationary,
                              richardson_fixed)
from ..solvers.krylov import SolveResult, fgmres, gmres, richardson
from ..utils import graphs
from ..utils.timers import print_timers, span, timer
from .hierarchy import DeviceHierarchy, Hierarchy, setup_hierarchy
from .smooth import vcycle_full, vcycle_kaskade
from .stats import compute_stats, print_stats


class PCAIR:
    """Reduction multigrid with approximate ideal restriction.

    Usage::

        pc = PCAIR(AIROptions(...), dtype=torch.float32, device="cuda")
        pc.setup(A)              # scipy matrix (host setup)
        y = pc.apply(r)          # V-cycle on device tensors
        res = pc.solve(b, ...)   # GMRES with this PC

    ``dtype`` and ``device`` are those of the solve; the host setup runs
    in the precision of ``A``.

    ``jit`` (the reference's argument, pflare_tpu/air/pcair.py:83-92): on
    a CUDA device ``jit=True`` captures each of the solve's device
    programs into a CUDA graph at its first call and replays it after:
    ``apply``'s V-cycle (one graph per input length), the whole of
    ``solve_device`` (one per ``max_it``, solver, x0 given or not, and
    mesh) and, in ``solve``'s default GMRES, the preconditioned operator
    and the residual (one replay each an Arnoldi step; the step's one
    host read stays).  ``jit=False`` runs the cycle eagerly and ``solve``'s
    GMRES on the host-driven ``krylov.gmres``, as the reference does
    (:357-362).  On the CPU there is no graph: ``jit=True`` runs the same
    eager code.  The graphs belong to the device form they read: a new
    one (``setup``, ``setup_device``, a device re-setup's ``install``)
    or none (``reset``) drops them, and the next call captures anew.
    """

    def __init__(self, options: AIROptions | None = None, jit: bool = True,
                 dtype=torch.float32, device="cuda", **kw):
        opts = options or AIROptions()
        if kw:
            opts = opts.replace(**kw)
        self.options = _checked(opts)
        self.jit = jit
        self.dtype = dtype
        self.device = torch.device(device)
        # the captured programs of the current device form (jit on a card)
        self._programs = graphs.Programs(self.device)
        self.hierarchy: Hierarchy | None = None
        self._device_hierarchy: DeviceHierarchy | None = None
        self._perm = None       # device index tensors of the reordering
        self._iperm = None
        self._frozen = False    # KSPSetReusePreconditioner analogue
        self._dist = None       # (mesh, device form, DistributedState)
        self._injected_coeffs = None  # set_poly_coefficients payloads
        # whether this PCAIR's upload of its host hierarchy is still
        # registered there as pending (see Hierarchy.upload_done)
        self._upload_owed = False
        # host CSR bytes released when this PCAIR's upload compacted the
        # host hierarchy (0: it did not)
        self.host_bytes_released = 0

    def set_options(self, **kw):
        """Change options; the preconditioner resets."""
        self.options = _checked(self.options.replace(**kw))
        self.reset()

    def reset(self):
        """Drop the hierarchy, its device form and graphs and injected
        coefficients."""
        self.hierarchy = None
        self._device_hierarchy = None
        self._dist = None
        self._injected_coeffs = None
        self._upload_owed = False
        self.drop_graphs()

    def drop_graphs(self):
        """Drop the captured programs, and with them the operators they
        hold, when the device form is replaced or dropped: the next call
        captures anew."""
        self._programs.clear()

    def freeze(self, flag: bool = True):
        """While frozen, ``setup`` keeps the hierarchy it has
        (KSPSetReusePreconditioner semantics, reference:
        src/PCAIR.c:150-166)."""
        self._frozen = flag

    def build_device_resetup(self):
        """The device re-setup plan of this hierarchy
        (air/device_resetup.py): ``plan = pc.build_device_resetup();
        plan.install(pc, A_new)`` rebuilds the whole device form from the
        values of a matrix with the pattern of the last setup, in the
        caller's order, on this PCAIR's device and in its dtype.  Needs a
        setup with ``reuse_sparsity=True, reuse_amount>=3``."""
        from .device_resetup import DeviceResetup

        if self.hierarchy is None:
            raise RuntimeError("PCAIR not set up")
        if not isinstance(self.hierarchy, Hierarchy):
            raise ValueError("build_device_resetup needs a host setup: a "
                             "device-built hierarchy keeps no host "
                             "patterns to plan on")
        return DeviceResetup(
            self.hierarchy, dtype=self.dtype, device=self.device,
            perm=None if self._perm is None else self._perm.cpu().numpy())

    def setup(self, A, structure: str = "different", near_nullspace=None,
              mesh=None):
        """Build the hierarchy of the scipy matrix ``A`` on the host.
        ``structure="same"`` declares A's nonzero pattern that of the last
        setup: with ``reuse_sparsity`` the stored CF splitting and (from
        ``reuse_amount`` 2) the stored patterns are reused and only values
        are computed; otherwise it is a full setup (reference:
        src/PCAIR_Shell.F90:107-165).  ``near_nullspace``: candidate
        vectors for the constraints, in the caller's order.  A re-setup
        drops the uploaded device form: the next ``upload`` copies the new
        values, and a twin made by ``on`` before it keeps the old
        hierarchy.  ``mesh``: the distributed setup over a row mesh
        (``setup_hierarchy``): the Luby rounds sharded on its device, the
        W/Z/AP/RAP products row-sharded there and the power-basis QR by
        TSQR."""
        if structure not in ("same", "different"):
            raise ValueError("structure must be 'same' or 'different', not "
                             f"{structure!r}")
        if self._frozen and self.hierarchy is not None:
            return self
        A = self._apply_reorder(sp.csr_matrix(A))
        if near_nullspace is not None and self._perm is not None:
            perm = self._perm.cpu().numpy()
            near_nullspace = [np.asarray(v)[perm] for v in near_nullspace]
        previous = None
        if (structure == "same" and self.hierarchy is not None
                and self.options.reuse_sparsity):
            previous = self.hierarchy
            if not isinstance(previous, Hierarchy):
                raise ValueError(
                    "setup(A, 'same') after setup_device: a device-built "
                    "hierarchy keeps no host CF splitting or patterns to "
                    "reuse; call setup(A) or setup_device(A)")
        with timer("air_setup"):
            self.hierarchy = setup_hierarchy(
                A, self.options, previous=previous,
                near_nullspace=near_nullspace,
                injected_coeffs=self._injected_coeffs, mesh=mesh)
        self._device_hierarchy = None
        self._dist = None
        self.drop_graphs()
        self.hierarchy.expect_upload()
        self._upload_owed = True
        if self.options.print_stats_timings:
            print_stats(self.hierarchy)
            print_timers()
        return self

    def setup_device(self, A, dtype=None):
        """Build the hierarchy on this PCAIR's device, pattern discovery
        included (air/device_setup.py; the reference's Kokkos setup for
        device-resident matrices, docs/gpus.md): every O(nnz) step runs
        as torch ops there, in ``dtype`` (default: this PCAIR's dtype,
        which becomes the solve's).  ``A``: a scipy matrix (reordered as
        ``reorder`` asks) or a ``DELL`` already on the device (then
        ``reorder`` must be "none").  The solve form is stored, so
        ``upload`` copies nothing.  Outside the device envelope this
        prints the reason to stderr and runs the host ``setup``, whose
        hierarchy is uploaded as usual (the reference's rule,
        pflare_tpu/air/pcair.py:187-223); so it does where the
        reference's device path would build another preconditioner than
        its host setup (``device_setup_fault_reason``)."""
        from ..sparse.dell import DELL
        from .device_setup import (device_setup_fault_reason,
                                   device_setup_unsupported_reason,
                                   setup_hierarchy_device)

        with span("pcair.setup_device"):
            if self._frozen and self.hierarchy is not None:
                return self
            if dtype is not None:
                self.dtype = dtype
            reason = (device_setup_unsupported_reason(self.options)
                      or device_setup_fault_reason(self.options))
            if reason is not None:
                print("# setup_device: option(s) outside the device envelope, "
                      f"using the host setup: {reason}", file=sys.stderr)
                return self.setup(A)
            if isinstance(A, DELL):
                if self.options.reorder != "none":
                    raise ValueError(
                        "setup_device(DELL) cannot reorder; pass a scipy "
                        "matrix or set reorder='none'")
                if A.device.type != self.device.type:
                    raise ValueError(f"setup_device: the DELL lies on "
                                     f"{A.device}, this PCAIR solves on "
                                     f"{self.device}")
                self._perm = self._iperm = None
            else:
                with span("pcair.reorder"):
                    A = self._apply_reorder(sp.csr_matrix(A))
            with timer("air_setup"):
                self.hierarchy = setup_hierarchy_device(
                    A, self.options, dtype=self.dtype, device=self.device)
            self._device_hierarchy = self.hierarchy.solve_form
            self._dist = None
            self._upload_owed = False
            self.drop_graphs()
            return self

    def on(self, device) -> "PCAIR":
        """A PCAIR that shares this one's host hierarchy (and reordering)
        and solves on ``device``: one host setup, solved on the card and
        on the CPU.  Without ``reuse_sparsity`` the host hierarchy is
        compacted once every PCAIR sharing it has uploaded, so make the
        twins before the last upload; afterwards this raises
        ``ValueError``."""
        twin = PCAIR(self.options, jit=self.jit, dtype=self.dtype,
                     device=device)
        if isinstance(self.hierarchy, Hierarchy):
            self.hierarchy.expect_upload()
            twin._upload_owed = True
        twin.hierarchy = self.hierarchy
        if self._perm is not None:
            twin._perm = self._perm.to(twin.device)
            twin._iperm = self._iperm.to(twin.device)
        return twin

    def _apply_reorder(self, A):
        """Reverse Cuthill-McKee bands the matrix before setup
        (``reorder="rcm"``), or does so only when it at least halves the
        bandwidth (``"auto"``), so scrambled operators reach the DIA and
        banded kernels (reference: pflare_tpu/air/pcair.py:225-267)."""
        self._perm = self._iperm = None
        if self.options.reorder == "none":
            return A
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        pat = sp.csr_matrix((np.ones(A.nnz), A.indices, A.indptr),
                            shape=A.shape)
        perm = np.asarray(reverse_cuthill_mckee(sp.csr_matrix(pat + pat.T),
                                                symmetric_mode=True),
                          dtype=np.int64)
        iperm = np.empty_like(perm)
        iperm[perm] = np.arange(len(perm))
        if self.options.reorder == "auto" and A.nnz:
            rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
            bw_nat = int(np.abs(A.indices - rows).max())
            bw_rcm = int(np.abs(iperm[A.indices] - iperm[rows]).max())
            if bw_rcm * 2 > bw_nat:
                return A
        self._perm = torch.as_tensor(perm, device=self.device)
        self._iperm = torch.as_tensor(iperm, device=self.device)
        Ap = sp.csr_matrix(A[perm][:, perm])
        Ap.sort_indices()
        return Ap

    def _to_internal(self, v):
        return v if self._perm is None else v.index_select(0, self._perm)

    def _from_internal(self, v):
        return v if self._perm is None else v.index_select(0, self._iperm)

    def upload(self) -> DeviceHierarchy:
        """The device form of the hierarchy, built on first use (the
        host-to-device copy stage, which the reference keeps out of its
        setup timing: tests/adv_diff_fd.c:327).  Without
        ``reuse_sparsity``, the last pending upload of a host hierarchy
        (this PCAIR's and its twins', see ``on``) compacts it: every host
        matrix but the finest operator becomes an nnz/shape shim, as the
        reference's does after its upload (``Hierarchy.compact_host``);
        ``stats`` reads the same numbers after it."""
        if self.hierarchy is None:
            raise RuntimeError("PCAIR not set up")
        if self._device_hierarchy is None:
            self._device_hierarchy = self.hierarchy.to(self.device,
                                                       self.dtype)
        if self._upload_owed:
            self._upload_owed = False
            self.host_bytes_released = self.hierarchy.upload_done()
        return self._device_hierarchy

    @property
    def n_levels(self):
        return self.hierarchy.n_levels if self.hierarchy else 0

    def _vector(self, v):
        if isinstance(v, torch.Tensor):
            return v.to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.asarray(v), dtype=self.dtype,
                               device=self.device)

    def _precond(self, dh: DeviceHierarchy):
        """The internal-order preconditioner application."""
        if not dh.levels:
            # single level: the coarse solve alone (reference:
            # src/AIR_MG_Setup.F90:1158-1175)
            return dh.coarse_inv.apply
        if dh.full_smoothing:
            return lambda r: vcycle_full(dh.levels, dh.coarse_inv, r)
        smooth_order = self.options.smooth_arg
        return lambda r: vcycle_kaskade(dh.levels, dh.coarse_inv, r,
                                        smooth_order)

    def _graphed(self) -> bool:
        return self.jit and graphs.enabled(self.device)

    def _program(self, key, fn, meshes=()):
        """The captured program of ``key`` over the current device form."""
        return self._programs.get(self._device_hierarchy, key, fn, meshes)

    def apply(self, r):
        """y = M^-1 r."""
        M = self._precond(self.upload())
        r = self._vector(r)

        def run(v):
            return self._from_internal(M(self._to_internal(v)))

        if self._graphed():
            return self._program(("apply", r.shape[0], r.dtype), run)(r)
        return run(r)

    def __call__(self, r):
        return self.apply(r)

    def solve(self, b, x0=None, ksp="gmres", rtol=1e-5, atol=1e-50,
              max_it=10000, side="left", restart=30, eager=None):
        """Krylov solve with this preconditioner: ``ksp`` is "gmres"
        (``side`` left or right), "fgmres" or "richardson".  GMRES runs
        ``gmres_stationary`` (solvers/jitted.py, one host read an
        iteration); ``jit=False``, ``eager=True`` or PFLARE_EAGER_KSP=1
        runs the host-driven ``gmres`` of solvers/krylov.py instead (one
        host read a Gram-Schmidt dot).  With graphs (``jit`` on a card)
        the preconditioner of every solver is one replay, and so are
        ``gmres_stationary``'s operator and residual.  Returns a
        SolveResult whose ``x`` is a device tensor in the caller's
        order."""
        with span("pcair.solve"):
            if eager is None:
                eager = os.environ.get("PFLARE_EAGER_KSP") == "1"
            dh = self.upload()
            b = self._to_internal(self._vector(b))
            x0 = None if x0 is None else self._to_internal(self._vector(x0))
            M = self._precond(dh)
            program = None
            if self._graphed():
                def program(fn, name):
                    return self._program((name, side, b.shape[0]), fn)

                precond = program(M, "precond")
            else:
                precond = M
            if ksp == "gmres" and (eager or not self.jit):
                res = gmres(dh.top, b, x0=x0, M=precond, side=side, rtol=rtol,
                            atol=atol, max_it=max_it, restart=restart)
            elif ksp == "gmres":
                x, its, hist, done = gmres_stationary(
                    dh.top.matvec, M, b, x0, rtol, atol, int(max_it),
                    max(1, min(int(restart), int(max_it))), side,
                    program=program)
                res = SolveResult(x, its, done, list(hist[: its + 1]))
            elif ksp == "fgmres":
                res = fgmres(dh.top, b, x0=x0, M=precond, rtol=rtol, atol=atol,
                             max_it=max_it, restart=restart)
            elif ksp == "richardson":
                res = richardson(dh.top, b, x0=x0, M=precond, rtol=rtol,
                                 atol=atol, max_it=max_it)
            else:
                raise ValueError(f"unknown ksp {ksp!r}")
            res.x = self._from_internal(res.x)
            return res

    def solve_device(self, b, max_it: int = 10, ksp: str = "richardson",
                     x0=None, mesh=None):
        """``max_it`` preconditioned iterations with no host round trip:
        Richardson (``ksp="richardson"``) or right-preconditioned GMRES
        without restart (``"gmres"``/``"fgmres"``).  Returns (x, residual
        norms [max_it + 1]) as device tensors, x in the caller's order;
        the caller judges convergence from the norms.  With graphs
        (``jit`` on a card) the whole solve is one replay, the
        reference's one jitted ``run`` (pflare_tpu/air/pcair.py:460-466).
        Under full_smoothing_up_and_down the cycle is ``vcycle_full``, as
        in ``solve`` (the reference's solve_device runs the Kaskade cycle
        there, pflare_tpu/air/pcair.py:452-458).  ``mesh``: a row mesh
        whose controller device is this PCAIR's; the hierarchy is sharded
        over it (``_distributed_state``), b and x0 are permuted, padded
        and sharded (over the mesh's devices where it has several), and x
        comes back on this PCAIR's device cut to n in the caller's order.
        On a mesh over several cards the solve runs eagerly: ``jit=True``
        raises NotImplementedError there (see ``MULTI_CARD_GRAPHS``)."""
        if ksp == "richardson":
            solver = richardson_fixed
        elif ksp in ("gmres", "fgmres"):
            solver = gmres_right_fixed
        else:
            raise ValueError(f"unknown ksp {ksp!r}")
        if self._graphed() and mesh is not None and mesh.split:
            raise NotImplementedError(MULTI_CARD_GRAPHS)
        b = self._to_internal(self._vector(b))
        x0 = None if x0 is None else self._to_internal(self._vector(x0))
        n = b.shape[0]
        if mesh is None:
            dh = self.upload()
            matvec, precond, meshes = dh.top.matvec, self._precond(dh), ()
        else:
            from ..parallel.mesh import shard_vec

            st = self._distributed_state(mesh)
            matvec, precond, meshes = st.top.matvec, st.precond, (mesh,)
            b = shard_vec(b, mesh)
            x0 = None if x0 is None else shard_vec(x0, mesh)
        args = (b,) if x0 is None else (b, x0)

        def run(b, *x0):
            return solver(matvec, precond, b, max_it,
                          x0=x0[0] if x0 else None)

        if self._graphed():
            run = self._program(("solve_device", solver.__name__,
                                 int(max_it), len(args), b.shape[0], mesh),
                                run, meshes)
        x, norms = run(*args)
        return self._from_internal(x[:n]), norms

    def _distributed_state(self, mesh) -> "DistributedState":
        """The solve form sharded over ``mesh``, built once per mesh and
        set-up (reference: pflare_tpu/air/pcair.py:469-510): the top
        operator row-sharded on the padded row space (``HaloELL`` on the
        top's own container where the partition is banded, else against
        the all-gathered vector), the levels by ``shard_hierarchy`` and
        the V-cycle over them.  The full-smoothing form and a one-level
        hierarchy stay whole, their vectors cut to n and padded back."""
        from ..parallel.mesh import (_shard_op, padded_rows,
                                     shard_hierarchy, shard_vec,
                                     tensor_device)

        dh = self.upload()
        if (self._dist is not None and self._dist[0] is mesh
                and self._dist[1] is dh):
            return self._dist[2]
        if tensor_device(self.device) != tensor_device(mesh.device):
            raise ValueError(f"the mesh's controller device is "
                             f"{mesh.device}, this PCAIR solves on "
                             f"{self.device}")
        n = dh.top.shape[0]
        top = _shard_op(dh.top, mesh, padded_rows(n, mesh), "top")
        if dh.full_smoothing or not dh.levels:
            whole = self._precond(dh)
            levels, coarse_inv = dh.levels, dh.coarse_inv
            schedule = [1] * len(levels)

            def precond(r):
                return shard_vec(whole(r[:n]), mesh)
        else:
            levels, coarse_inv, schedule = shard_hierarchy(
                self.hierarchy, mesh, self.options, device_form=dh)
            order = self.options.smooth_arg

            def precond(r):
                return vcycle_kaskade(levels, coarse_inv, r, order)
        state = DistributedState(top, levels, coarse_inv, schedule, precond)
        self._dist = (mesh, dh, state)
        return state

    # ~~~~~~~~~~ introspection ~~~~~~~~~~
    def stats(self):
        return compute_stats(self.hierarchy)

    def view(self, out=print):
        """Print the configuration (the PCView analogue, reference:
        src/PCAIR.c:3034-3599)."""
        o = self.options
        lines = [
            "PCAIR (reduction multigrid with approximate ideal restriction)",
            f"  levels requested/built: {o.max_levels}/{self.n_levels}",
            f"  CF splitting: {o.cf_splitting_type.name}, strong threshold "
            f"{o.strong_threshold}, luby steps {o.max_luby_steps}, "
            f"ddc its {o.ddc_its} fraction {o.ddc_fraction}",
            f"  Z: {o.z_type.name}"
            + (f", lair distance {o.lair_distance}" if o.z_type.value else "")
            + f", strong R threshold {o.strong_r_threshold}",
            "  prolongator: "
            + ("one-point classical" if o.one_point_classical_prolong
               else "ideal")
            + (", symmetric (R^T)" if o.symmetric else ""),
            f"  A_ff inverse: {o.inverse_type.name}, order {o.poly_order}, "
            f"sparsity order {o.inverse_sparsity_order}, "
            f"{'matrix-free' if o.matrix_free_polys else 'assembled'}"
            + (", diag-scaled" if o.diag_scale_polys else ""),
            f"  smoothing: {o.smooth_order} "
            f"({'full up/down' if o.full_smoothing_up_and_down else 'F/C Kaskade'})",
            f"  coarse solver: {o.coarsest_inverse_type.name}, order "
            f"{o.coarsest_poly_order}, "
            f"{'matrix-free' if o.coarsest_matrix_free_polys else 'assembled'}",
            f"  drop: r_drop {o.r_drop}, a_drop {o.a_drop}, "
            f"lump {o.a_lump}",
            f"  reuse: sparsity {o.reuse_sparsity}, amount {o.reuse_amount}, "
            f"poly coeffs {o.reuse_poly_coeffs}",
        ]
        if self.hierarchy is not None:
            s = compute_stats(self.hierarchy)
            lines.append(
                f"  complexities: grid {s['grid_complexity']:.3f}, operator "
                f"{s['operator_complexity']:.3f}, cycle "
                f"{s['cycle_complexity']:.3f}, storage "
                f"{s['storage_complexity']:.3f}")
        for ln in lines:
            out(ln)
        return "\n".join(lines)

    def get_poly_coefficients(self, level: int):
        """The polynomial coefficients of a level's inverse, or of the
        coarse solver for ``level`` -1 or the coarsest index (None for an
        inverse without them; Newton gives the ``[2, k]`` real and
        imaginary roots).  Reference: PCAIRGetPolyCoeffs,
        include/pflare.h:191."""
        if level == -1 or level == self.n_levels - 1:
            inv = self.hierarchy.coarse_inv
        else:
            inv = self.hierarchy.levels[level].inv_Aff
        return (None if inv.coefficients is None
                else np.asarray(inv.coefficients))

    def set_poly_coefficients(self, level: int, coeffs):
        """Inject a level's polynomial coefficients (-1: the coarse
        solver) for the next setup, which then skips that level's
        coefficient iteration: with every level injected it reproduces
        the preconditioner they were taken from (reference:
        PCAIRSetPolyCoeffs, include/pflare.h:244; docs/reuse.md:216-390).
        Before the first setup the coarsest index is unknown, so use -1;
        after it the coarsest index maps to -1.  Layouts as
        ``get_poly_coefficients`` returns them."""
        level = int(level)
        if (level >= 0 and self.hierarchy is not None
                and level == self.n_levels - 1):
            level = -1
        if self._injected_coeffs is None:
            self._injected_coeffs = {}
        self._injected_coeffs[level] = np.asarray(coeffs)
        return self


# why PCAIR(jit=True) does not capture a solve over several cards
MULTI_CARD_GRAPHS = (
    "solve_device(mesh=) with jit=True on a mesh over several cards: "
    "PyTorch's copy between cards makes the capturing stream wait on an "
    "event of the other card's stream, recorded outside the capture, which "
    "invalidates it (cudaErrorStreamCaptureInvalidated on H100s), and a "
    "PyTorch CUDA graph's private memory pool serves only the capturing "
    "card; pass jit=False (the eager solve) for a mesh over several cards")


@dataclass
class DistributedState:
    """A solve form sharded over a row mesh: the top operator, the level
    dicts, the coarse inverse, the active shards of each level and the
    preconditioner application on padded vectors."""
    top: object
    levels: list
    coarse_inv: object
    schedule: list
    precond: object


def _checked(opts: AIROptions) -> AIROptions:
    if opts.reorder not in ("none", "rcm", "auto"):
        raise ValueError(f"unknown reorder {opts.reorder!r}")
    return opts
