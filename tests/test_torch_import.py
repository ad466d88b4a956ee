"""pflare_tpu_torch stands alone: no jax, no pflare_tpu, same problems."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pflare_tpu
import pflare_tpu_torch
from pflare_tpu_torch import cuda, native

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_jax_out():
    """Importing the port and every one of its modules pulls in neither
    jax nor pflare_tpu."""
    code = (
        "import json, pkgutil, importlib, sys\n"
        "import pflare_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pflare_tpu')]\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("module", ["sparse.dell", "cf.device",
                                    "air.device_setup",
                                    "air.setup_compare"])
def test_device_setup_modules_stand_alone(module):
    """The device first setup's modules import neither jax nor
    pflare_tpu, each on its own."""
    code = (
        "import json, importlib, sys\n"
        f"importlib.import_module('pflare_tpu_torch.{module}')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pflare_tpu')]\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("module", ["problems.io", "problems.gmsh",
                                    "problems.fem_dg", "problems.fem_supg",
                                    "parallel.mesh", "parallel.halo",
                                    "parallel.halo_spgemm", "parallel.tsqr",
                                    "parallel.repartition",
                                    "utils.hostmem"])
def test_problem_modules_stand_alone(module):
    """The readers and assemblies, the row mesh's modules and the host
    allocator tuning import neither jax nor pflare_tpu, each on its
    own."""
    code = (
        "import json, importlib, sys\n"
        f"importlib.import_module('pflare_tpu_torch.{module}')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pflare_tpu')]\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_root_exports_cover_the_reference():
    """The package root exports every name the reference's root does
    (pflare_tpu/__init__.py), each a working object of the port, and the
    problems package every name of the reference's."""
    import pflare_tpu.problems as jprob
    import pflare_tpu_torch.problems as tprob

    assert set(pflare_tpu.__all__) <= set(pflare_tpu_torch.__all__)
    assert set(jprob.__all__) <= set(tprob.__all__)
    for name in pflare_tpu_torch.__all__:
        module = getattr(getattr(pflare_tpu_torch, name), "__module__",
                         "pflare_tpu_torch")     # C_POINT, F_POINT: ints
        assert module.startswith("pflare_tpu_torch"), name
    assert pflare_tpu_torch.read_gmsh is tprob.read_gmsh
    assert pflare_tpu_torch.ELL.__module__ == "pflare_tpu_torch.sparse.ell"
    assert pflare_tpu_torch.build_inverse.__module__ == \
        "pflare_tpu_torch.inverse.build"


def test_parallel_exports_cover_the_reference():
    """``pflare_tpu_torch.parallel`` exports the reference's 16 names
    (pflare_tpu/parallel/__init__.py), each an object of the port, and
    PCAIR's setup and solve_device take a mesh."""
    import inspect

    import pflare_tpu.parallel as jpar
    import pflare_tpu_torch.parallel as tpar

    assert len(jpar.__all__) == 16
    assert set(jpar.__all__) <= set(tpar.__all__)
    for name in jpar.__all__:
        obj = getattr(tpar, name)
        assert getattr(obj, "__module__", "pflare_tpu_torch").startswith(
            "pflare_tpu_torch"), name
    assert tpar.ROW_AXIS == jpar.ROW_AXIS
    for method in (pflare_tpu_torch.PCAIR.setup,
                   pflare_tpu_torch.PCAIR.solve_device):
        assert "mesh" in inspect.signature(method).parameters


# what the port's design puts in place of a public name of the reference
# (each checked to exist in the port): level-dict smoothers by the
# full-space ones, the per-level uploads by ``Hierarchy.to`` (which
# returns a ``DeviceHierarchy``), ``HaloELL.from_ell`` by the sharded
# container's ``from_op``, and the ELL-slot index arrays of a SpGEMM plan
# by the CSR-value tables of ``device_tables``
REPLACED_BY = {
    "air.smooth.f_smooth": "air.smooth.f_smooth_full",
    "air.smooth.c_smooth": "air.smooth.c_smooth_full",
    "air.Hierarchy.device_levels": "air.Hierarchy.to",
    "air.Hierarchy.device_dtype": "air.Hierarchy.to",
    "air.LevelData.to_device": "air.Hierarchy.to",
    "air.LevelData.device": "air.Hierarchy.to",
    "parallel.HaloELL.from_ell": "parallel.HaloELL.from_op",
    "sparse.SpGEMMPlan.a_slot": "sparse.SpGEMMPlan.device_tables",
    "sparse.SpGEMMPlan.b_slot": "sparse.SpGEMMPlan.device_tables",
    "sparse.SpGEMMPlan.out_pos": "sparse.SpGEMMPlan.device_tables",
}
# attributes an instance sets in __init__ (a property in the reference)
INSTANCE_ATTRIBUTES = {"inverse.Inverse.mat", "parallel.HaloELL.dtype"}
# ROADMAP's do-not-port list: ``DIA.make_fused`` has no call site
NOT_PORTED = {"sparse.DIA.make_fused"}
SUBPACKAGES = ["sparse", "inverse", "solvers", "air", "cf", "problems",
               "parallel", "utils.timers"]


def _resolve(dotted):
    """The port's object at ``pflare_tpu_torch.<dotted>`` (a module path,
    then attributes)."""
    import importlib

    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(
                "pflare_tpu_torch." + ".".join(parts[:i]))
        except ModuleNotFoundError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(dotted)


def _instance_attribute_holds(name):
    """Build a small instance of the class and read the attribute."""
    from pflare_tpu_torch.inverse import build_inverse
    from pflare_tpu_torch.parallel import HaloELL, make_mesh

    A = pflare_tpu_torch.adv_diff_2d(8)
    if name == "inverse.Inverse.mat":
        inv = build_inverse(A, pflare_tpu_torch.InverseType.ARNOLDI)
        return inv.to("cpu", torch.float64).mat is not None
    op = HaloELL.from_scipy(A, make_mesh(2, device="cpu"))
    return op.dtype == torch.float64


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_cover_the_reference(sub):
    """Every name the reference's sub-package exports (its ``__all__``, or
    a module's public definitions) is an object of the port's, and so is
    every public method of an exported class; or the port puts something
    else in its place (``REPLACED_BY``, checked to exist), sets it on its
    instances, or it is on ROADMAP's do-not-port list."""
    import importlib
    import inspect

    ref = importlib.import_module("pflare_tpu." + sub)
    port = importlib.import_module("pflare_tpu_torch." + sub)
    names = getattr(ref, "__all__", None) or [
        n for n, v in vars(ref).items() if not n.startswith("_")
        and getattr(v, "__module__", None) == ref.__name__]
    assert names
    short = sub.split(".")[0]
    missing = []
    for name in names:
        if not hasattr(port, name):
            missing.append(f"{sub}.{name}")
            continue
        obj = getattr(port, name)
        assert getattr(obj, "__module__", "pflare_tpu_torch").startswith(
            "pflare_tpu_torch"), name
        ref_obj = getattr(ref, name)
        if not inspect.isclass(ref_obj):
            continue
        for attr in vars(ref_obj):
            key = f"{short}.{name}.{attr}"
            if (attr.startswith("_") or attr.startswith("tree_")
                    or hasattr(obj, attr) or key in NOT_PORTED):
                continue
            if key in INSTANCE_ATTRIBUTES:
                assert _instance_attribute_holds(key), key
            elif key in REPLACED_BY:
                _resolve(REPLACED_BY[key])
            else:
                missing.append(key)
    assert missing == []


# parameters of the reference's public callables that the port's
# counterparts do not take, each with its reason ("sub.name" or
# "sub.Class.method", parameter)
SIGNATURE_EXEMPT = {
    # ROADMAP's do-not-port list: the TPU tile geometry, the banded
    # kernel's bf16 split precision and TPU tile rows, the numpy/jax
    # switch of the host coefficient builders
    ("sparse.DIA", "tr"): "do-not-port: the TPU tile geometry _fused_tr",
    ("sparse.BandedSpMV", "precision"): "do-not-port: the bf16 split mode",
    ("sparse.BandedSpMV.from_scipy", "precision"):
        "do-not-port: the bf16 split mode",
    ("sparse.BandedSpMV.from_scipy", "tile_rows"):
        "do-not-port: TPU tiles; the port's rows a tile are fixed",
    ("sparse.BandedSpMV.viable", "tile_rows"):
        "do-not-port: TPU tiles; the port's rows a tile are fixed",
    ("inverse.coefficients_power", "xp"): "do-not-port: the xp switch",
    ("inverse.coefficients_arnoldi", "xp"): "do-not-port: the xp switch",
    ("inverse.box_muller", "xp"): "do-not-port: the xp switch",
    ("inverse.arnoldi_host", "xp"): "do-not-port: the xp switch",
    ("inverse.newton_roots", "xp"): "do-not-port: the xp switch",
    # names the port replaced: vcycle_full lost its dead knobs, the
    # per-level uploads became Hierarchy.to
    ("air.vcycle_full", "pre"): "dead pre-smoothing knob removed",
    ("air.vcycle_full", "post"): "dead post-smoothing knob removed",
    ("air.Hierarchy", "_device_levels"): "replaced by Hierarchy.to",
    ("air.LevelData", "device"): "replaced by Hierarchy.to",
    # the port's own designs
    ("sparse.SpGEMMPlan.execute", "A"):
        "runs on CSR values and device tables (the device re-setup's halves)",
    ("sparse.SpGEMMPlan.execute", "B"):
        "runs on CSR values and device tables (the device re-setup's halves)",
    ("sparse.FixedSparsityPolyPlan.execute", "A"):
        "runs on CSR values and device tables (the device re-setup's halves)",
    ("inverse.Inverse", "meta"):
        "the reference's meta entries are the port's named fields",
    ("sparse.ELL.from_scipy", "pattern"):
        "no caller: the port's reuse paths set values by CSR value tables",
    ("sparse.TELL.from_scipy", "pattern"):
        "no caller: the port's reuse paths set values by CSR value tables",
    ("inverse.build_inverse", "A"):
        "builds from the host matrix alone, the reference's A_scipy",
    ("parallel.HaloELL", "data"): "holds one container a shard",
    ("parallel.HaloELL", "lcols"): "holds one container a shard",
    ("parallel.HaloELL", "n"): "holds one container a shard",
    ("utils.timers.device_sync_read", "x"):
        "takes the tensors themselves (*tensors), not one pytree",
    # unused in the reference (pflare_tpu/solvers/krylov.py:44-45)
    ("solvers.richardson", "norm_type"): "unused in the reference",
}


def _exported_callables(sub):
    """(key, reference callable, port callable) of each public name the
    reference's sub-package exports and the port has, and of each public
    method of an exported class."""
    import importlib
    import inspect

    ref = importlib.import_module("pflare_tpu." + sub)
    port = importlib.import_module("pflare_tpu_torch." + sub)
    names = getattr(ref, "__all__", None) or [
        n for n, v in vars(ref).items() if not n.startswith("_")
        and getattr(v, "__module__", None) == ref.__name__]
    for name in names:
        if not hasattr(port, name):
            continue
        r, p = getattr(ref, name), getattr(port, name)
        if callable(r) and callable(p):
            yield f"{sub}.{name}", r, p
        if inspect.isclass(r):
            for attr in vars(r):
                if attr.startswith("_") or not hasattr(p, attr):
                    continue
                rv, pv = getattr(r, attr), getattr(p, attr)
                if inspect.isroutine(rv) and inspect.isroutine(pv):
                    yield f"{sub}.{name}.{attr}", rv, pv


def _params(fn):
    import inspect

    try:
        return list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return None


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_exported_callables_take_the_reference_parameters(sub):
    """Each public callable a sub-package exports (and each public method
    of an exported class) takes every parameter name of the reference's,
    or the gap is in ``SIGNATURE_EXEMPT`` with its reason."""
    gaps = []
    for key, ref_fn, port_fn in _exported_callables(sub):
        want, have = _params(ref_fn), _params(port_fn)
        if want is None or have is None:
            continue
        gaps += [f"{key}({name})" for name in want
                 if name not in have and (key, name) not in SIGNATURE_EXEMPT]
    assert gaps == []


def test_signature_exemptions_are_needed():
    """Every exemption names a parameter the reference takes and the port
    does not, so the table shrinks when the port catches up; PCAIR takes
    the reference's ``jit``."""
    found = {}
    for sub in SUBPACKAGES:
        for key, ref_fn, port_fn in _exported_callables(sub):
            found[key] = (_params(ref_fn) or [], _params(port_fn) or [])
    for (key, name), reason in SIGNATURE_EXEMPT.items():
        want, have = found[key]
        assert name in want and name not in have, (key, name, reason)
    assert "jit" in found["air.PCAIR"][1]


def test_replaced_names_have_counterparts():
    """Each name of ``REPLACED_BY`` is gone from the port and its
    counterpart is there; the replaced module functions exist in the
    reference."""
    import pflare_tpu.air.smooth as jsmooth

    for old, new in REPLACED_BY.items():
        assert callable(_resolve(new)), new
        *where, attr = old.split(".")
        assert not hasattr(_resolve(".".join(where)), attr), old
    assert callable(jsmooth.f_smooth) and callable(jsmooth.c_smooth)


TWIN_DIRS = (os.path.join(REPO, "examples", "torch"),
             os.path.join(REPO, "notebooks", "torch"))


def _twin_files():
    return sorted(os.path.join(d, f) for d in TWIN_DIRS
                  for f in os.listdir(d) if f.endswith(".py"))


def test_twins_leave_jax_out():
    """Every example and notebook twin imports only the port, torch,
    numpy, scipy and the standard library: no jax, no pflare_tpu (read
    from each file's import statements), and importing the 8 examples in
    a fresh interpreter loads neither."""
    import ast

    allowed = {"pflare_tpu_torch", "torch", "numpy", "scipy", "argparse",
               "os", "sys", "time", "tempfile"}
    files = _twin_files()
    assert len(files) == 14
    for path in files:
        tree = ast.parse(open(path).read(), path)
        tops = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops.add(node.module.split(".")[0])
        assert tops <= allowed, (path, tops - allowed)
    code = (
        "import importlib.util, json, os, sys\n"
        f"d = {TWIN_DIRS[0]!r}\n"
        "for f in sorted(os.listdir(d)):\n"
        "    spec = importlib.util.spec_from_file_location(f[:-3], "
        "os.path.join(d, f))\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pflare_tpu')]\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_tune_host_malloc_is_idempotent():
    """``tune_host_malloc`` returns a bool, and the same one again."""
    from pflare_tpu_torch.utils.hostmem import tune_host_malloc

    first = tune_host_malloc()
    assert isinstance(first, bool)
    assert tune_host_malloc() is first


def test_compiled_sources_lie_inside_the_port():
    """Every source the port compiles or opens at runtime is its own: the
    host C++ kernels and the CUDA sources, none of the JAX package's."""
    pkg = os.path.realpath(os.path.dirname(pflare_tpu_torch.__file__))
    paths = [native.SOURCE, cuda.CSRC]
    paths += [os.path.join(cuda.CSRC, name + ".cu") for name in cuda.KERNELS]
    for path in paths:
        path = os.path.realpath(path)
        assert os.path.commonpath([pkg, path]) == pkg, path
        assert os.path.exists(path), path
    # the twins name no source or file of the JAX package
    for path in _twin_files():
        text = open(path).read()
        assert "pflare_tpu/" not in text and ".cpp" not in text, path
        assert ".cu" not in text.replace(".cuda", ""), path


def test_generators_match_reference_bitwise():
    for n in (25, 64):
        A, B = pflare_tpu.adv_diff_2d(n), pflare_tpu_torch.adv_diff_2d(n)
        for attr in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(A, attr), getattr(B, attr))
    A = pflare_tpu.random_diag_dominant(300, 0.02, seed=11)
    B = pflare_tpu_torch.random_diag_dominant(300, 0.02, seed=11)
    assert (A != B).nnz == 0
    assert np.array_equal(A.data, B.data)


_GENERATORS = {
    "adv_1d": [(30,)],
    "adv_diff_3d": [(10,), (7, 6, 5), dict(nx=6, alpha=1.0),
                    dict(nx=6, curved_velocity=True)],
    "anisotropic_diffusion_2d": [(24, 1e-3), dict(nx=12, theta=0.4)],
    "dg_upwind_advection_unstructured": [(24,), dict(
        n_side=16, curved_velocity=True)],
}


@pytest.mark.parametrize("name", list(_GENERATORS))
def test_option_generators_match_reference_bitwise(name):
    """The generators of the AIR option tests, bit for bit with the
    reference's (the port vectorises the loops of adv_diff_3d and
    anisotropic_diffusion_2d)."""
    for args in _GENERATORS[name]:
        kw = args if isinstance(args, dict) else {}
        pos = () if isinstance(args, dict) else args
        A = getattr(pflare_tpu.problems, name)(*pos, **kw)
        B = getattr(pflare_tpu_torch, name)(*pos, **kw)
        assert A.shape == B.shape
        for attr in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(A, attr), getattr(B, attr)), args


# each module of the approximate-inverse slice, driven alone in a fresh
# interpreter with the build directory empty and the compiler recorded
# (every compile "fails", so the host kernels fall back to numpy)
_SLICE_JOBS = {
    "pflare_tpu_torch.pcpflareinv": (
        "pc = m.PCPFLAREINV(dtype=torch.float64, device='cpu')\n"
        "pc.setup(adv_diff_2d(16)).solve(np.ones(256), max_it=5)\n"),
    "pflare_tpu_torch.inverse.sai": (
        "m.sai_inverse(adv_diff_2d(8), incomplete=False)\n"),
    "pflare_tpu_torch.sparse.spgemm": (
        "from pflare_tpu_torch.sparse import SparsityPattern\n"
        "A = adv_diff_2d(8)\n"
        "m.FixedSparsityPolyPlan(SparsityPattern(A.indptr, A.indices, "
        "A.shape), 3, 2).execute_host(A, np.ones(4))\n"),
    "pflare_tpu_torch.cf.aggregation": (
        "from pflare_tpu_torch.cf import strength_matrix\n"
        "m.serial_aggregation(strength_matrix(adv_diff_2d(8), 0.5))\n"),
    "pflare_tpu_torch.cf.cr": (
        "m.cr_pass(adv_diff_2d(8), -np.ones(64, dtype=np.int64), 0.1)\n"),
    "pflare_tpu_torch.air.constrain": (
        "A = adv_diff_2d(8)\n"
        "v = [np.ones(64)]\n"
        "m.smooth_near_nullspace(A, v, None)\n"
        "m.constrain_grid_transfer(A[:, :20].tocsr(), v, [np.ones(20)], "
        "False)\n"),
    "pflare_tpu_torch.air.stats": (
        "from pflare_tpu_torch import PCAIR, AIROptions\n"
        "pc = PCAIR(AIROptions().replace(smooth_order='fcf', z_type='LAIR', "
        "cf_splitting_type='PMIS_AGG'), dtype=torch.float64, "
        "device='cpu').setup(adv_diff_2d(16))\n"
        "m.compute_stats(pc.hierarchy)\n"
        "pc.solve(np.ones(256), ksp='fgmres', max_it=5)\n"),
    "pflare_tpu_torch.air.device_resetup": (
        "from pflare_tpu_torch import PCAIR, AIROptions\n"
        "A = adv_diff_2d(16)\n"
        "pc = PCAIR(AIROptions().replace(reuse_sparsity=True, "
        "reuse_amount=3, z_type='LAIR'), dtype=torch.float64, "
        "device='cpu').setup(A)\n"
        "pc.build_device_resetup().install(pc, A * 1.01)\n"
        "pc.solve(np.ones(256), max_it=5)\n"),
    "pflare_tpu_torch.parallel.repartition": (
        "A = adv_diff_2d(24)\n"
        "p = np.random.default_rng(0).permutation(576)\n"
        "m.coarse_repartition_perm(A[p][:, p])\n"),
}


@pytest.mark.parametrize("module", list(_SLICE_JOBS))
def test_slice_module_stands_alone(module):
    """Importing and running the module pulls in neither jax nor
    pflare_tpu, and every source it would compile lies inside the port."""
    code = (
        "import importlib, json, subprocess, sys, tempfile\n"
        "import numpy as np, torch\n"
        "calls, real_run = [], subprocess.run\n"
        "def fake_run(cmd, *a, **k):\n"
        "    if not any(str(c).endswith(('.cpp', '.cu')) for c in cmd):\n"
        "        return real_run(cmd, *a, **k)\n"
        "    calls.append([str(c) for c in cmd])\n"
        "    raise subprocess.CalledProcessError(1, cmd)\n"
        "subprocess.run = fake_run\n"
        "from pflare_tpu_torch import native\n"
        "native.BUILD_DIR = tempfile.mkdtemp()\n"
        f"m = importlib.import_module({module!r})\n"
        "from pflare_tpu_torch.problems import adv_diff_2d\n"
        + _SLICE_JOBS[module] +
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'pflare_tpu')]\n"
        "srcs = [a for c in calls for a in c if a.endswith(('.cpp', '.cu'))]\n"
        "print(json.dumps({'bad': bad, 'srcs': srcs}))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("PFLARE_NO_NATIVE", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    if module.endswith(("pcpflareinv", "stats", "device_resetup")):
        assert got["srcs"]            # the setup asked for the host kernels
    pkg = os.path.realpath(os.path.dirname(pflare_tpu_torch.__file__))
    for src in got["srcs"]:
        assert os.path.commonpath([pkg, os.path.realpath(src)]) == pkg, src
