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
                                    "problems.fem_dg", "problems.fem_supg"])
def test_problem_modules_stand_alone(module):
    """The readers and assemblies import neither jax nor pflare_tpu, each
    on its own."""
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
