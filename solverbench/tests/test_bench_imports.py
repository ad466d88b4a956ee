"""Nothing the run command loads is JAX or the JAX package, and the
reference loads nothing of the program.  Top-level names are compared
whole: the program's name, pflare_tpu_torch, begins with the JAX
package's."""

import ast
import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT
from solverbench import harness

BENCH = os.path.join(ROOT, "solverbench")


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pflare_tpu_torch_probe", sys)
    assert "pflare_tpu_torch_probe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pflare_tpu.probe", sys)
    assert "pflare_tpu.probe" in harness.forbidden_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Every module that a run of each cell (set-up, window, traced
    segment, judgement) and the command's own modules import."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"sys.path.insert(0, {os.path.join(BENCH, 'tests')!r})\n"
        "import solverbench.run, solverbench.calibrate\n"
        "from conftest import CELLS, tiny_spec\n"
        "from solverbench import harness\n"
        "for w in CELLS:\n"
        "    for traced in (False, True):\n"
        "        harness.run_cell(tiny_spec(w), 3, 0.2, traced, 'cpu')\n"
        "import pflare_tpu_torch.cuda\n"
        "print(json.dumps([m for m in sys.modules\n"
        "                  if m.split('.')[0] in\n"
        "                  ('jax', 'jaxlib', 'flax', 'pflare_tpu')]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def benchmark_sources():
    for d, _, files in os.walk(BENCH):
        if "tests" in d.split(os.sep) or "__pycache__" in d:
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(benchmark_sources()))
def test_no_source_imports_jax(path):
    assert not imported_roots(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("name", ["reference.py", "problems.py",
                                  "roofline.py"])
def test_the_yardstick_imports_nothing_of_the_program(name):
    roots = imported_roots(os.path.join(BENCH, name))
    assert roots <= {"__future__", "numpy", "scipy"}, roots
