"""The harness end to end on the CPU at tiny sizes, the shape of its
result, and the command's refusals."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import CELLS, ROOT, tiny_spec
from solverbench import harness

SEED = 2**31 + 11


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_tiny_cell_end_to_end(workload, traced):
    spec = tiny_spec(workload)
    res = harness.run_cell(spec, SEED, 0.5, traced, "cpu")
    assert list(res)[0] == "correct" and list(res)[-1] == "checks"
    assert res["correct"] is True
    assert res["attempted"] >= 1 and res["failed"] == 0
    wanted = spec["per_layer"] if traced else spec["end_to_end"]
    # the CPU has no device trace: the readers of it find nothing
    card_only = {m["name"] for m in wanted if m["source"] == "device_trace"}
    assert set(res["metrics"]) == {m["name"] for m in wanted} - card_only
    for m in wanted:
        if m["name"] in res["metrics"]:
            got = res["metrics"][m["name"]]
            assert got["unit"] == m["unit"] and np.isfinite(got["value"])
    check = res["checks"]["max_rel_residual"]
    assert 0 < check["value"] <= check["limit"]
    assert res["checks"]["unconverged"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("workload", CELLS)
def test_same_seed_same_inputs(workload):
    spec = tiny_spec(workload)
    a = harness.Cell(spec, SEED, "cpu")
    b = harness.Cell(spec, SEED, "cpu")
    for _ in range(2):
        ra, (xa, ba) = a.request()
        rb, (xb, bb) = b.request()
        assert np.array_equal(ba.numpy(), bb.numpy())
        assert np.array_equal(xa.numpy(), xb.numpy())


@pytest.mark.parametrize("workload", CELLS)
def test_operator_is_read_back_from_the_cache(workload, tmp_path):
    """A cell's first run saves its operator, later runs read back the
    same matrix; other arguments are another file."""
    problem = tiny_spec(workload)["config"]["problem"]
    made = harness.operator(problem)
    first = harness.operator(problem, str(tmp_path))
    files = sorted(p.name for p in tmp_path.iterdir())
    again = harness.operator(problem, str(tmp_path))
    assert len(files) == 1 and files[0].endswith(".npz")
    assert sorted(p.name for p in tmp_path.iterdir()) == files
    for A in (first, again):
        assert type(A) is type(made) and A.dtype == made.dtype
        assert np.array_equal(A.indptr, made.indptr)
        assert np.array_equal(A.indices, made.indices)
        assert np.array_equal(A.data, made.data)
    key = next(iter(problem["args"]))
    other = dict(problem, args=dict(problem["args"],
                                    **{key: problem["args"][key] + 1}))
    harness.operator(other, str(tmp_path))
    assert len(list(tmp_path.iterdir())) == 2


def test_reservoir_keeps_a_seeded_sample():
    picks = []
    for _ in range(2):
        r = harness.Reservoir(4, np.random.default_rng(3))
        for i in range(100):
            r.offer(i)
        picks.append(r.items)
    assert picks[0] == picks[1] and len(set(picks[0])) == 4


def test_every_cell_has_its_files_and_metrics():
    b = bench()
    for cell in b["workloads"]:
        spec = harness.load_spec(cell["name"])
        e2e = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec["per_layer"]
        assert spec["checks"]["max_rel_residual"]["limit"] > 0
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "solverbench/run.py", "--workload",
         "adv_diff_fd_3072.rhs", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_command_refuses_without_the_program(tmp_path):
    """A checkout of the benchmark's files alone prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "solverbench"),
                    tmp_path / "solverbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "solverbench/run.py", "--workload",
         "adv_diff_fd_3072.rhs", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_fd_rhs_cell_on_card(card):
    out = subprocess.run(
        [sys.executable, "solverbench/run.py", "--workload",
         "adv_diff_fd_3072.rhs", "--seed", str(SEED), "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"


def test_a_generator_can_come_as_a_file_of_its_own(tmp_path, monkeypatch):
    (tmp_path / "generators").mkdir()
    (tmp_path / "generators" / "probe_grid.py").write_text(
        "from solverbench import problems\n\n\n"
        "def generate(n):\n    return problems.adv_diff_2d(n)\n")
    monkeypatch.setattr(harness, "BENCH", str(tmp_path))
    A = harness.generator("probe_grid")(n=8)
    assert (A != harness.problems.adv_diff_2d(8)).nnz == 0
    assert harness.generator("adv_diff_2d") is harness.problems.adv_diff_2d

