"""Every cell of ``BENCHMARK.json`` run end to end on the CPU at a tiny
size (:mod:`gsbench.tests.tiny`), through the plain twins of the
program's kernels: the result line is well formed and correct; and the
command refuses, printing nothing, without a card or without the
program beside the benchmark."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from gsbench import run as grun
from gsbench.tests.tiny import REPO, tiny_root

MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _expected(cell: str, trace: int):
    group = "per_layer" if trace else "end_to_end"
    return {m["name"] for m in MANIFEST[group]
            if cell in m.get("workloads", [cell])}


def _check_line(res: dict, cell: str, trace: int) -> None:
    assert list(res)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in res
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    units = {m["name"]: m["unit"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]}
    assert set(res["metrics"]) <= _expected(cell, trace)
    for name, m in res["metrics"].items():
        assert m["unit"] == units[name]
        assert m["value"] == m["value"]  # not NaN
    if not trace:
        assert set(res["metrics"]) == _expected(cell, trace)
        assert all(m["value"] > 0 for m in res["metrics"].values())
    else:
        assert "busy_s" in res["device"] and "window_s" in res["device"]
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(res)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_cpu(cell, tmp_path):
    root = tiny_root(tmp_path)
    res = grun.run(["--workload", cell, "--seed", "4294967311", "--seconds", "1",
                    "--trace", "0"], root=root, allow_cpu=True)
    _check_line(res, cell, 0)


@pytest.mark.parametrize("cell", ["train.gs-1spp-15k", "render.gs-1spp-30k"])
def test_traced_cell_runs_on_the_cpu(cell, tmp_path):
    root = tiny_root(tmp_path)
    res = grun.run(["--workload", cell, "--seed", "7", "--seconds", "0.5",
                    "--trace", "1"], root=root, allow_cpu=True)
    _check_line(res, cell, 1)
    # on the CPU the trace holds no device event: only the work-based
    # metric reads anything
    assert set(res["metrics"]) <= {"mfu.train", "mfu.render"}


def test_same_seed_same_inputs(tmp_path):
    import torch

    from gsbench import scene as gscene

    cfg = json.loads((tiny_root(tmp_path) / "gsbench/configs/gs-1spp-15k.json").read_text())
    cap = gscene.capture(cfg, torch.device("cpu"))
    a = gscene.draw_scene(cfg, cap, 2 ** 31 + 5, torch.device("cpu"))
    b = gscene.draw_scene(cfg, cap, 2 ** 31 + 5, torch.device("cpu"))
    c = gscene.draw_scene(cfg, cap, 2 ** 31 + 6, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["means"], c["means"])
    assert int(a["alive"].sum()) == int(c["alive"].sum()) == cfg["alive"]


def test_refuses_without_a_card(tmp_path):
    if _has_cuda():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "gsbench.run", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "gsbench", tmp_path / "gsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); from gsbench import run; "
            f"print(run.run(['--workload', {CELLS[0]!r}, '--seed', '1', "
            "'--seconds', '1'], allow_cpu=True))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "gstk_torch" in proc.stderr
    assert proc.stdout.strip() == ""


def _has_cuda() -> bool:
    import torch

    return torch.cuda.is_available()


@pytest.fixture
def card():
    if not _has_cuda():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    proc = subprocess.run(
        [sys.executable, "-m", "gsbench.run", "--workload", cell, "--seed", "5",
         "--seconds", "2", "--trace", "0"], cwd=REPO, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
