"""The control of ``correct``, at a size a test run holds: the plain
reference put in the program's place and computed with TF32 operands (the
precision below the configuration's float32) fails each cell's limits,
while the program passes them, on three seeds."""

from __future__ import annotations

import importlib
import json

import pytest
import torch

from gsbench import control
from gsbench.run import Run, load_manifest
from gsbench.tests.tiny import REPO, tiny_root

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_fails_the_limits(cell, tmp_path):
    torch.set_num_threads(4)
    root = tiny_root(tmp_path)
    manifest = load_manifest(root)
    limits = json.loads((root / "gsbench" / "limits" / f"{cell}.json").read_text())
    entry = next(w for w in manifest["workloads"] if w["name"] == cell)
    for seed in (1, 2, 3):
        run = Run(root, manifest, entry, seed, torch.device("cpu"))
        driver = importlib.import_module(f"gsbench.drivers.{run.traffic['driver']}").DRIVER(run)
        driver.setup()
        driver.window(1.0)
        driver.check_stretch()
        driver.release()
        out = control.readings(driver, True)
        assert all(out["program"][k] <= v for k, v in limits.items()), out["program"]
        assert any(out["tf32"][k] > v for k, v in limits.items()), out["tf32"]
