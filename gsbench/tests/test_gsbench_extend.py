"""A later change adds a configuration, a traffic mix and a per-layer
metric as new files and manifest entries only; the harness runs the new
cell as it stands."""

from __future__ import annotations

import json

from gsbench import run as grun
from gsbench.tests.tiny import tiny_root


def test_new_files_and_entries_make_a_new_cell(tmp_path):
    root = tiny_root(tmp_path)
    g = root / "gsbench"
    cfg = json.loads((g / "configs" / "gs-1spp-30k.json").read_text())
    cfg.update(alive=2500, bands=1)
    (g / "configs" / "dummy-config.json").write_text(json.dumps(cfg))
    (g / "traffic" / "dummy_traffic.json").write_text(json.dumps(
        {"driver": "render", "clients": 1, "orbit": 4, "warmup": 1,
         "checked": 2, "trace_requests": 3}))
    (g / "metrics" / "dummy_requests.render.py").write_text(
        "def read(ctx):\n    return float(ctx.iterations)\n")
    (g / "limits" / "dummy.cell.json").write_text(
        (g / "limits" / "render.gs-1spp-30k.json").read_text())
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "dummy-config", "source": "https://arxiv.org/abs/2308.04079",
                                "file": "gsbench/configs/dummy-config.json",
                                "reduced": [], "why": "a test"})
    manifest["workloads"].append({"name": "dummy.cell", "config": "dummy-config",
                                  "traffic": "dummy_traffic", "chips": 1, "why": "a test"})
    for m in manifest["end_to_end"]:
        if "render.gs-1spp-30k" in m.get("workloads", []):
            m["workloads"].append("dummy.cell")
    manifest["per_layer"].append({"name": "dummy_requests.render", "unit": "requests",
                                  "better": "higher", "source": "host_clock",
                                  "layer": "renderer", "moves": "render_fps",
                                  "workloads": ["dummy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    res = grun.run(["--workload", "dummy.cell", "--seed", "9", "--seconds", "0.5",
                    "--trace", "0"], root=root, allow_cpu=True)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"render_fps", "render_p95_ms", "setup_s"}
    res = grun.run(["--workload", "dummy.cell", "--seed", "9", "--seconds", "0.5",
                    "--trace", "1"], root=root, allow_cpu=True)
    assert res["correct"] is True
    assert res["metrics"]["dummy_requests.render"] == {"value": 3.0, "unit": "requests"}
