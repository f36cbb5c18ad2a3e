"""The reference's round-2 run (``tools/run_15k.sh``, ``docs/RESULTS_15K.md``)
through the port's ``quality_workflow --capture 1spp --n-views 64``, on
the CPU at a small size.

* the capture: ``raytraced64`` (the serial generator, 64 views) at 64x64
  equal to gstk_tpu's generator bit for bit (decoded PNGs,
  ``transforms.json`` and ``sparse.ply`` bytes), as
  ``tests/test_torch_quality_tools.py`` holds the 240-view one;
* the gs-train arguments equal as text to ``tools/run_15k.sh``'s launch,
  parsed from the script (the data and run paths aside), and the co-gs
  smoke's to the recipe plus the doc's ``--model.use-depth-loss True``;
* the names: ``eval_64_torch.json`` in ``runs_64``, which never resumes a
  240-view checkpoint; the probe's ``runs_64_fullmat``;
* ``gstk_torch/tools/published/results_15k.json`` equal to the numbers of
  ``docs/RESULTS_15K.md``, parsed from the doc, and its training curve to
  ``docs/metrics_15k.jsonl.gz``'s rows;
* a CPU rehearsal (64 views at 64x64, 40 steps in two stretches standing
  for 7500 each, then the downstream stage, and a 20-step co-gs smoke)
  runs to rc 0 with gs-eval equal to the trainer's eval bit for bit and
  the report and counts in place.
"""

import gzip
import json
import os
import re
import shlex
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gstk_torch.tools import quality_workflow, run_quality
from gstk_torch.utils.io import read_png

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
DOC = REPO / "docs" / "RESULTS_15K.md"
PUBLISHED = REPO / "gstk_torch" / "tools" / "published" / "results_15k.json"
SMALL = dict(n_views=64, img_wh=(64, 64), seed_points=800)


def _same_files(a: Path, b: Path) -> list:
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*")
                           if p.is_file())
    return [str(f) for f in files if (
        not np.array_equal(read_png(a / f), read_png(b / f))
        if f.suffix == ".png" else (a / f).read_bytes() != (b / f).read_bytes())]


def test_raytraced64_is_the_reference_capture(tmp_path):
    from gstk_tpu.data.raytraced import generate_raytraced_dataset

    ref = Path(generate_raytraced_dataset(tmp_path / "ref" / "raytraced64",
                                          **SMALL))
    data, done = quality_workflow.prepare_data(
        tmp_path / "port", "1spp", False, SMALL["n_views"], SMALL["img_wh"],
        SMALL["seed_points"], "cpu")
    assert data == tmp_path / "port" / "raytraced64"
    assert not _same_files(ref, data)
    assert len(list((data / "images").iterdir())) == 64
    # the generator's defaults are run_15k.sh's capture
    text = (REPO / "tools" / "run_15k.sh").read_text()
    default = re.search(r"DATA=\$\{1:-(\S+)\}", text).group(1)
    assert Path(default).name == data.name
    assert "64 views at 800×800 with a 160k-point" in " ".join(
        DOC.read_text().split())


def _run_15k_argv(data: str, out: str) -> list:
    """gs-train's arguments of ``tools/run_15k.sh``'s launch, the shell's
    variables substituted."""
    text = (REPO / "tools" / "run_15k.sh").read_text()
    body = text[text.index("scripts.train gaussian-splatting"):
                text.index("--data-parallel off &") + len("--data-parallel off")]
    body = body.replace("\\\n", " ").replace('${extra[@]+"${extra[@]}"}', "")
    body = body.replace('"$DATA"', data).replace('"$OUT"', out)
    return shlex.split(body)[1:]  # "scripts.train"


def _workflow_argv(tmp_path, monkeypatch, flags, extra=()):
    calls = []

    def python_m(module, argv, log=None):
        calls.append((module, argv))
        return 0 if module == "gstk_torch.scripts.train" else 1

    monkeypatch.setattr(quality_workflow, "_python_m", python_m)
    with pytest.raises(SystemExit, match="gs-eval failed"):
        quality_workflow.main([
            "--device", "cpu", "--capture", "1spp", "--n-views", "64",
            "--work-dir", str(tmp_path), "--out-dir", str(tmp_path / "report"),
            "--width", "64", "--height", "64", "--seed-points", "800",
            *flags, "--", *extra])
    (module, argv), _ = calls
    assert module == "gstk_torch.scripts.train"
    return argv


def test_train_arguments_are_run_15k_sh(tmp_path, monkeypatch):
    argv = _workflow_argv(tmp_path, monkeypatch, ["--first-stretch", "15000"])
    data, runs = tmp_path / "raytraced64", tmp_path / "runs_64"
    assert argv == ["--device", "cpu", *_run_15k_argv(str(data), str(runs))]
    # run_15k.sh's flags are run_quality.sh's recipe
    assert argv[2:] == run_quality.recipe_flags(data, runs,
                                                "gaussian-splatting", 15000)


def test_cogs_smoke_arguments(tmp_path, monkeypatch):
    extra = ["--model.use-depth-loss", "True"]
    argv = _workflow_argv(tmp_path, monkeypatch,
                          ["--method", "co-gs", "--iters", "1500"], extra)
    runs = tmp_path / "runs_64_cogs"
    assert argv == ["--device", "cpu", *run_quality.recipe_flags(
        tmp_path / "raytraced64", runs, "co-gs", 1500), *extra]
    assert "`co-gs` with sensor-depth supervision (`--model.use-depth-loss " \
        "True`" in " ".join(DOC.read_text().split())


def test_names_of_the_64_view_run():
    name = lambda method="gaussian-splatting", n=64: quality_workflow.config_name(
        "1spp", method, False, [], 15000, n)
    assert name() == "64" and name("co-gs") == "64_cogs"
    assert name(n=240) == "240"  # the 240-view names are unchanged
    assert quality_workflow.data_name("1spp", False, 64) == "raytraced64"
    assert quality_workflow.data_name("ss3", True) == "raytraced240_ss3_mono"
    assert quality_workflow.runs_name("64", 7500) == "runs_64"
    assert quality_workflow.runs_name("64", 20) == "runs_64_stretch20"


def test_64_view_run_never_resumes_a_240_view_checkpoint(tmp_path, monkeypatch):
    """A work directory that holds a 240-view run's checkpoint: the 64-view
    workflow trains in its own ``runs_64`` from step 0."""
    for runs in ("runs_240", "runs_64_cogs"):
        ckpts = tmp_path / runs / "raytraced240" / "gaussian-splatting" / "ckpts"
        ckpts.mkdir(parents=True)
        (ckpts / "step-000015000.ckpt.npz").touch()
    argv = _workflow_argv(tmp_path, monkeypatch, ["--first-stretch", "15000"])
    assert "--load-dir" not in argv
    assert argv[argv.index("--output-dir") + 1] == str(tmp_path / "runs_64")
    assert argv[argv.index("--experiment-name") + 1] == "raytraced64"


def test_results_15k_json_is_the_doc():
    doc, pub = DOC.read_text(), json.loads(PUBLISHED.read_text())
    lines = doc.splitlines()
    vanilla, cogs = pub["configs"]["64"], pub["configs"]["64_cogs"]
    psnr = re.search(r"\| eval PSNR \| ([\d.]+) \| \*\*([\d.]+)\*\* \|", doc)
    ssim = re.search(r"\| eval SSIM \| ([\d.]+) \| \*\*([\d.]+)\*\* \|", doc)
    assert vanilla["results"] == {"psnr": float(psnr.group(2)),
                                  "ssim": float(ssim.group(2))}
    assert vanilla["curve"] == {
        "7500": [float(psnr.group(1)), float(ssim.group(1))],
        "15000": [float(psnr.group(2)), float(ssim.group(2))]}
    assert "eval PSNR" in lines[25] and "eval SSIM" in lines[26]  # lines 26-27
    fresh = re.search(r"\(([\d.]+) / ([\d.]+)\) when loaded by a fresh", doc)
    assert vanilla["fresh_process_eval"]["psnr"] == float(fresh.group(1))
    assert fresh.group(1) in lines[vanilla["fresh_process_eval"]["line"] - 1]
    rows = {m.group(1): [float(m.group(2)), float(m.group(3).strip("*")),
                         int(m.group(4).replace(",", "")),
                         int(m.group(5).replace(",", ""))]
            for m in re.finditer(r"^\| (\d+) \| ([\d.]+) \| ([*\d.]+) \| "
                                 r"([\d,]+) \| ([\d,]+) \|$", doc, re.M)}
    assert vanilla["training"]["rows"] == rows and len(rows) == 11
    down = vanilla["downstream"]
    n = re.search(r"gaussian-splat` — ([\d,]+) Gaussians", doc).group(1)
    assert down["gaussian_splat"]["gaussians"] == int(n.replace(",", ""))
    assert re.search(r"all (\d+) training views", doc).group(1) == "56"
    assert down["render_pose"]["views"] == 56
    v, f = re.search(r"(\d+)k-vertex / (\d+)k-face mesh", doc).groups()
    assert (down["tsdf_tetra"]["vertices"], down["tsdf_tetra"]["faces"]) == (
        int(v) * 1000, int(f) * 1000)
    for entry in down.values():
        assert any(ch.isdigit() for ch in lines[entry["line"] - 1])
    steps, p, s = re.search(r"([\d,]+) steps reach \*\*eval PSNR ([\d.]+) / "
                            r"SSIM ([\d.]+)\*\*", doc).groups()
    assert cogs["results"] == {"psnr": float(p), "ssim": float(s)}
    assert cogs["iters"] == int(steps.replace(",", ""))


def test_results_15k_train_curve_is_the_metrics():
    pub = json.loads(PUBLISHED.read_text())["configs"]["64"]["train_curve"]
    rows = [json.loads(l) for l in gzip.open(REPO / "docs" / "metrics_15k.jsonl.gz")]
    train = [r for r in rows if "num_alive" in r]
    want = {str(r["step"]): r for r in train if r["step"] % 1000 == 0}
    want[str(train[-1]["step"])] = train[-1]
    assert list(pub["rows"]) == list(want) and len(want) == 16
    for step, ref in want.items():
        got = pub["rows"][step]
        assert got == {"num_alive": int(ref["num_alive"]),
                       "num_intersects": int(ref["num_intersects"]),
                       "psnr": ref["psnr"], "loss": ref["loss"]}, step


def test_published_entries_by_name():
    ours = {"psnr": 21.0, "ssim": 0.9}
    d = quality_workflow.published_diff(ours, PUBLISHED, "64")
    assert d["d_psnr"] == pytest.approx(21.0 - 20.11) and "ring_means" not in d
    assert d["method_name"] == "gaussian-splatting"
    d = quality_workflow.published_diff(ours, PUBLISHED, "64_cogs")
    assert d["psnr"] == 20.09 and d["method_name"] == "co-gs"
    assert quality_workflow.published_curve(PUBLISHED, 7500, "64") == (20.43, 0.8632)
    assert quality_workflow.published_curve(PUBLISHED, 1500, "64_cogs") is None
    with pytest.raises(SystemExit, match="not 240"):
        quality_workflow.published_entry(PUBLISHED, "240")
    # a gs-eval JSON of the reference still reads as before
    assert quality_workflow.published_curve(
        REPO / "eval_240_30k.json", 7500) == (22.809, 0.9083)


def test_probe_names_the_64_view_run(tmp_path, monkeypatch):
    from gstk_torch.scripts import train as train_cli
    from gstk_torch.tools import tpu_precision_probe as probe

    seen = []

    def train(argv):
        seen.append(argv)
        raise RuntimeError("stop here")

    monkeypatch.setattr(train_cli, "main", train)
    with pytest.raises(RuntimeError, match="stop here"):
        probe.main(["--rounded", "fullmat", "--capture", "1spp", "--n-views",
                    "64", "--size", "64", "--seed-points", "800",
                    "--work-dir", str(tmp_path), "--out-dir",
                    str(tmp_path / "r"), "--device", "cpu"])
    (argv,) = seen
    assert argv[argv.index("--data") + 1] == str(tmp_path / "raytraced64")
    assert argv[argv.index("--output-dir") + 1] == str(tmp_path / "runs_64_fullmat")


def test_ply_counts(tmp_path):
    from gstk_torch.exporter.tsdf import write_mesh_ply

    verts = np.random.default_rng(0).normal(size=(7, 3)).astype(np.float32)
    faces = np.array([[0, 1, 2], [2, 3, 4]], np.int32)
    write_mesh_ply(tmp_path / "m.ply", verts, faces,
                   np.zeros((7, 3), np.uint8))
    assert quality_workflow.ply_counts(tmp_path / "m.ply") == {"vertex": 7,
                                                               "face": 2}


def _rehearse(tmp_path, flags, extra=()):
    out = tmp_path / "report"
    proc = subprocess.run(
        [sys.executable, "-m", "gstk_torch.tools.quality_workflow", "--device",
         "cpu", "--capture", "1spp", "--n-views", "64", "--width", "64",
         "--height", "64", "--seed-points", "800", "--work-dir", str(tmp_path),
         "--out-dir", str(out), "--published", str(PUBLISHED), *flags, "--",
         "--isect-capacity", "16384", *extra],
        cwd=tmp_path, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads((out / "quality.json").read_text()), out


def test_rehearsal_of_the_64_view_run_and_its_toolchain(tmp_path):
    """64 views at 64x64, 40 steps in two stretches of 20 standing for
    the recipe's 7500 each, then the downstream stage on the final
    checkpoint."""
    rep, out = _rehearse(tmp_path, ["--iters", "40", "--stretch", "20",
                                    "--downstream"])
    assert rep["config"] == "64"
    for step, ref in (("20", 20.43), ("40", 20.11)):
        assert rep["evals"][step]["bit_for_bit"]
        assert rep["evals"][step]["published_psnr"] == ref
    result = json.loads((out / "eval_64_torch.json").read_text())
    assert result["results"]["psnr"] == rep["evals"]["40"]["psnr"]
    assert result["experiment_name"] == "raytraced64"
    down = rep["downstream"]
    assert down["gs_eval"]["bit_for_bit"]
    assert down["gaussian_splat"]["gaussians"] == down["checkpoint_alive"] \
        == rep["alive_end"]  # no refine after the last logged step here
    assert down["render_pose"]["views"] == 56  # 64 views, interval 8
    # the mesh's counts are its PLY's; 40 steps at 64x64 fuse no surface
    # yet (the card's phase 21 trains 600 steps and requires a mesh)
    mesh = quality_workflow.ply_counts(
        tmp_path / "downstream_64" / "export" / "tsdf_mesh.ply")
    assert (down["tsdf_tetra"]["vertices"], down["tsdf_tetra"]["faces"]) == (
        mesh["vertex"], mesh["face"])
    assert down["tsdf_tetra"]["s"] > 0
    assert down["published"]["gaussian_splat"]["gaussians"] == 1_010_067
    curve = rep["train_curve"]
    assert len(curve) == 16 and curve["0"]["step"] == 0
    assert curve["14999"]["step"] == 39  # the last step logged, as 14999
    assert curve["1000"]["published"]["num_alive"] == 452_733
    assert rep["counted"]["steps"] == 2


def test_rehearsal_of_the_cogs_smoke(tmp_path):
    rep, out = _rehearse(tmp_path, ["--method", "co-gs", "--iters", "20"],
                         ["--model.use-depth-loss", "True"])
    assert rep["config"] == "64_cogs" and rep["method"] == "co-gs"
    assert rep["evals"]["20"]["bit_for_bit"]
    assert rep["published"]["psnr"] == 20.09
    assert "downstream" not in rep and "train_curve" not in rep
    assert (out / "eval_64_cogs_torch.json").exists()
