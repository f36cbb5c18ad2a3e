"""The mono-depth co-gs path of gstk_torch end to end on the CPU (the port
of gstk_tpu's ``tests/test_mono_e2e.py``).

  * ``gstk_torch.tools.make_mono_depth`` and gstk_tpu's
    ``tools/make_mono_depth.py`` on the same dataset, written by gstk_tpu's
    raytraced generator: every frame's ``scale`` and ``shift`` within
    1e-12, the same frames otherwise, and equal decoded mono-depth PNGs;
  * the port's chain in a process where importing jax, gstk_tpu and Pillow
    fails: ``python -m gstk_torch.data.raytraced``, then
    ``python -m gstk_torch.tools.make_mono_depth`` (its recovery report
    under the tool's 2% refusal), then co-gs through
    ``gstk_torch.scripts.train --device cpu`` with the whole est-depth loss
    zoo from step 0, as gstk_tpu's test trains it: finite losses and an
    ``eval_psnr`` row.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from gstk_tpu.data.raytraced import generate_raytraced_dataset
from gstk_torch.tools import make_mono_depth
from gstk_torch.utils.io import read_png

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
BLOCK = ('import sys; sys.modules["jax"] = sys.modules["gstk_tpu"] = '
         'sys.modules["PIL"] = None\n'
         'import torch; torch.set_num_threads(2)\n')
CO_GS = [
    "--max-num-iterations", "3", "--steps-per-save", "0",
    "--steps-per-eval-all-images", "3", "--steps-per-eval-image", "0",
    "--isect-capacity", "8192", "--max-capacity", "4096",
    "--raster-chunk", "16", "--model.sh-degree", "1",
    "--model.use-est-depth", "True",
    "--model.use-pearson-depth", "True",
    "--model.use-scaled-est-depth", "True",
    "--model.use-depth-regularization", "True",
    "--model.depth-loss-start-iteration", "0",
    "--dataparser.eval-mode", "interval",
    "--dataparser.eval-interval", "3",
    "--data-parallel", "off",
]


def _gstk_tpu_tool():
    spec = importlib.util.spec_from_file_location(
        "make_mono_depth_reference", REPO / "tools" / "make_mono_depth.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_make_mono_depth_matches_gstk_tpu(tmp_path):
    data = tmp_path / "rt"
    generate_raytraced_dataset(data, n_views=6, img_wh=(64, 64), seed_points=800)
    theirs, ours = tmp_path / "jax_mono", tmp_path / "torch_mono"
    assert _gstk_tpu_tool().main(["--data", str(data), "--out", str(theirs),
                                  "--seed", "1"]) is None
    report = make_mono_depth.main(["--data", str(data), "--out", str(ours),
                                   "--seed", "1"])
    assert report["frames"] == 6 and report["median_rel_scale_error"] <= 0.02
    a = json.loads((theirs / "transforms.json").read_text())
    b = json.loads((ours / "transforms.json").read_text())
    fa, fb = a.pop("frames"), b.pop("frames")
    assert a == b and len(fa) == len(fb) == 6
    for x, y in zip(fa, fb):
        for key in ("scale", "shift"):
            np.testing.assert_allclose(y[key], x[key], rtol=0, atol=1e-12)
        assert {k: v for k, v in x.items() if k not in ("scale", "shift")} == \
            {k: v for k, v in y.items() if k not in ("scale", "shift")}
        np.testing.assert_array_equal(read_png(ours / y["depth_path"]),
                                      read_png(theirs / x["depth_path"]))
    for link in ("images", "sparse.ply"):
        assert (ours / link).resolve() == (data / link).resolve()


def test_mono_cogs_chain_without_jax_gstk_tpu_pillow(tmp_path):
    rt, mono, out = tmp_path / "rt", tmp_path / "rt_mono", tmp_path / "out"
    code = BLOCK + f"""
import runpy
sys.argv = ["raytraced", "--output-dir", {str(rt)!r}, "--n-views", "6",
            "--width", "64", "--height", "64", "--seed-points", "800",
            "--device", "cpu"]
runpy.run_module("gstk_torch.data.raytraced", run_name="__main__")
sys.argv = ["make_mono_depth", "--data", {str(rt)!r}, "--out", {str(mono)!r},
            "--seed", "1"]
runpy.run_module("gstk_torch.tools.make_mono_depth", run_name="__main__")
from gstk_torch.scripts.train import main
main(["--device", "cpu", "co-gs", "--data", {str(mono)!r}, "--output-dir",
      {str(out)!r}, "--experiment-name", "mono", *{CO_GS!r}])
assert all(sys.modules[m] is None for m in ("jax", "gstk_tpu", "PIL"))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                          capture_output=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "mono (m, c) recovery: median rel scale error" in proc.stdout
    frames = json.loads((mono / "transforms.json").read_text())["frames"]
    assert all("scale" in f and "shift" in f for f in frames)
    rows = [json.loads(line) for line in
            (out / "mono" / "co-gs" / "metrics.jsonl").read_text().splitlines()]
    assert any("eval_psnr" in r for r in rows)
    losses = [r["loss"] for r in rows if "loss" in r]
    assert losses and all(np.isfinite(v) for v in losses)
    # the est-depth terms ran: Pearson, the scaled estimate's log-depth
    # gradient and the depth regulariser
    terms = [r for r in rows if "log_depth" in r]
    for key in ("depth_local_pearson", "log_depth", "depth_reg_loss"):
        assert terms and all(np.isfinite(r[key]) for r in terms), key
    assert any(r["log_depth"] > 0 for r in terms)
