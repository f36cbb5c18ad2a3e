"""gstk_torch's train CLI and config files on the CPU.

  * ``save_config`` / ``load_config`` round-trip every method's config, and
    gstk_tpu's ``load_config`` reads the file into its own classes;
  * a config written by gstk_tpu loads in a process where importing
    gstk_tpu fails, and a class tag the port has no counterpart for raises;
  * in a process where importing Pillow, OpenCV and PyYAML fails (the H100
    machine has none of them), the port's generator writes a synthetic
    dataset and ``python -m gstk_torch.scripts.train --device cpu
    gaussian-splatting`` trains 12 steps at 64x48 on it, refining twice,
    and ends with a checkpoint that gstk_tpu's ``load_checkpoint`` reads
    and a final eval line;
  * co-gs (gstk_tpu's ``tests/test_cli_e2e.py`` case: sensor depth from
    step 0), co-gs on mono depth (``scale`` / ``shift`` written into the
    dataset's ``transforms.json``) with SE3 camera optimisation, and
    surface-gs with SO3xR3 train 6 steps through ``main --device cpu``;
    each checkpoint loads in gstk_tpu, camera state included;
  * with no card and no ``--device``, the CLI raises.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gstk_tpu.configs import serialize as jserialize
from gstk_tpu.configs.methods import method_configs as jmethod_configs
from gstk_tpu.core.gaussians import init_scene as jinit_scene
from gstk_tpu.train import checkpoint as jckpt
from gstk_tpu.train.step import init_train_state as jinit_train_state
from gstk_torch.configs import serialize
from gstk_torch.configs.methods import method_configs
from gstk_torch.scripts import train as train_script

REPO = Path(__file__).resolve().parents[1]
BLOCK = 'import sys; sys.modules["PIL"] = sys.modules["cv2"] = sys.modules["yaml"] = None\n'


def _run(code: str, timeout: int = 240) -> subprocess.CompletedProcess:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out


@pytest.mark.parametrize("method", list(method_configs()))
def test_config_roundtrip_and_gstk_tpu_reads_it(method, tmp_path):
    cfg = dataclasses.replace(method_configs()[method], data=tmp_path / "ds",
                              max_num_iterations=123)
    path = tmp_path / "config.yml"
    serialize.save_config(path, cfg)
    json.loads(path.read_text())  # the file is JSON
    assert serialize.load_config(path) == cfg
    theirs = jserialize.load_config(path)  # through PyYAML
    assert type(theirs).__module__ == "gstk_tpu.train.trainer"
    assert jserialize.to_dict(theirs) == serialize.to_dict(cfg)


def test_gstk_tpu_config_loads_without_gstk_tpu(tmp_path):
    cfg = dataclasses.replace(jmethod_configs()["co-gs"], max_num_iterations=7)
    path = tmp_path / "config.yml"
    jserialize.save_config(path, cfg)  # YAML
    out = _run(
        'import sys; sys.modules["gstk_tpu"] = None\n'
        "import json\n"
        "from gstk_torch.configs.serialize import load_config, to_dict\n"
        f"cfg = load_config({str(path)!r})\n"
        "print(type(cfg).__module__, type(cfg.model).__name__)\n"
        "print(json.dumps(to_dict(cfg)))\n"
    )
    kind, dumped = out.stdout.strip().splitlines()[-2:]
    assert kind == "gstk_torch.train.trainer DepthConfig"
    assert json.loads(dumped) == json.loads(json.dumps(jserialize.to_dict(cfg)))


@pytest.mark.parametrize("tag", ["os.path.Path", "gstk_tpu.models.vanilla.NoSuch",
                                 "gstk_tpu.viewer.nothing.Config"])
def test_foreign_config_class_raises(tag):
    with pytest.raises(ValueError):
        serialize.from_dict({"__class__": tag})


def test_train_cli_without_pillow_opencv_yaml(tmp_path):
    out = _run(BLOCK + f"""
from pathlib import Path
from gstk_torch.data.synthetic import generate_synthetic_dataset
from gstk_torch.scripts.train import main
tmp = Path({str(tmp_path)!r})
generate_synthetic_dataset(tmp / "ds", n_points=300, n_views=6,
                           img_wh=(64, 48), device="cpu")
main(["--device", "cpu", "gaussian-splatting", "--data", str(tmp / "ds"),
      "--output-dir", str(tmp / "out"), "--max-num-iterations", "12",
      "--steps-per-eval-all-images", "0", "--steps-per-eval-image", "6",
      "--log-every", "4", "--isect-capacity", "8192", "--raster-chunk", "16",
      "--model.sh-degree", "1", "--model.warmup-length", "2",
      "--model.refine-every", "5",
      "--dataparser.eval-mode", "interval", "--dataparser.eval-interval", "3"])
assert all(sys.modules[m] is None for m in ("PIL", "cv2", "yaml"))
""")
    assert "Final eval: {'eval_psnr'" in out.stdout
    run_dir = tmp_path / "out" / "ds" / "gaussian-splatting"
    assert (run_dir / "config.yml").exists()
    path = jckpt.latest_checkpoint(run_dir / "ckpts")
    assert path.name == "step-000000012.ckpt.npz"
    cap = jckpt.peek_capacity(path)
    state = jckpt.load_checkpoint(path, jinit_train_state(jinit_scene(
        jax.random.PRNGKey(0), cap, num_random=8, sh_degree=1)))
    assert int(state.step) == 12
    assert np.isfinite(np.asarray(state.scene.means)).all()
    rows = [json.loads(r) for r in (run_dir / "metrics.jsonl").open()]
    alive = [r["num_alive"] for r in rows if "num_alive" in r]
    assert alive[0] == 300 and alive[-1] != 300  # refinement ran


def test_train_cli_needs_a_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_script.main(["gaussian-splatting", "--data", str(tmp_path),
                           "--output-dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from gstk_torch.data.synthetic import generate_synthetic_dataset

    return generate_synthetic_dataset(
        tmp_path_factory.mktemp("synthetic"), n_points=400, n_views=6,
        img_wh=(64, 48), device="cpu")


def _mono(dataset, out):
    """A copy of ``dataset`` whose frames carry mono-depth scale and shift."""
    import shutil

    shutil.copytree(dataset, out)
    meta = json.loads((out / "transforms.json").read_text())
    for i, frame in enumerate(meta["frames"]):
        frame["scale"], frame["shift"] = 0.9 + 0.05 * i, 0.02 * i
    (out / "transforms.json").write_text(json.dumps(meta))
    return out


CLI_METHODS = {
    "co-gs": ("co-gs", ["--model.depth-loss-start-iteration", "0"], None,
              ("depth_l1",)),
    "co-gs_mono_SE3": ("co-gs", [
        "--model.depth-loss-start-iteration", "0",
        "--model.use-est-depth", "True", "--model.use-scaled-est-depth", "True",
        "--model.use-pearson-depth", "True", "--model.local-patch-size", "16",
        "--camera-opt.mode", "SE3"], _mono, ("depth_local_pearson", "log_depth")),
    "surface-gs_SO3xR3": ("surface-gs", ["--camera-opt.mode", "SO3xR3"], None,
                          ()),
}


@pytest.mark.parametrize("case", list(CLI_METHODS))
def test_cli_methods_train(case, dataset, tmp_path):
    method, extra, make_data, terms = CLI_METHODS[case]
    data = make_data(dataset, tmp_path / "ds") if make_data else dataset
    out_dir = tmp_path / "out"
    trainer = train_script.main([
        "--device", "cpu", method, "--data", str(data),
        "--output-dir", str(out_dir), "--max-num-iterations", "6",
        "--steps-per-save", "6", "--steps-per-eval-all-images", "0",
        "--isect-capacity", str(1 << 13), "--raster-chunk", "16",
        "--log-every", "1", "--model.sh-degree", "1",
        "--dataparser.eval-mode", "interval", "--dataparser.eval-interval", "3",
        "--dataparser.downscale-factor", "1", *extra,
    ])
    run_dir = out_dir / data.name / method
    path = jckpt.latest_checkpoint(run_dir / "ckpts")
    assert path.name == "step-000000006.ckpt.npz"
    frames = trainer.datamanager.train_frames
    assert all(f.depth is not None for f in frames)
    assert (frames[0].mono_scale is not None) == (make_data is not None)
    rows = [json.loads(r) for r in (run_dir / "metrics.jsonl").open()]
    for term in terms:
        values = [r[term] for r in rows if term in r]
        assert len(values) == 6 and values[0] == 0.0  # gated at step 0
        assert all(np.isfinite(v) and v != 0.0 for v in values[1:]), term
    num_cams = None if "--camera-opt.mode" not in extra else len(frames)
    state = jckpt.load_checkpoint(path, jinit_train_state(jinit_scene(
        jax.random.PRNGKey(0), jckpt.peek_capacity(path), num_random=8,
        sh_degree=1), num_cameras=num_cams))
    assert int(state.step) == 6
    if num_cams:
        adj = np.asarray(state.cam_adjust)
        assert np.isfinite(adj).all() and np.abs(adj).max() > 0
    if method == "surface-gs":
        init = trainer.state.scene.means.detach().numpy()
        np.testing.assert_array_equal(np.asarray(state.scene.means), init)
        assert not trainer.state.adam.mu["means"].any()
