"""gstk_torch's data processing (``process_data/{pipeline,mono_depth,
equirect,aria}.py``, ``scripts/{process_data,download_data}.py``) against
gstk_tpu's on the CPU, on inputs made from a numpy seed.

Tolerances:
  * an equirect view within 1 level of gstk_tpu's ``cv2.remap`` (the port
    samples bilinearly in float64 and rounds);
  * the pipeline's image pyramid equal to gstk_tpu's ``cv2.resize``
    (INTER_AREA) where the size divides by the factor, within 1 level
    elsewhere; ``transforms.json`` equal; the seed cloud's PLY byte for
    byte; the port's run with Pillow, OpenCV and PyYAML blocked;
  * the depth estimates' decoded 16-bit arrays equal (gstk_tpu writes them
    with Pillow, the port with its own PNG writer);
  * the Aria pose math, the download registry and the CLI's parsed config
    equal.
"""

import dataclasses
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from gstk_tpu.process_data import aria as jaria
from gstk_tpu.process_data import equirect as jequirect
from gstk_tpu.process_data import mono_depth as jmono
from gstk_tpu.process_data import pipeline as jpipeline
from gstk_tpu.process_data.colmap import qvec_to_rotmat, read_model
from gstk_tpu.scripts import download_data as jdownload
from gstk_tpu.scripts import process_data as jcli
from gstk_torch.process_data import aria as taria
from gstk_torch.process_data import equirect as tequirect
from gstk_torch.process_data import mono_depth as tmono
from gstk_torch.process_data import pipeline as tpipeline
from gstk_torch.scripts import download_data as tdownload
from gstk_torch.scripts import process_data as tcli
from gstk_torch.utils.io import read_png, write_png
from tests._torch_run import blocked
from tests.test_process_data import _write_colmap_model


def _levels(a, b):
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


@pytest.mark.parametrize("yaw, pitch", [(0.0, 0.0), (1.0, 0.3), (3.0, -1.2),
                                        (5.5, 1.5)])
def test_equirect_view_matches_jax(rng, yaw, pitch):
    img = rng.integers(0, 256, (128, 256, 3), dtype=np.uint8)
    want = jequirect.perspective_from_equirect(img, yaw, pitch, 90.0, (60, 80))
    got = tequirect.perspective_from_equirect(img, yaw, pitch, 90.0, (60, 80))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _levels(got, want) <= 1


def test_equirect_projections_match_jax(tmp_path, rng):
    src = tmp_path / "pano"
    src.mkdir()
    write_png(src / "pano.png", rng.integers(0, 256, (64, 128, 3), np.uint8))
    want = jequirect.generate_planar_projections_from_equirectangular(
        src, tmp_path / "j", samples_per_image=4, out_hw=(30, 40))
    with blocked(pytest.MonkeyPatch.context):
        got = tequirect.generate_planar_projections_from_equirectangular(
            src, tmp_path / "t", samples_per_image=4, out_hw=(30, 40))
    assert [p.name for p in got] == [p.name for p in want]
    for a, b in zip(got, want):
        assert _levels(read_png(a), read_png(b)) <= 1


def _images(d: Path, rng, n, hw=(24, 32)):
    d.mkdir()
    for i in range(n):
        write_png(d / f"frame_{i:03d}.png",
                  rng.integers(0, 256, hw + (3,), np.uint8))
    return d


def _same_depths(got, want):
    assert [p.name for p in got] == [p.name for p in want]
    for a, b in zip(got, want):
        da, db = read_png(a), read_png(b)
        assert da.dtype == np.uint16 and db.dtype == np.uint16
        np.testing.assert_array_equal(da, db)


def test_estimate_depths_placeholder_and_custom(tmp_path, rng, monkeypatch):
    for mod in (jmono, tmono):  # "wave" stays out of the shared registries
        monkeypatch.setattr(mod, "_DEPTH_MODELS", dict(mod._DEPTH_MODELS))
    imgs = _images(tmp_path / "images", rng, 3)
    want = jmono.estimate_depths(imgs, tmp_path / "j", method="gradient",
                                 allow_toy=True)
    got = tmono.estimate_depths(imgs, tmp_path / "t", method="gradient",
                                allow_toy=True)
    _same_depths(got, want)
    assert got[0].name == "depth_000.png"

    fn = lambda ims: [np.sin(i[..., 0] / 40.0) + 0.01 * i[..., 1] for i in ims]
    jmono.register_depth_model("wave", fn)
    tmono.register_depth_model("wave", fn)
    _same_depths(tmono.estimate_depths(imgs, tmp_path / "t2", method="wave"),
                 jmono.estimate_depths(imgs, tmp_path / "j2", method="wave"))
    with pytest.raises(RuntimeError, match="allow-toy-depth"):
        tmono.estimate_depths(imgs, tmp_path / "t3", method="gradient")


def test_depth_anything_runs_on_the_given_device(rng, monkeypatch):
    """The hub backend (``torch.hub.load`` replaced: nothing here may reach
    the network) moves the model and each image to ``device``."""
    import torch

    moved = []

    class Hub(torch.nn.Module):
        def to(self, device):
            moved.append(torch.device(device))
            return super().to(device)

        def forward(self, x):
            moved.append(x.device)
            return x.mean(1)

    monkeypatch.setattr(tmono, "_DEPTH_MODELS", {})
    monkeypatch.setattr(torch.hub, "load", lambda *a, **k: Hub())
    assert tmono.try_load_depth_anything(device="cpu")
    img = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
    (depth,) = tmono._DEPTH_MODELS["depth_anything"]([img])
    assert moved == [torch.device("cpu")] * 2
    np.testing.assert_allclose(depth, img.mean(-1) / 255.0, rtol=1e-6)


def test_estimate_depths_auto_needs_a_model(tmp_path, rng, monkeypatch):
    """``auto`` raises when no real model is there (the hub loader is
    replaced: nothing here may reach the network), and takes the
    placeholder only with ``allow_toy``."""
    imgs = _images(tmp_path / "images", rng, 1)
    monkeypatch.delenv("GSTK_DEPTH_MODEL_DIR", raising=False)
    for mod in (tmono, jmono):  # only the placeholder registered
        monkeypatch.setattr(mod, "_DEPTH_MODELS",
                            {"gradient": mod._DEPTH_MODELS["gradient"]})
    monkeypatch.setattr(jmono, "try_load_depth_anything", lambda: False)
    asked = []
    monkeypatch.setattr(tmono, "try_load_depth_anything",
                        lambda device=None: asked.append(device) or False)
    with pytest.raises(RuntimeError, match="GSTK_DEPTH_MODEL_DIR"):
        tmono.estimate_depths(imgs, tmp_path / "d", method="auto",
                              device="cpu")
    assert asked == ["cpu"]
    assert not tmono.try_load_local_dpt(device="cpu")
    got = tmono.estimate_depths(imgs, tmp_path / "d", method="auto",
                                allow_toy=True)
    _same_depths(got, jmono.estimate_depths(imgs, tmp_path / "j",
                                            method="auto", allow_toy=True))


def test_local_dpt_matches_jax(tmp_path, rng, monkeypatch):
    """A local transformers DPT checkpoint with random tiny weights: the
    port runs it on the device it is given and writes what gstk_tpu writes.
    Both registries are copies here: a "local_dpt" left in gstk_tpu's would
    make its ``auto`` take it in later tests."""
    for mod in (jmono, tmono):
        monkeypatch.setattr(mod, "_DEPTH_MODELS", dict(mod._DEPTH_MODELS))
    transformers = pytest.importorskip("transformers")
    cfg = transformers.DPTConfig(
        hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
        intermediate_size=64, image_size=64, patch_size=16,
        backbone_out_indices=(0, 1, 2, 3),
        neck_hidden_sizes=[16, 16, 16, 16], fusion_hidden_size=16,
    )
    import torch

    torch.manual_seed(0)
    transformers.DPTForDepthEstimation(cfg).save_pretrained(tmp_path / "dpt")
    imgs = _images(tmp_path / "images", rng, 2, (64, 64))
    assert jmono.try_load_local_dpt(tmp_path / "dpt")
    want = jmono.estimate_depths(imgs, tmp_path / "j", method="local_dpt")
    assert tmono.try_load_local_dpt(tmp_path / "dpt", device="cpu")
    got = tmono.estimate_depths(imgs, tmp_path / "t", method="local_dpt")
    _same_depths(got, want)


def test_aria_pose_math_matches_jax(rng):
    ts = np.sort(rng.uniform(0, 1e10, 16))
    for q in rng.uniform(0, 1e10, 8):
        assert (taria.nearest_pose_index(ts, q)
                == jaria.nearest_pose_index(ts, q))
    for _ in range(4):
        a, b = (np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(2))
        twd, tdc = np.eye(4), np.eye(4)
        twd[:3, :3], twd[:3, 3] = a, rng.normal(size=3)
        tdc[:3, :3], tdc[:3, 3] = b, rng.normal(size=3)
        np.testing.assert_array_equal(taria.camera_to_world(twd, tdc),
                                      jaria.camera_to_world(twd, tdc))
    kw = dict(fx=610.0, fy=610.0, cx=716.0, cy=716.0,
              distortion_params=rng.normal(size=12), width=1408, height=1408,
              t_device_camera=np.eye(4))
    frames = [{"file_path": f"images/frame_{i:05d}.png",
               "t_world_camera": np.eye(4), "timestamp_ns": float(i)}
              for i in range(3)]
    assert (taria.frames_to_transforms(taria.AriaCalibration(**kw), frames)
            == jaria.frames_to_transforms(jaria.AriaCalibration(**kw), frames))


def test_aria_capture_needs_projectaria_tools(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "projectaria_tools", None)
    with pytest.raises(ImportError, match="projectaria_tools"):
        taria.process_aria_capture(tmp_path / "a.vrs", tmp_path, tmp_path / "o")


def _depth_maps(model_dir: Path, out: Path, kind: str):
    """16-bit depth PNGs of the model's images (depth_XXX.png): sensor
    depth in mm at 0.1 x the SfM depth, or a mono estimate 40 z + 10."""
    _, imgs, points = read_model(model_dir)
    out.mkdir()
    for im in imgs.values():
        rot = qvec_to_rotmat(im.qvec)
        depth = np.zeros((48, 64), np.float64)
        for k, pid in enumerate(im.point3d_ids):
            z = (rot @ points[pid].xyz)[2] + im.tvec[2]
            u, v = im.xys[k].astype(int)
            if 0 <= u < 64 and 0 <= v < 48:
                depth[v, u] = z * 100.0 if kind == "sensor" else 40 * z + 10
        name = im.name.replace(".jpg", ".png").replace("frame_", "depth_")
        write_png(out / name, np.rint(depth).astype(np.uint16))


@pytest.mark.parametrize("depth, hw", [
    ("none", (48, 64)),  # divides by 2, 4 and 8: pyramids equal to cv2's
    ("sensor", (50, 66)),  # does not: within 1 level
    ("mono", (64, 96)),
])
def test_process_images_matches_jax(tmp_path, depth, hw):
    """``process_images`` with ``skip_colmap`` on PNG inputs (the port's
    through its CLI), against gstk_tpu's on the same inputs."""
    rng = np.random.default_rng(1)
    raw = tmp_path / "raw"
    raw.mkdir()
    for i in range(4):
        write_png(raw / f"frame_{i:03d}.png",
                  rng.integers(0, 256, hw + (3,), np.uint8))
    runs = {}
    for pkg in ("jax", "torch"):
        out = tmp_path / pkg
        _write_colmap_model(out / "colmap" / "sparse" / "0",
                            np.random.default_rng(2))
        runs[pkg] = out
    args = ["--num-downscales", "3"]
    kw = {}
    if depth != "none":
        _depth_maps(runs["jax"] / "colmap" / "sparse" / "0",
                    tmp_path / "depths", depth)
        flag = "--depth-data" if depth == "sensor" else "--mono-depth-data"
        args += [flag, str(tmp_path / "depths")]
        kw = {"depth_data" if depth == "sensor" else "mono_depth_data":
              tmp_path / "depths"}
    jpipeline.process_images(jpipeline.ProcessConfig(
        data=raw, output_dir=runs["jax"], num_downscales=3, skip_colmap=True,
        **kw))
    with blocked(pytest.MonkeyPatch.context):
        tcli.main(["images", "--data", str(raw), "--output-dir",
                   str(runs["torch"]), "--skip-colmap", *args])

    want = json.loads((runs["jax"] / "transforms.json").read_text())
    got = json.loads((runs["torch"] / "transforms.json").read_text())
    assert got == want
    if depth == "mono":
        assert all("scale" in f and "shift" in f for f in got["frames"])
    assert ((runs["torch"] / "colmap" / "point_cloud.ply").read_bytes()
            == (runs["jax"] / "colmap" / "point_cloud.ply").read_bytes())
    for factor in (2, 4, 8):
        for i in range(4):
            name = f"images_{factor}/frame_{i + 1:05d}.png"
            a, b = read_png(runs["torch"] / name), read_png(runs["jax"] / name)
            assert a.shape == b.shape == (hw[0] // factor, hw[1] // factor, 3)
            assert _levels(a, b) <= (0 if hw[0] % factor == hw[1] % factor == 0
                                     else 1), name


def test_area_downscale_matches_cv2(rng):
    """Grey, RGB, RGBA and grey + alpha, 8 and 16 bits, at sizes that divide
    by each factor and sizes that do not."""
    import cv2

    for dtype in (np.uint8, np.uint16):
        for shape in ((48, 64), (48, 64, 2), (48, 64, 3), (40, 56, 4),
                      (47, 65, 3), (33, 90)):
            img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
            for f in (2, 4, 8):
                want = cv2.resize(img, (shape[1] // f, shape[0] // f),
                                  interpolation=cv2.INTER_AREA)
                got = tpipeline.area_downscale_image(img, f)
                assert got.dtype == dtype and got.shape == want.shape
                exact = shape[0] % f == 0 and shape[1] % f == 0
                assert _levels(got, want) <= (0 if exact else 1), (shape, f)


def test_run_sfm_error_paths(tmp_path, monkeypatch):
    monkeypatch.setattr(tpipeline, "colmap_available", lambda: False)
    monkeypatch.setattr(tpipeline, "hloc_available", lambda: False)
    with pytest.raises(RuntimeError, match="No SfM backend"):
        tpipeline.run_sfm(tmp_path, tmp_path / "c")
    with pytest.raises(RuntimeError, match="hloc"):
        tpipeline.run_sfm(tmp_path, tmp_path / "c", backend="hloc")
    with pytest.raises(RuntimeError, match="colmap binary"):
        tpipeline.run_sfm(tmp_path, tmp_path / "c", backend="colmap")
    with pytest.raises(FileNotFoundError, match="no COLMAP model"):
        images = _images(tmp_path / "raw", np.random.default_rng(0), 1)
        tpipeline.process_images(tpipeline.ProcessConfig(
            data=images, output_dir=tmp_path / "o", num_downscales=1,
            skip_colmap=True))


def test_run_sfm_uses_hloc_when_available(tmp_path, monkeypatch):
    """A stand-in hloc package records the calls of the reference's
    hloc_utils.py:15 pattern."""
    calls = {}

    def module(name, **attrs):
        m = types.ModuleType(name)
        for k, v in attrs.items():
            setattr(m, k, v)
        monkeypatch.setitem(sys.modules, name, m)
        return m

    def recon(sfm_dir, img_dir, pairs, features, matches, image_list):
        calls["recon"] = sfm_dir
        Path(sfm_dir).mkdir(parents=True, exist_ok=True)

    module(
        "hloc",
        extract_features=module(
            "hloc.extract_features", confs={"superpoint_aachen": {}},
            main=lambda conf, d, image_list, feature_path:
            calls.setdefault("features", feature_path)),
        match_features=module(
            "hloc.match_features", confs={"superglue": {}},
            main=lambda conf, pairs, features, matches:
            calls.setdefault("matches", matches)),
        pairs_from_exhaustive=module(
            "hloc.pairs_from_exhaustive",
            main=lambda pairs, image_list: calls.setdefault("pairs", pairs)),
        reconstruction=module("hloc.reconstruction", main=recon),
    )
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    (img_dir / "frame_000.png").write_bytes(b"x")
    out = tpipeline.run_sfm(img_dir, tmp_path / "colmap", backend="auto")
    assert calls.keys() == {"features", "pairs", "matches", "recon"}
    assert out == tmp_path / "colmap" / "sparse" / "0"


def test_cli_parses_like_jax(tmp_path, monkeypatch):
    """Every gstk_tpu flag gives the same ProcessConfig; ``--device``
    reaches the depth model's device."""
    seen = {}
    monkeypatch.setattr(jpipeline, "process_images",
                        lambda c: seen.setdefault("jax", c))
    monkeypatch.setattr(tpipeline, "process_images",
                        lambda c: seen.setdefault("torch", c))
    argv = ["images", "--data", "a", "--output-dir", "b",
            "--num-downscales", "2", "--camera-model", "PINHOLE",
            "--depth-data", "d", "--mono-depth-data", "m", "--skip-colmap",
            "--matching-method", "exhaustive", "--gpu", "--using-est-depth",
            "--depth-method", "local_dpt", "--sfm-backend", "colmap",
            "--feature-type", "f", "--matcher-type", "g",
            "--sift-max-features", "100", "--allow-toy-depth"]
    jcli.main(argv)
    tcli.main(argv + ["--device", "cpu"])
    got = dataclasses.asdict(seen["torch"])
    assert got.pop("device") == "cpu"
    assert got == dataclasses.asdict(seen["jax"])
    with pytest.raises(SystemExit):
        tcli.main(["images", "--data", "a"])


def test_download_registry_matches_jax(capsys, tmp_path):
    assert tdownload.DATASETS == jdownload.DATASETS
    for ds, cap in (("nerfstudio", "poster"), ("mill19", "all"),
                    ("mipnerf360", None), ("eyefultower", None)):
        assert tdownload.resolve(ds, cap) == jdownload.resolve(ds, cap)
    with pytest.raises(SystemExit, match="unknown capture"):
        tdownload.resolve("nerfstudio", "nonexistent")
    tdownload.main(["list"])
    listed = capsys.readouterr().out
    assert all(name in listed for name in jdownload.DATASETS)
    # s3 captures print the sync command and fetch nothing
    tdownload.main(["eyefultower", "--capture", "riverview",
                    "--save-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "aws s3 sync --no-sign-request" in out and "riverview" in out
