"""gstk_torch's raytraced dataset generator against gstk_tpu's on the CPU.

  * ``_hash3`` equals gstk_tpu's bit for bit on a grid of cells with
    negative coordinates and products that overflow int64;
  * the texture helpers (value noise, fbm, the checkers with their floor
    remainder of negative cells) equal gstk_tpu's on random points;
  * at 64x64, 6 views, with supersample 1 and 3, the port's dataset (on
    the CPU) against gstk_tpu's: RGBA equal in >= 99.9% of pixels and
    alpha equal; depth equal in >= 99.9% and within 1 mm elsewhere; the
    poses of ``transforms.json`` within 1e-12 and its intrinsics equal;
    ``sparse.ply`` with the same count, points within 1e-9 and colours
    equal in >= 99.9%;
  * ``python -m gstk_torch.data.raytraced --device cpu`` runs in a process
    where importing jax, gstk_tpu and Pillow fails, and writes the same
    files as the function;
  * without a card and without a device, the generator raises.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gstk_tpu.data import raytraced as jrt
from gstk_torch.data import raytraced as trt
from gstk_torch.utils.io import read_ply, read_png

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
BLOCK = ('import sys; sys.modules["jax"] = sys.modules["gstk_tpu"] = '
         'sys.modules["PIL"] = None\n'
         'import torch; torch.set_num_threads(2)\n')
SHARE = 0.999  # pixels, depths and colours that must be equal
GEN = dict(n_views=6, img_wh=(64, 64), seed_points=800)


def _pil_png(path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """{ss: (gstk_tpu's dataset dir, the port's)} for ss 1 and 3."""
    root = tmp_path_factory.mktemp("raytraced")
    out = {}
    for ss in (1, 3):
        theirs = jrt.generate_raytraced_dataset(root / f"jax{ss}", supersample=ss,
                                                **GEN)
        ours = trt.generate_raytraced_dataset(root / f"torch{ss}", supersample=ss,
                                              device="cpu", **GEN)
        out[ss] = (Path(theirs), Path(ours))
    return out


def test_hash3_bit_equal():
    """Cells from -2^40 to 2^40 (int64 products wrap) and a dense grid
    around 0 (negative cells, the floor remainder's domain)."""
    rng = np.random.default_rng(0)
    big = rng.integers(-(1 << 40), 1 << 40, (3, 4096)).astype(np.float64)
    g = np.arange(-17, 17, dtype=np.float64)
    grid = np.stack([a.ravel() for a in np.meshgrid(g, g, g)])
    for cells in (big, grid):
        for seed in (0, 5, 41, -3):
            want = jrt._hash3(*cells, seed)
            got = trt._hash3(*torch.from_numpy(cells), seed).numpy()
            np.testing.assert_array_equal(got, want)
    # the products overflow: the wrapped value, not a saturated one
    assert (np.abs(big[2]) * 2147483647 > 2.0 ** 63).any()


def test_textures_equal_gstk_tpu():
    rng = np.random.default_rng(1)
    p = rng.uniform(-6, 6, (4096, 3))
    tp = torch.from_numpy(p)
    np.testing.assert_array_equal(trt._value_noise(tp, 7).numpy(),
                                  jrt._value_noise(p, 7))
    np.testing.assert_array_equal(trt._fbm(tp, 4, 5).numpy(), jrt._fbm(p, 4, 5))
    np.testing.assert_array_equal(trt._checker(tp, 0.9).numpy(),
                                  jrt._checker(p, 0.9))
    assert (np.floor(p * 0.9) < 0).any()
    for jobj, tobj in zip(jrt.build_scene(), trt.build_scene()):
        np.testing.assert_array_equal(tobj.albedo(tp).numpy(), jobj.albedo(p))


@pytest.mark.parametrize("ss", [1, 3])
def test_images_and_depths_match_gstk_tpu(datasets, ss):
    theirs, ours = datasets[ss]
    n_px = n_rgba = n_depth = n_hit = 0
    for i in range(GEN["n_views"]):
        a = _pil_png(theirs / "images" / f"frame_{i:05d}.png")
        b = read_png(ours / "images" / f"frame_{i:05d}.png")
        assert a.shape == b.shape == (64, 64, 4) and b.dtype == np.uint8
        np.testing.assert_array_equal(b[..., 3], a[..., 3])
        n_hit += int((b[..., 3] > 0).sum())
        da = _pil_png(theirs / "depths" / f"depth_{i:05d}.png").astype(np.int64)
        db = read_png(ours / "depths" / f"depth_{i:05d}.png")
        assert db.dtype == np.uint16 and db.shape == (64, 64)
        assert np.abs(db.astype(np.int64) - da).max() <= 1
        n_px += a.shape[0] * a.shape[1]
        n_rgba += int((a == b).all(-1).sum())
        n_depth += int((db == da).sum())
    assert 0 < n_hit < n_px  # the scene and the sky
    assert n_rgba >= SHARE * n_px and n_depth >= SHARE * n_px


@pytest.mark.parametrize("ss", [1, 3])
def test_transforms_and_seed_cloud_match_gstk_tpu(datasets, ss):
    theirs, ours = datasets[ss]
    a = json.loads((theirs / "transforms.json").read_text())
    b = json.loads((ours / "transforms.json").read_text())
    for key in ("fl_x", "fl_y", "cx", "cy", "w", "h", "camera_model",
                "ply_file_path"):
        assert b[key] == a[key], key
    assert len(b["frames"]) == len(a["frames"]) == GEN["n_views"]
    for fa, fb in zip(a["frames"], b["frames"]):
        assert (fb["file_path"], fb["depth_path"]) == (fa["file_path"],
                                                       fa["depth_path"])
        np.testing.assert_allclose(fb["transform_matrix"], fa["transform_matrix"],
                                   rtol=0, atol=1e-12)
    pa = read_ply(theirs / "sparse.ply")["vertex"]
    pb = read_ply(ours / "sparse.ply")["vertex"]
    assert len(pa) == len(pb) == GEN["seed_points"]
    for k in "xyz":
        np.testing.assert_allclose(pb[k], pa[k], rtol=0, atol=1e-9)
    same = np.stack([pa[c] == pb[c] for c in ("red", "green", "blue")]).all(0)
    assert same.mean() >= SHARE


def test_cli_without_jax_gstk_tpu_pillow(datasets, tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", BLOCK + f"""
import runpy
sys.argv = ["raytraced", "--output-dir", {str(tmp_path / "cli")!r},
            "--n-views", "6", "--width", "64", "--height", "64",
            "--seed-points", "800", "--supersample", "3", "--device", "cpu"]
runpy.run_module("gstk_torch.data.raytraced", run_name="__main__")
assert all(sys.modules[m] is None for m in ("jax", "gstk_tpu", "PIL"))
"""], cwd=REPO, text=True, capture_output=True, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "Raytraced dataset written to" in out.stdout
    _, ours = datasets[3]
    for name in ["transforms.json", "sparse.ply"] + [
            f"{d}/{p}_{i:05d}.png" for i in range(6)
            for d, p in (("images", "frame"), ("depths", "depth"))]:
        assert (tmp_path / "cli" / name).read_bytes() == (ours / name).read_bytes(), name


def test_generator_needs_a_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trt.generate_raytraced_dataset(tmp_path / "x", n_views=1, img_wh=(8, 8))
    assert not (tmp_path / "x").exists()
