"""gstk_torch's COLMAP readers, ``colmap_to_json``, the point-cloud export
and the two depth alignments against gstk_tpu's on the CPU (numpy copies,
so every result is held equal): the binary and text models of gstk_tpu's
``tests/test_process_data.py``, read alike; transforms.json written alike,
with every option; the seed-cloud PLY byte for byte; the sensor-depth
scale and the mono-depth (scale, shift) of every image equal, and
recovering the synthetic truth as gstk_tpu's tests require."""

import dataclasses
import json

import numpy as np
import pytest

from gstk_tpu.process_data import colmap as jcolmap
from gstk_tpu.process_data import depth_align as jalign
from gstk_torch.process_data import colmap as tcolmap
from gstk_torch.process_data import depth_align as talign
from tests.test_process_data import _write_colmap_model, _write_colmap_text_model


def _same(a, b):
    """Two readers' dicts of COLMAP dataclasses hold equal fields."""
    assert a.keys() == b.keys()
    for k in a:
        da, db = dataclasses.asdict(a[k]), dataclasses.asdict(b[k])
        assert da.keys() == db.keys()
        for f in da:
            if isinstance(da[f], np.ndarray):
                assert da[f].dtype == db[f].dtype, f
                np.testing.assert_array_equal(da[f], db[f], err_msg=f)
            else:
                assert da[f] == db[f], f


@pytest.mark.parametrize("fmt", ["binary", "text"])
def test_models_read_like_gstk_tpu(tmp_path, rng, fmt):
    d = tmp_path / "sparse"
    if fmt == "binary":
        _write_colmap_model(d, rng)
    else:
        _write_colmap_text_model(d)
    ours, theirs = tcolmap.read_model(d), jcolmap.read_model(d)
    for a, b in zip(ours, theirs):
        _same(a, b)
    cams, imgs, pts = ours
    assert len(imgs) >= 2 and len(pts) >= 2
    if fmt == "binary":
        assert cams[1].model == "PINHOLE" and imgs[1].name == "frame_000.jpg"
        assert (imgs[1].point3d_ids > 0).all()
    else:
        assert cams[1].model == "OPENCV" and list(imgs[1].point3d_ids) == [1, 2]
        np.testing.assert_allclose(pts[1].xyz, [0.5, -0.25, 1.5])


@pytest.mark.parametrize("options", ["plain", "all"])
def test_colmap_to_json_like_gstk_tpu(tmp_path, rng, options):
    d = tmp_path / "sparse"
    _write_colmap_model(d, rng)
    kw = {}
    if options == "all":
        ids = list(jcolmap.read_model(d)[1])
        kw = dict(
            scale_factor=0.5,
            image_id_to_depth_path={i: tmp_path / "depths" / f"d{i}.png" for i in ids},
            image_id_to_mask_path={i: tmp_path / "masks" / f"m{i}.png" for i in ids},
            image_rename_map={f"frame_{i - 1:03d}.jpg": f"img{i}.png" for i in ids},
            scales={i: 0.1 * i for i in ids[:2]},
            shifts={i: -0.2 * i for i in ids[1:]},
        )
    out = {}
    for name, mod in (("ours", tcolmap), ("theirs", jcolmap)):
        o = tmp_path / name
        (o / "colmap").mkdir(parents=True)
        if options == "all":
            (o / "colmap" / "point_cloud.ply").write_bytes(b"ply\n")
        assert mod.colmap_to_json(d, o, **kw) == 4
        out[name] = json.loads((o / "transforms.json").read_text())
    assert out["ours"] == out["theirs"]
    c2w = np.asarray(out["ours"]["frames"][0]["transform_matrix"])
    np.testing.assert_allclose(c2w[:3, :3] @ c2w[:3, :3].T, np.eye(3), atol=1e-6)


def test_camera_params_and_point_cloud_like_gstk_tpu(tmp_path, rng):
    for model, n in (("SIMPLE_PINHOLE", 3), ("PINHOLE", 4), ("SIMPLE_RADIAL", 4),
                     ("RADIAL", 5), ("OPENCV", 8), ("OPENCV_FISHEYE", 8)):
        p = rng.uniform(1, 100, n)
        ours = tcolmap.camera_params_to_json(tcolmap.ColmapCamera(1, model, 64, 48, p))
        theirs = jcolmap.camera_params_to_json(jcolmap.ColmapCamera(1, model, 64, 48, p))
        assert ours == theirs
    with pytest.raises(NotImplementedError):
        tcolmap.camera_params_to_json(tcolmap.ColmapCamera(1, "FOV", 64, 48, p))
    d = tmp_path / "sparse"
    _write_colmap_model(d, rng)
    assert tcolmap.export_point_cloud_ply(d, tmp_path / "a" / "pc.ply") == 60
    assert jcolmap.export_point_cloud_ply(d, tmp_path / "b" / "pc.ply") == 60
    assert (tmp_path / "a" / "pc.ply").read_bytes() == \
        (tmp_path / "b" / "pc.ply").read_bytes()


def _lookup(imgs, points, value):
    """A synthetic depth image per image name: ``value(z)`` at each
    observed point's pixel."""
    def lookup(name):
        im = next(i for i in imgs.values() if i.name == name)
        rot = jcolmap.qvec_to_rotmat(im.qvec)
        depth = np.zeros((48, 64), np.float64)
        for k, pid in enumerate(im.point3d_ids):
            z = (rot @ points[pid].xyz)[2] + im.tvec[2]
            u, v = im.xys[k].astype(int)
            if 0 <= u < 64 and 0 <= v < 48:
                depth[v, u] = value(z)
        return depth
    return lookup


def test_align_sensor_depth_like_gstk_tpu(tmp_path, rng):
    _write_colmap_model(tmp_path / "sparse", rng)
    _, imgs, points = tcolmap.read_model(tmp_path / "sparse")
    lookup = _lookup(imgs, points, lambda z: z * 0.1 * 1000)
    ours = talign.align_sensor_depth(imgs, points, lookup, 64, 48)
    theirs = jalign.align_sensor_depth(imgs, points, lookup, 64, 48)
    assert ours == theirs
    np.testing.assert_allclose(ours, 0.1, rtol=1e-2)
    with pytest.raises(RuntimeError, match="no overlapping"):
        talign.align_sensor_depth(imgs, points, lambda name: None, 64, 48)


@pytest.mark.parametrize("noise", [0.0, 0.5])
def test_align_mono_depth_like_gstk_tpu(tmp_path, rng, noise):
    _write_colmap_model(tmp_path / "sparse", rng)
    _, imgs, points = tcolmap.read_model(tmp_path / "sparse")
    jitter = np.random.default_rng(3)
    table = {}

    def value(z):  # the same noisy estimate for both packages' calls
        key = round(float(z), 12)
        if key not in table:
            table[key] = 40.0 * z + 10.0 + noise * jitter.normal()
        return table[key]

    lookup = _lookup(imgs, points, value)
    ours = talign.align_mono_depth(imgs, points, lookup, 64, 48)
    theirs = jalign.align_mono_depth(imgs, points, lookup, 64, 48)
    assert ours == theirs
    scales, shifts = ours
    assert len(scales) == 4
    for im_id in scales:
        np.testing.assert_allclose(scales[im_id], 40.0 / 255.0, rtol=5e-2)
        np.testing.assert_allclose(shifts[im_id], 10.0 / 255.0, rtol=2e-1)
