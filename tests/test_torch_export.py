"""gstk_torch's gs-export back end against gstk_tpu's (CPU).

  * ``gaussians.ply`` of one checkpoint byte for byte gstk_tpu's, and
    ``load_gaussian_ply`` back to the checkpoint's alive rows;
  * ``camera-poses`` JSON equal;
  * ``integrate_frames`` on the same numpy frames: against gstk_tpu's
    compiled scan, tsdf and colors within atol 1e-5 on all but 0.1% of
    voxels, and weights equal outside those (XLA rewrites the projection's
    divisions, so a ``round`` of u or v flips at a few .5 points); against
    gstk_tpu's
    ``_integrate_one`` run op by op, bit for bit;
  * ``marching_tetrahedra`` (a copy) equal to gstk_tpu's on the same grid;
    ``poisson_indicator`` within atol 1e-5 of gstk_tpu's; ``clean_mesh``
    equal; the cases of ``tests/test_export.py`` and
    ``tests/test_poisson.py`` on the port;
  * the mask fallbacks and ``tests/test_mask_propagation.py``'s four cases,
    equal to gstk_tpu's; without OpenCV ``propagate_masks`` raises and
    without transformers ``try_load_grounded_sam`` returns False;
  * the export half of ``tests/test_cli_e2e.py::test_cli_end_to_end``
    through the port on a run it trained (``tests/_torch_run.py``), with
    Pillow and PyYAML blocked (OpenCV too but for ``--propagate-masks``),
    plus ``point-cloud``, ``--meshing poisson`` and ``--clean``.
"""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstk_tpu.exporter import mask_generation as jmask
from gstk_tpu.exporter import mask_propagation as jprop
from gstk_tpu.exporter import poisson as jpoisson
from gstk_tpu.exporter import tsdf as jtsdf
from gstk_tpu.exporter.gaussian_ply import load_gaussian_ply as jload_ply
from gstk_tpu.scripts import export as jexport
from gstk_torch.core.gaussians import init_scene, scene_to_numpy
from gstk_torch.exporter import mask_generation as tmask
from gstk_torch.exporter import mask_propagation as tprop
from gstk_torch.exporter import poisson as tpoisson
from gstk_torch.exporter import tsdf as ttsdf
from gstk_torch.exporter.gaussian_ply import export_gaussian_ply, load_gaussian_ply
from gstk_torch.scripts import export as texport
from gstk_torch.train import checkpoint as tckpt
from gstk_torch.utils.io import read_ply

from tests._torch_run import blocked, train_run
from tests.test_mask_propagation import _make_sequence
from tests.test_poisson import _sphere_tsdf

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return train_run(tmp_path_factory.mktemp("torch_run"))


def _port(monkeypatch, argv, names=("PIL", "cv2", "yaml")):
    with blocked(monkeypatch.context, names):
        texport.main([*argv, "--device", "cpu"])


# -- splats and poses --------------------------------------------------------

def test_gaussian_ply_byte_equal_to_jax(run, tmp_path, monkeypatch):
    jexport.main(["gaussian-splat", "--load-config", str(run),
                  "--output-dir", str(tmp_path / "j")])
    _port(monkeypatch, ["gaussian-splat", "--load-config", str(run),
                        "--output-dir", str(tmp_path / "t")])
    got = (tmp_path / "t" / "gaussians.ply").read_bytes()
    assert got == (tmp_path / "j" / "gaussians.ply").read_bytes()
    scene, _ = tckpt.load_scene(tckpt.latest_checkpoint(run.parent / "ckpts"),
                                "cpu")
    want = scene_to_numpy(scene)
    back = scene_to_numpy(load_gaussian_ply(tmp_path / "t" / "gaussians.ply",
                                            device="cpu"))
    alive = want["alive"]
    assert 0 < alive.sum() < len(alive) and back["alive"].all()
    for k in ("means", "scales", "quats", "features_dc", "features_rest",
              "opacities"):
        np.testing.assert_array_equal(back[k], want[k][alive], err_msg=k)
    jback = jload_ply(tmp_path / "t" / "gaussians.ply")
    np.testing.assert_array_equal(np.asarray(jback.features_rest),
                                  back["features_rest"])


def test_gaussian_ply_roundtrip(tmp_path, rng):
    """tests/test_export.py's round trip on the port."""
    pts = rng.normal(size=(30, 3)).astype(np.float32)
    rgb = rng.uniform(0, 255, (30, 3)).astype(np.float32)
    scene = init_scene(torch.Generator().manual_seed(0), 64, (pts, rgb),
                       sh_degree=2, device="cpu")
    scene.features_rest.data.normal_(generator=torch.Generator().manual_seed(1))
    assert export_gaussian_ply(tmp_path / "g.ply", scene) == 30
    back = load_gaussian_ply(tmp_path / "g.ply", device="cpu")
    assert back.capacity == 30
    np.testing.assert_array_equal(back.means.detach().numpy(), pts)
    np.testing.assert_array_equal(back.features_rest.detach().numpy(),
                                  scene.features_rest[:30].detach().numpy())
    with open(tmp_path / "g.ply", "rb") as f:
        header = f.read(2000).split(b"end_header")[0].decode()
    names = [ln.split()[-1] for ln in header.splitlines()
             if ln.startswith("property")]
    assert names[:9] == ["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1",
                         "f_dc_2"]
    assert names[-8:] == ["opacity", "scale_0", "scale_1", "scale_2",
                          "rot_0", "rot_1", "rot_2", "rot_3"]


def test_camera_poses_equal_to_jax(run, tmp_path, monkeypatch):
    jexport.main(["camera-poses", "--load-config", str(run),
                  "--output-dir", str(tmp_path / "j")])
    _port(monkeypatch, ["camera-poses", "--load-config", str(run),
                        "--output-dir", str(tmp_path / "t")])
    for split, n in (("train", 4), ("eval", 2)):
        got = json.loads((tmp_path / "t" / f"{split}_poses.json").read_text())
        assert got == json.loads(
            (tmp_path / "j" / f"{split}_poses.json").read_text())
        assert len(got) == n


# -- TSDF --------------------------------------------------------------------

def _frames(rng, n=3, h=48, w=48):
    depths = (2.0 + 0.3 * rng.uniform(-1, 1, (n, h, w))).astype(np.float32)
    depths[:, :5] = 0  # invalid rows
    colors = rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    intr = np.tile(np.array([[40, 40, 24, 24]], np.float32), (n, 1))
    w2cs = np.stack([np.eye(4, dtype=np.float32)] * n)
    w2cs[1, :3, 3] = [0.1, 0.0, 0.0]
    w2cs[2, :3, 3] = [0.0, 0.05, 0.1]
    c, s = np.cos(0.1), np.sin(0.1)
    w2cs[2, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    return depths, colors, intr, w2cs


def test_integrate_frames_matches_jax(rng):
    depths, colors, intr, w2cs = _frames(rng)
    box = ((-1.5, -1.5, 0.5), (3, 3, 3), 0.05)
    want = jtsdf.integrate_frames(jtsdf.make_volume(*box), jnp.asarray(depths),
                                  jnp.asarray(colors), jnp.asarray(intr),
                                  jnp.asarray(w2cs), 0.15)
    got = ttsdf.integrate_frames(ttsdf.make_volume(*box, device="cpu"), depths,
                                 colors, intr, w2cs, 0.15)
    assert got.tsdf.shape == (60, 60, 60) and float(got.weights.max()) == 3
    outside = np.zeros(got.tsdf.shape, bool)
    for k in ("tsdf", "colors"):
        bad = ~np.isclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                          rtol=0, atol=1e-5)
        outside |= bad if bad.ndim == 3 else bad.any(-1)
    assert outside.mean() <= 1e-3, outside.sum()
    np.testing.assert_array_equal(got.weights.numpy()[~outside],
                                  np.asarray(want.weights)[~outside])
    # gstk_tpu's step run op by op (no XLA rewrites): the same bits
    vol = jtsdf.make_volume(*box)
    for i in range(len(depths)):
        vol = jtsdf._integrate_one(vol, jnp.asarray(depths[i]),
                                   jnp.asarray(colors[i]), jnp.asarray(intr[i]),
                                   jnp.asarray(w2cs[i]), 0.15)
    for k in ("tsdf", "weights", "colors"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(vol, k)), err_msg=k)


def test_marching_tetrahedra_sphere_matches_jax():
    """tests/test_export.py's sphere on the port, and the same mesh as
    gstk_tpu's."""
    n = 24
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float64)
    center = (n - 1) / 2
    sdf = (np.sqrt(((g - center) ** 2).sum(axis=0)) - 8.0) / 4.0
    verts, faces, _ = ttsdf.marching_tetrahedra(sdf, voxel_size=1.0)
    assert len(verts) > 100 and len(faces) > 100
    r = np.linalg.norm(verts - center, axis=-1)
    np.testing.assert_allclose(r.mean(), 8.0, atol=0.2)
    assert r.std() < 0.2 and faces.max() < len(verts)
    jverts, jfaces, _ = jtsdf.marching_tetrahedra(sdf, voxel_size=1.0)
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)


def test_tsdf_integration_box(tmp_path):
    """tests/test_export.py's wall at z = 2 on the port, meshed and written."""
    h = w = 48
    vol = ttsdf.make_volume((-1.5, -1.5, 0.5), (3, 3, 3), 0.05, device="cpu")
    vol = ttsdf.integrate_frames(
        vol, np.full((1, h, w), 2.0, np.float32),
        np.full((1, h, w, 3), 0.5, np.float32),
        np.array([[40.0, 40.0, w / 2, h / 2]], np.float32),
        np.eye(4, dtype=np.float32)[None], sdf_trunc=0.15)
    assert float(vol.weights.max()) > 0
    verts, faces, cols = ttsdf.marching_tetrahedra(
        vol.tsdf.numpy(), vol.weights.numpy(), vol.colors.numpy(),
        origin=(-1.5, -1.5, 0.5), voxel_size=0.05)
    assert len(verts) > 50
    np.testing.assert_allclose(verts[:, 2].mean(), 2.0, atol=0.05)
    ttsdf.write_mesh_ply(tmp_path / "mesh.ply", verts, faces, cols)
    jtsdf.write_mesh_ply(tmp_path / "jmesh.ply", verts, faces, cols)
    assert (tmp_path / "mesh.ply").read_bytes() == (tmp_path / "jmesh.ply").read_bytes()
    ply = read_ply(tmp_path / "mesh.ply")
    assert len(ply["vertex"]) == len(verts) and len(ply["face"]) == len(faces)


# -- Poisson and cleanup ------------------------------------------------------

@pytest.mark.parametrize("with_weights", [True, False])
def test_poisson_indicator_matches_jax(with_weights):
    tsdf, w, _ = _sphere_tsdf(n=32)
    w = w if with_weights else None
    got = tpoisson.poisson_indicator(tsdf, w, iters=60, device="cpu")
    want = jpoisson.poisson_indicator(tsdf, w, iters=60)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_poisson_indicator_sign():
    """tests/test_poisson.py's sign and radius checks on the port."""
    tsdf, w, _ = _sphere_tsdf()
    chi = tpoisson.poisson_indicator(tsdf, w, iters=120, device="cpu")
    n = tsdf.shape[0]
    c = n // 2
    assert chi[c, c, c] < 0 and chi[2, 2, 2] > 0
    line = chi[c, c, :]
    crossings = np.where(np.diff(np.sign(line)) != 0)[0]
    radii = np.abs(np.linspace(-1, 1, n)[crossings])
    assert np.all(np.abs(radii - 0.6) < 0.08)


def test_poisson_mesh_sphere_and_clean():
    tsdf, w, colors = _sphere_tsdf()
    n = tsdf.shape[0]
    verts, faces, vcols = tpoisson.poisson_mesh(
        tsdf, w, colors, origin=np.array([-1.0, -1.0, -1.0]),
        voxel_size=2.0 / (n - 1), iters=120, device="cpu")
    assert len(verts) > 500 and len(faces) > 500
    radii = np.linalg.norm(verts, axis=1)
    assert abs(np.median(radii) - 0.6) < 0.03 and radii.std() < 0.03
    noisy = verts + np.random.default_rng(0).normal(0, 0.01, verts.shape).astype(
        np.float32)
    got = tpoisson.clean_mesh(noisy, faces, vcols, smooth_iters=3)
    want = jpoisson.clean_mesh(noisy, faces, vcols, smooth_iters=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert np.linalg.norm(got[0], axis=1).std() < np.linalg.norm(noisy, axis=1).std()


def test_clean_mesh_drops_small_components():
    v1 = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    f1 = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]])
    v2 = np.array([[5, 5, 5], [5.1, 5, 5], [5, 5.1, 5]], np.float32)
    verts = np.concatenate([v1, v2])
    faces = np.concatenate([f1, np.array([[4, 5, 6]])])
    cv, cf, _ = tpoisson.clean_mesh(verts, faces, min_component_frac=0.9)
    assert len(cv) == 4 and len(cf) == 4 and cf.max() < len(cv)


# -- masks -------------------------------------------------------------------

def test_mask_fallbacks_match_jax(rng, monkeypatch):
    # "fake" stays out of the shared registry
    monkeypatch.setattr(tmask, "_MASK_MODELS", dict(tmask._MASK_MODELS))
    imgs = [rng.uniform(0, 1, (16, 20, 3)).astype(np.float32)] * 2
    accs = [rng.uniform(0, 1, (16, 20)).astype(np.float32)] * 2
    for kw in (dict(method="threshold", accumulations=accs),
               dict(method="box", box=(0.25, 0.25, 0.75, 0.75)),
               dict(method="none")):
        got, want = tmask.generate_masks(imgs, **kw), jmask.generate_masks(imgs, **kw)
        assert len(got) == 2 and got[0].dtype == bool and got[0].shape == (16, 20)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert tmask.generate_masks(imgs, method="box", box=(0.25, 0.25, 0.75, 0.75))[0].sum() == 80
    tmask.register_mask_model("fake", lambda ims, prompt: [
        np.zeros(im.shape[:2], bool) for im in ims])
    assert not tmask.generate_masks(imgs, prompt="a cup", method="fake")[0].any()
    with pytest.raises(ValueError, match="unknown mask method"):
        tmask.generate_masks(imgs, method="nope")


def test_grounded_sam_without_checkpoints_or_transformers(tmp_path, monkeypatch):
    monkeypatch.delenv("GSTK_GDINO_MODEL_DIR", raising=False)
    monkeypatch.delenv("GSTK_SAM_MODEL_DIR", raising=False)
    assert tmask.try_load_grounded_sam() is False
    assert tmask.try_load_grounded_sam(tmp_path / "no", tmp_path / "no") is False
    (tmp_path / "g").mkdir()
    (tmp_path / "s").mkdir()
    monkeypatch.setitem(sys.modules, "transformers", None)
    assert tmask.try_load_grounded_sam(tmp_path / "g", tmp_path / "s") is False


def _propagation_cases():
    frames, gts = _make_sequence()
    wrong = np.zeros_like(gts[0])
    wrong[2:20, 2:20] = True
    mid = [g.copy() for g in gts]
    mid[3], mid[5] = np.zeros_like(mid[3]), wrong
    ends = [g.copy() for g in gts]
    ends[0], ends[-1] = wrong, np.zeros_like(ends[-1])
    one_f, one_g = _make_sequence(n_frames=1)
    return {"dropout_and_flicker": (frames, mid), "endpoints": (frames, ends),
            "consistent": (frames, [g.copy() for g in gts]),
            "one_frame": (one_f, one_g)}


@pytest.mark.parametrize("case", ["dropout_and_flicker", "endpoints",
                                  "consistent", "one_frame"])
def test_mask_propagation_matches_jax(case):
    frames, dets = _propagation_cases()[case]
    got = tprop.propagate_masks(frames, dets)
    want = jprop.propagate_masks(frames, dets)
    assert len(got) == len(want) == len(frames)
    for a, b in zip(got, want):
        assert a.dtype == bool
        np.testing.assert_array_equal(a, b)


def test_mask_propagation_without_opencv_raises(monkeypatch):
    frames, gts = _make_sequence(n_frames=3)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="--propagate-masks"):
        tprop.propagate_masks(frames, gts)
    with pytest.raises(ImportError, match="--propagate-masks"):
        tprop.propagate_masks(frames[:1], gts[:1])


# -- the export CLI end to end -------------------------------------------------

def test_export_cli_end_to_end(run, tmp_path, monkeypatch):
    """test_cli_end_to_end's export half through the port, then the
    point cloud, the Poisson backend and the cleanup; the meshes against
    gstk_tpu's from the same run."""
    tsdf_args = ["--load-config", str(run), "--voxel-size", "0.05",
                 "--volume-size", "3.0", "--sdf-trunc", "0.15"]
    for name, extra, names in (
        ("plain", [], None),
        ("masked", ["--mask-method", "threshold", "--propagate-masks"],
         ("PIL", "yaml")),
        ("poisson", ["--meshing", "poisson", "--poisson-iters", "50",
                     "--clean", "--smooth-iters", "1", "--mask-method", "box",
                     "--mask-box", "0.1", "0.1", "0.9", "0.9"], None),
    ):
        out = tmp_path / name
        kw = {} if names is None else {"names": names}
        _port(monkeypatch, ["offline-tsdf", "--output-dir", str(out),
                            *tsdf_args, *extra], **kw)
        jexport.main(["offline-tsdf", "--output-dir", str(tmp_path / f"j{name}"),
                      *tsdf_args, *extra])
        got = read_ply(out / "tsdf_mesh.ply")
        want = read_ply(tmp_path / f"j{name}" / "tsdf_mesh.ply")
        assert len(got["face"]) > 0, name
        assert set(got["vertex"].dtype.names) >= {"x", "y", "z", "red", "green", "blue"}
        n_t, n_j = len(got["vertex"]), len(want["vertex"])
        assert abs(n_t - n_j) <= 0.05 * n_j, (name, n_t, n_j)
    _port(monkeypatch, ["point-cloud", "--load-config", str(run),
                        "--output-dir", str(tmp_path / "pc"),
                        "--num-points", "2000"])
    jexport.main(["point-cloud", "--load-config", str(run),
                  "--output-dir", str(tmp_path / "jpc"), "--num-points", "2000"])
    got = read_ply(tmp_path / "pc" / "point_cloud.ply")["vertex"]
    want = read_ply(tmp_path / "jpc" / "point_cloud.ply")["vertex"]
    assert got.dtype == want.dtype and abs(len(got) - len(want)) <= 0.01 * len(want)
    assert 0 < len(got) <= 2000
    xyz = np.stack([got[k] for k in "xyz"], -1)
    jxyz = np.stack([want[k] for k in "xyz"], -1)
    np.testing.assert_allclose(xyz.mean(0), jxyz.mean(0), atol=0.05)
