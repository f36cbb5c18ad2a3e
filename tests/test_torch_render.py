"""gstk_torch scene, checkpoint, render_scene and Renderer against gstk_tpu
on the same scene (CPU).

Images, alpha and depth are held to gstk_tpu's parity tolerances
(utils/parity.py: rtol 1e-3, atol 1e-4); parameters that only move between
numpy and torch must be equal.

The two packages project independently, so conics differ by a few ulps and
an entry whose alpha lands within rounding of the 1/255 cutoff is composited
by one and skipped by the other. Such a pixel differs by up to one cutoff
contribution (< 1/255 in rgb and alpha, more in depth, which divides by
alpha). The render checks therefore allow at most 0.1% of pixels outside the
tolerances, with rgb and alpha there within 1/255; ROADMAP.md (Queue 3)
records the measured case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstk_tpu.core import cameras as jcam
from gstk_tpu.core import gaussians as jgs
from gstk_tpu.models import vanilla as jvan
from gstk_tpu.render.renderer import Renderer as JaxRenderer
from gstk_tpu.train import checkpoint as jckpt
from gstk_tpu.train.step import init_train_state
from gstk_torch import resolve_device
from gstk_torch.core import cameras as tcam
from gstk_torch.core import gaussians as tgs
from gstk_torch.models import vanilla as tvan
from gstk_torch.render.renderer import Renderer
from gstk_torch.train import checkpoint as tckpt

torch.set_num_threads(2)

PARITY = dict(rtol=1e-3, atol=1e-4)
H, W = 48, 64
FX = FY = 0.5 * W / np.tan(0.5 * np.deg2rad(60.0))


def _scene_arrays(rng, n=300, capacity=320, sh_degree=3):
    """A scene in front of an identity OpenGL camera (looking along -z),
    padded with dead lanes."""
    k = (sh_degree + 1) ** 2
    means = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2.25, 2.25, n),
                      rng.uniform(-8, -2, n)], -1)
    arrays = {
        "means": means,
        "scales": rng.uniform(-2.5, -0.5, (n, 3)),
        "quats": rng.normal(size=(n, 4)),
        "features_dc": rng.normal(size=(n, 3)),
        "features_rest": 0.3 * rng.normal(size=(n, k - 1, 3)),
        "opacities": rng.uniform(-1.5, 3.0, (n, 1)),
    }
    for key, v in arrays.items():
        pad = np.zeros((capacity - n,) + v.shape[1:])
        if key == "quats":
            pad[:, 0] = 1.0
        arrays[key] = np.concatenate([v, pad]).astype(np.float32)
    alive = np.zeros(capacity, bool)
    alive[:n] = True
    alive[::17] = False  # a few dead lanes among the live ones
    arrays["alive"] = alive
    return arrays


def _jax_scene(arrays):
    return jgs.GaussianScene(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _c2w(rng, scale=0.05):
    """Identity pose nudged by a small rotation and translation."""
    a = scale * rng.normal(size=3)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    R = np.eye(3) + K + 0.5 * K @ K
    u, _, vt = np.linalg.svd(R)
    return np.concatenate([u @ vt, scale * rng.normal(size=(3, 1))], 1).astype(
        np.float32
    )


def _check_outputs(out_t, out_j, keys):
    """Parity on all but at most 0.1% of pixels; there, rgb and alpha are
    within one 1/255-cutoff flip (see the module docstring)."""
    outside = np.zeros((H, W), bool)
    for k in keys:
        a, b = np.asarray(out_t[k]), np.asarray(out_j[k])
        assert a.shape == b.shape and np.isfinite(a).all(), k
        bad = ~np.isclose(a, b, **PARITY)
        outside |= bad if bad.ndim == 2 else bad.any(-1)
    assert outside.mean() <= 1e-3, f"{outside.sum()} pixels outside tolerance"
    for k in keys:
        if k != "depth":
            diff = np.abs(np.asarray(out_t[k]) - np.asarray(out_j[k]))
            assert diff.max() <= 1.0 / 255.0 + PARITY["atol"], (k, diff.max())


@pytest.mark.parametrize("sh_degree", [3, 0])
def test_render_scene_matches_jax(rng, sh_degree):
    arrays = _scene_arrays(rng, sh_degree=sh_degree)
    c2w = _c2w(rng)
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    cfg_kw = dict(sh_degree=sh_degree)
    jcamera = jcam.Camera(fx=jnp.float32(FX), fy=jnp.float32(FY),
                          cx=jnp.float32(W / 2), cy=jnp.float32(H / 2),
                          c2w=jnp.asarray(c2w))
    out_j = jvan.render_scene(
        _jax_scene(arrays), jcamera, H, W, sh_degree=sh_degree,
        background=jnp.asarray(bg), config=jvan.VanillaConfig(**cfg_kw),
        raster_config=jvan.RasterizeConfig(isect_capacity=1 << 14),
    )
    scene = tgs.scene_from_numpy(arrays, device="cpu")
    camera = tcam.Camera.create(FX, FY, W / 2, H / 2, c2w, device="cpu")
    with torch.no_grad():
        out_t = tvan.render_scene(
            scene, camera, H, W, sh_degree=sh_degree,
            background=torch.from_numpy(bg), config=tvan.VanillaConfig(**cfg_kw),
            raster_config=tvan.RasterizeConfig(isect_capacity=1 << 14),
        )
    assert out_t["rgb"].shape == (H, W, 3)
    assert 0.1 < float(out_t["alpha"].mean()) < 0.99  # a scene, not a blank
    _check_outputs(out_t, out_j, ("rgb", "depth", "alpha"))
    assert np.mean(out_t["radii"].numpy() != np.asarray(out_j["radii"])) <= 0.01
    n_t, n_j = int(out_t["num_intersects"]), int(out_j["num_intersects"])
    assert abs(n_t - n_j) <= 0.01 * n_j


def test_renderer_matches_jax_renderer_on_jax_checkpoint(rng, tmp_path):
    arrays = _scene_arrays(rng)
    state = init_train_state(_jax_scene(arrays))._replace(step=jnp.int32(1234))
    jckpt.save_checkpoint(
        tmp_path / "ckpts", state,
        extras={"isect_capacity": 1 << 12, "bands": 0, "sh_degree": 2},
    )
    jr = JaxRenderer(tmp_path)
    tr = Renderer(tmp_path, device="cpu")
    assert tr.step == jr.step == 1234
    assert tr.sh_degree == jr.sh_degree == 2
    assert tr.raster_config.isect_capacity == jr.raster_config.isect_capacity
    for _ in range(2):
        c2w = _c2w(rng)
        args = (c2w, FX, FY, W / 2, H / 2, H, W)
        out_t, out_j = tr.get_output_from_pose(*args), jr.get_output_from_pose(*args)
        _check_outputs(out_t, out_j, ("rgb", "depth", "accumulation"))
        assert 0 < out_t["num_intersects"] <= tr.raster_config.isect_capacity


def test_scene_numpy_and_checkpoint_round_trip(rng, tmp_path):
    arrays = _scene_arrays(rng)
    scene = tgs.scene_from_numpy(arrays, device="cpu")
    assert isinstance(scene.means, torch.nn.Parameter)
    assert scene.capacity == 320 and int(scene.num_alive) == arrays["alive"].sum()
    back = tgs.scene_to_numpy(scene)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # a scene written by the port loads in gstk_tpu, and the reverse
    path = tckpt.save_scene(tmp_path, scene, step=7, extras={"bands": 2})
    jscene, jstep = jckpt.load_scene(path)
    assert jstep == 7 and jckpt.peek_meta(path) == tckpt.peek_meta(path) == {"bands": 2}
    for k in tgs.FIELD_NAMES:
        np.testing.assert_array_equal(np.asarray(getattr(jscene, k)), arrays[k])
    assert tckpt.latest_checkpoint(tmp_path) == jckpt.latest_checkpoint(tmp_path)
    assert tckpt.peek_capacity(path) == jckpt.peek_capacity(path) == 320
    jpath = jckpt.save_checkpoint(tmp_path / "j", init_train_state(jscene))
    loaded, step = tckpt.load_scene(jpath, device="cpu")
    assert step == 0
    for k, v in tgs.scene_to_numpy(loaded).items():
        np.testing.assert_array_equal(v, arrays[k], err_msg=k)


def test_init_and_grow_scene_match_jax(rng):
    pts = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    rgb = rng.uniform(0, 255, (200, 3)).astype(np.float32)
    js = jgs.init_scene(jax.random.PRNGKey(0), 256, (pts, rgb), sh_degree=2)
    ts = tgs.init_scene(torch.Generator().manual_seed(0), 256, (pts, rgb),
                        sh_degree=2, device="cpu")
    got = tgs.scene_to_numpy(ts)
    # random quats come from different generators; all else is deterministic
    for k in ("means", "scales", "features_dc", "features_rest", "opacities", "alive"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(js, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(np.linalg.norm(got["quats"][:200], axis=-1), 1.0,
                               rtol=1e-5)
    grown = tgs.scene_to_numpy(tgs.grow_scene(ts, 300))
    jgrown = jgs.grow_scene(js, 300)
    for k in tgs.FIELD_NAMES:
        if k != "quats":
            np.testing.assert_allclose(grown[k], np.asarray(getattr(jgrown, k)),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(grown["quats"][256:], np.asarray(jgrown.quats)[256:])


def test_small_model_functions_match_jax():
    cfg = tvan.VanillaConfig()
    assert [f.name for f in tvan.dataclasses.fields(cfg)] == [
        f.name for f in jvan.dataclasses.fields(jvan.VanillaConfig())
    ]
    for step in (0, 999, 1000, 2500, 10_000):
        assert int(tvan.active_sh_degree(cfg, step)) == int(
            jvan.active_sh_degree(jvan.VanillaConfig(), jnp.int32(step))
        )
        assert tvan.downscale_factor(cfg, step) == jvan.downscale_factor(
            jvan.VanillaConfig(), step
        )
    img = np.random.default_rng(1).uniform(0, 1, (4, 5, 4)).astype(np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    np.testing.assert_allclose(
        tvan.composite_gt_with_background(torch.from_numpy(img), torch.from_numpy(bg)).numpy(),
        np.asarray(jvan.composite_gt_with_background(jnp.asarray(img), jnp.asarray(bg))),
        rtol=1e-6, atol=1e-7,
    )


def test_entry_points_raise_without_cuda_and_device(rng, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tckpt.save_scene(tmp_path, tgs.scene_from_numpy(_scene_arrays(rng), "cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Renderer(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_cutoff_flip_gaussian_against_float64_oracle():
    """The one pixel of ``test_render_scene_matches_jax[0]`` that differs
    (ROADMAP Queue 3): Gaussian 31's alpha at pixel (14, 37) sits within
    rounding of 1/255. Each package's projection is held against the
    float64 oracle (gstk_tpu/ops/oracle.py) fed a float64 camera; the
    printed numbers say which package is nearer. Both conics are within
    1e-6 relative of the oracle and both centers within 1e-5 px: the flip
    is rounding, not a formula difference."""
    import math

    from gstk_tpu.ops import oracle
    from gstk_tpu.ops import projection as jproj
    from gstk_tpu.utils.math import normalize as jnorm
    from gstk_torch.ops import projection as tproj
    from gstk_torch.utils.math import normalize as tnorm

    rng = np.random.default_rng(0)  # the rng fixture's seed
    arrays = _scene_arrays(rng, sh_degree=0)
    c2w = _c2w(rng)
    g, px, py = 31, 14, 37
    jcamera = jcam.Camera(fx=jnp.float32(FX), fy=jnp.float32(FY),
                          cx=jnp.float32(W / 2), cy=jnp.float32(H / 2),
                          c2w=jnp.asarray(c2w))
    jview, jfull = jcam.camera_matrices(jcamera, H, W)
    jp = jproj.project_gaussians(
        jnp.asarray(arrays["means"]), jnp.exp(jnp.asarray(arrays["scales"])),
        1.0, jnorm(jnp.asarray(arrays["quats"])), jview, jfull, jcamera.fx,
        jcamera.fy, jcamera.cx, jcamera.cy, H, W,
    )
    tcamera = tcam.Camera.create(FX, FY, W / 2, H / 2, c2w, device="cpu")
    tview, tfull = tcam.camera_matrices(tcamera, H, W)
    tp = tproj.project_gaussians(
        torch.from_numpy(arrays["means"]), torch.exp(torch.from_numpy(arrays["scales"])),
        1.0, tnorm(torch.from_numpy(arrays["quats"])), tview, tfull, tcamera.fx,
        tcamera.fy, tcamera.cx, tcamera.cy, H, W,
    )
    # the float64 camera: the view matrix is exact in f32 in both packages
    np.testing.assert_array_equal(np.asarray(jview), tview.numpy())
    view = np.asarray(jview, np.float64)
    n, f = 0.001, 1000.0
    tan_x, tan_y = 0.5 * W / FX, 0.5 * H / FY
    proj = np.array([[1 / tan_x, 0, 0, 0], [0, 1 / tan_y, 0, 0],
                     [0, 0, (f + n) / (f - n), -f * n / (f - n)], [0, 0, 1, 0]])
    q = arrays["quats"].astype(np.float64)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    o = oracle.project_gaussians_np(
        arrays["means"].astype(np.float64),
        np.exp(arrays["scales"].astype(np.float64)), 1.0, q, view, proj @ view,
        FX, FY, W / 2, H / 2, H, W,
    )
    op = 1.0 / (1.0 + math.exp(-float(arrays["opacities"][g, 0])))

    def alpha255(xy, conic):
        dx, dy = xy[0] - px, xy[1] - py
        a, b, c = conic
        return 255.0 * op * math.exp(-(0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy))

    ref_xy, ref_conic = np.asarray(o["xys"][g], np.float64), np.asarray(o["conics"][g], np.float64)
    print(f"(proj @ view)[0, 0]: float64 {(proj @ view)[0, 0]!r}, gstk_tpu "
          f"{float(jfull[0, 0])!r}, gstk_torch {float(tfull[0, 0])!r}")
    print(f"oracle: xy {ref_xy}, conic {ref_conic}, 255 alpha {alpha255(ref_xy, ref_conic)!r}")
    for name, p in (("gstk_tpu", jp), ("gstk_torch", tp)):
        xy = np.asarray(p.xys[g], np.float64)
        conic = np.asarray(p.conics[g], np.float64)
        print(f"{name}: xy err {np.abs(xy - ref_xy)}, conic rel err "
              f"{np.abs(conic - ref_conic) / np.abs(ref_conic)}, 255 alpha "
              f"{alpha255(xy, conic)!r}")
        np.testing.assert_allclose(conic, ref_conic, rtol=1e-6)
        np.testing.assert_allclose(xy, ref_xy, rtol=0, atol=1e-5)
    assert abs(alpha255(ref_xy, ref_conic) - 1.0) < 1e-5  # on the cutoff
