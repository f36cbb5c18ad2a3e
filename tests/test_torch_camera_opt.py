"""gstk_torch's camera optimisation (``core/camera_opt.py`` and the
camera-opt group of the train step) on the CPU: gstk_tpu's camera tests
(``tests/test_viewer_and_camera_opt.py``, ``tests/test_train.py``'s pose
recovery) ported, and the exp maps, ``apply_to_camera``, the pose penalty
and the group's learning-rate schedule against gstk_tpu's.

Values are held at rtol 1e-5 / atol 1e-6 (the maps are a few dozen f32
operations) and gradients at rtol 5e-3 / atol 1e-4 max|g|
(``gstk_tpu/utils/parity.py``'s gradient tolerance), at the zero
adjustment, where every step starts, and away from it.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstk_tpu.core import camera_opt as jco
from gstk_tpu.core.cameras import Camera as JCamera
from gstk_tpu.train import optim as jopt
from gstk_torch.core import camera_opt as tco
from gstk_torch.core.cameras import Camera
from gstk_torch.core.gaussians import init_scene, scene_from_numpy, scene_to_numpy
from gstk_torch.models.vanilla import VanillaConfig, render_scene
from gstk_torch.ops.rasterize import RasterizeConfig
from gstk_torch.train.optim import OptimizerConfig
from gstk_torch.train.step import init_train_state, make_train_step

torch.set_num_threads(2)

RTOL_GRAD = 5e-3
MAPS = {"SO3xR3": (jco.exp_map_so3xr3, tco.exp_map_so3xr3),
        "SE3": (jco.exp_map_se3, tco.exp_map_se3)}
TANGENTS = {
    "zero": np.zeros(6, np.float32),
    "tiny": np.array([1e-3, -2e-3, 5e-4, 3e-8, -2e-8, 1e-8], np.float32),
    "small": np.array([0.05, -0.02, 0.03, 0.01, -0.04, 0.02], np.float32),
    "large": np.array([0.8, -0.5, 0.3, 1.1, -0.7, 0.4], np.float32),
}


def _camera(c2w=None):
    c2w = np.eye(4, dtype=np.float32)[:3] if c2w is None else c2w
    return Camera.create(50.0, 50.0, 32.0, 24.0, c2w, device="cpu")


def _jcamera(c2w):
    return JCamera(fx=jnp.float32(50), fy=jnp.float32(50), cx=jnp.float32(32),
                   cy=jnp.float32(24), c2w=jnp.asarray(c2w))


def _grad_close(name, got, want):
    want = np.asarray(want)
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=RTOL_GRAD,
                               atol=1e-4 * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def test_exp_map_identity():
    for exp_map in (tco.exp_map_so3xr3, tco.exp_map_se3):
        out = exp_map(torch.zeros(6))
        np.testing.assert_allclose(out.numpy(), np.eye(4)[:3], atol=1e-7)


def test_exp_map_rotation():
    # rotate pi/2 around z
    t = torch.tensor([0, 0, 0, 0, 0, np.pi / 2], dtype=torch.float32)
    R = tco.exp_map_so3xr3(t)[:3, :3].numpy()
    np.testing.assert_allclose(R, [[0, -1, 0], [1, 0, 0], [0, 0, 1]], atol=1e-6)


def test_se3_translation_couples_rotation():
    rho = torch.tensor([1.0, 0, 0, 0, 0, np.pi / 2], dtype=torch.float32)
    t = tco.exp_map_se3(rho)[:3, 3].numpy()
    assert not np.allclose(t, [1, 0, 0])
    assert 0.5 < np.linalg.norm(t) < 1.5


def test_apply_to_camera_identity():
    cam = _camera()
    adj = tco.init_camera_opt(5)
    assert adj.shape == (5, 6) and adj.dtype == torch.float32
    out = tco.apply_to_camera(cam, adj[0])
    np.testing.assert_allclose(out.c2w.numpy(), cam.c2w.numpy(), atol=1e-7)
    assert tco.apply_to_camera(cam, adj[0], mode="off") is cam


def test_apply_to_camera_gradients():
    cam = _camera()
    adj = torch.full((6,), 0.01, requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(tco.apply_to_camera(cam, adj).c2w ** 2),
                               [adj])
    assert torch.isfinite(g).all() and g.abs().max() > 0


def _random_c2w(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)
    return np.concatenate([R, rng.normal(size=(3, 1))], axis=1).astype(np.float32)


def test_apply_to_camera_right_multiplies():
    """Parity with the reference composition bmm(c2w, adj)."""
    rng = np.random.default_rng(3)
    c2w = _random_c2w(rng)
    cam = _camera(c2w)
    tangent = torch.tensor(rng.normal(scale=0.1, size=6), dtype=torch.float32)
    for mode, (_, exp_map) in MAPS.items():
        got = tco.apply_to_camera(cam, tangent, mode=mode).c2w.numpy()
        adj4 = np.eye(4, dtype=np.float32)
        adj4[:3] = exp_map(tangent).numpy()
        c2w4 = np.eye(4, dtype=np.float32)
        c2w4[:3] = c2w
        np.testing.assert_allclose(got, (c2w4 @ adj4)[:3], atol=1e-5)


@pytest.mark.parametrize("tangent", list(TANGENTS))
@pytest.mark.parametrize("mode", list(MAPS))
def test_exp_maps_and_apply_match_jax(mode, tangent):
    """The exp map and ``apply_to_camera`` (value, and the gradient of a
    random linear function of the result by the tangent) against
    gstk_tpu's, a batch of three too."""
    jmap, tmap = MAPS[mode]
    rng = np.random.default_rng(7)
    x = TANGENTS[tangent]
    w = rng.normal(size=(3, 4)).astype(np.float32)
    jval, jg = jax.value_and_grad(lambda t: jnp.sum(jmap(t) * w))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    val = torch.sum(tmap(xt) * torch.from_numpy(w))
    (g,) = torch.autograd.grad(val, [xt])
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5,
                               atol=1e-6)
    _grad_close(f"{mode} {tangent} exp map grad", g.numpy(), jg)
    batch = np.stack([x, 0.5 * x, np.roll(x, 2)])
    np.testing.assert_allclose(tmap(torch.from_numpy(batch)).numpy(),
                               np.asarray(jmap(jnp.asarray(batch))),
                               rtol=1e-5, atol=1e-6)

    c2w = _random_c2w(rng)
    jcam = _jcamera(c2w)
    jval, jg = jax.value_and_grad(
        lambda t: jnp.sum(jco.apply_to_camera(jcam, t, mode).c2w * w)
    )(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    val = torch.sum(tco.apply_to_camera(_camera(c2w), xt, mode).c2w
                    * torch.from_numpy(w))
    (g,) = torch.autograd.grad(val, [xt])
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5,
                               atol=1e-5)
    _grad_close(f"{mode} {tangent} apply_to_camera grad", g.numpy(), jg)


def test_pose_regularizer_matches_jax():
    rng = np.random.default_rng(2)
    adj = rng.normal(scale=0.05, size=(7, 6)).astype(np.float32)
    adj[2] = 0.0  # a camera that has not moved: the safe norm's 0
    cfg_j, cfg_t = jco.CameraOptConfig(), tco.CameraOptConfig()
    jval, jg = jax.value_and_grad(
        lambda a: jco.pose_regularizer(a, cfg_j))(jnp.asarray(adj))
    a = torch.tensor(adj, requires_grad=True)
    val = tco.pose_regularizer(a, cfg_t)
    (g,) = torch.autograd.grad(val, [a])
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    _grad_close("pose regularizer grad", g.numpy(), jg)
    assert not g[2].any()


def test_camera_group_schedule_matches_jax():
    """The camera-opt group's Adam (lr 1e-3 decayed exponentially to 5e-5
    over 30k steps, as the step configures it) at every 250th step of the
    schedule and past its end."""
    co = tco.CameraOptConfig()
    kw = lambda lr_final: dict(lrs=(("camera_opt", co.lr),), eps=1e-15,
                               extra_exp=(("camera_opt", lr_final, co.max_steps),))
    jcfg = jopt.OptimizerConfig(**kw(co.lr_final))
    tcfg = OptimizerConfig(**kw(co.lr_final))
    jfn, tfn = jcfg.schedule_for("camera_opt"), tcfg.schedule_for("camera_opt")
    for s in list(range(0, 30_001, 250)) + [29_999, 30_001, 45_000]:
        got = tfn(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jfn(jnp.int32(s))),
                                   rtol=1e-6, err_msg=str(s))
    assert float(tfn(torch.tensor(30_000))) == pytest.approx(co.lr_final, rel=1e-6)


H, W = 40, 56
RASTER = RasterizeConfig(chunk_size=16, isect_capacity=1 << 13)
POSE_STEPS = 160


def _cameras(n):
    cams = []
    for i in range(n):
        ang = 0.3 * (i - n / 2) / n
        c, s = np.cos(ang), np.sin(ang)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        c2w = np.zeros((3, 4), np.float32)
        c2w[:3, :3] = rot
        c2w[:3, 3] = rot @ np.array([0, 0, 5.0], np.float32)
        cams.append(Camera.create(50.0, 50.0, W / 2, H / 2, c2w, device="cpu"))
    return cams


def _gt_scene(rng, n=120, capacity=128):
    pts = rng.uniform(-1.6, 1.6, (n, 3)).astype(np.float32)
    rgb = rng.uniform(40, 215, (n, 3)).astype(np.float32)
    arrays = scene_to_numpy(init_scene(torch.Generator().manual_seed(7),
                                       capacity, (pts, rgb), sh_degree=0,
                                       device="cpu"))
    # opaque-ish, so that the images have structure
    arrays["opacities"][:] = 1.5
    arrays["scales"] = arrays["scales"] + np.float32(0.5)
    return scene_from_numpy(arrays, "cpu")


def test_camera_opt_recovers_pose():
    """With the scene held at ground truth and perturbed training cameras,
    the camera-opt group absorbs the pose error and raises the PSNR
    (gstk_tpu's test, at fewer steps)."""
    rng = np.random.default_rng(0)
    gt_scene = _gt_scene(rng)
    cams = _cameras(2)
    cfg = VanillaConfig(background_color="black", sh_degree=0)
    with torch.no_grad():
        gt_imgs = [render_scene(gt_scene, c, H, W, sh_degree=0, config=cfg,
                                background=torch.zeros(3),
                                raster_config=RASTER)["rgb"] for c in cams]
    true_delta = torch.tensor([0.08, -0.05, 0.03, 0.0, 0.04, -0.03])
    bad_cams = [tco.apply_to_camera(c, true_delta, "SO3xR3") for c in cams]
    # gstk_tpu's settings: an lr under the reference's, no pose penalty
    # (two cameras), every scene group frozen
    co = tco.CameraOptConfig(mode="SO3xR3", lr=3e-4, trans_l2_penalty=0.0,
                             rot_l2_penalty=0.0)
    frozen = ("means", "features_dc", "features_rest", "opacities", "scales",
              "quats")
    step_fn = make_train_step(cfg, RASTER, OptimizerConfig(), H, W, sh_degree=0,
                              camera_opt=co, frozen_groups=frozen)
    before = {k: v.copy() for k, v in scene_to_numpy(gt_scene).items()}
    state = init_train_state(gt_scene, num_cameras=len(cams))
    assert state.cam_adjust.shape == (2, 6)
    indices = torch.arange(len(cams), dtype=torch.int32)
    t0 = time.perf_counter()
    first = last = None
    for i in range(POSE_STEPS):
        j = i % len(cams)
        state, metrics = step_fn(state, bad_cams[j], gt_imgs[j],
                                 camera_index=indices[j])
        if i == 0:
            first = float(metrics["psnr"])
        last = float(metrics["psnr"])
    print(f"pose recovery: PSNR {first:.3f} -> {last:.3f} in {POSE_STEPS} "
          f"steps, {time.perf_counter() - t0:.1f} s")
    assert float(metrics["camera_opt_translation"]) > 0
    assert float(metrics["camera_opt_rotation"]) > 0
    adj = state.cam_adjust.numpy()
    assert np.isfinite(adj).all() and np.abs(adj).max() > 1e-4
    assert last > first + 1.0, (first, last)
    # the scene never moved
    for k, v in scene_to_numpy(state.scene).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)


def test_camera_opt_step_needs_an_index():
    cfg = VanillaConfig(background_color="black", sh_degree=0)
    scene = _gt_scene(np.random.default_rng(1))
    step_fn = make_train_step(cfg, RASTER, OptimizerConfig(), H, W, sh_degree=0,
                              camera_opt=tco.CameraOptConfig(mode="SE3"))
    with pytest.raises(ValueError, match="camera_index"):
        step_fn(init_train_state(scene, num_cameras=2), _cameras(1)[0],
                torch.zeros((H, W, 3)))
    # mode "off" is no camera optimisation: no group, no index
    off = make_train_step(cfg, RASTER, OptimizerConfig(), H, W, sh_degree=0,
                          camera_opt=tco.CameraOptConfig())
    state, m = off(init_train_state(scene), _cameras(1)[0], torch.zeros((H, W, 3)))
    assert state.cam_adjust is None and "camera_opt_rotation" not in m
