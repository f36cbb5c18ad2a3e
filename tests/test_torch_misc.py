"""gstk_torch's trajectories, colormaps, rays, fisheye624 and articulated
helpers against gstk_tpu's on the CPU, from numpy seeds.

  * trajectories (numpy copies): equal bit for bit;
  * colormaps: rtol 1e-6, atol 1e-7 (the depth map's default percentiles
    within 4 ulps, XLA fusing their interpolation);
  * rays and fisheye624, its Newton unprojection included: rtol 1e-5,
    atol 1e-6 (PR 1's math tolerances);
  * the articulated joints: means within 1e-6 (the f32 rotation products
    round apart), quaternions equal, the input scene unchanged; the RGB-D
    back-projection and normals (numpy copies) equal;
and gstk_tpu's own tests of these modules, mirrored.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstk_tpu.core import fisheye624 as jfish
from gstk_tpu.core import rays as jrays
from gstk_tpu.core import trajectories as jtraj
from gstk_tpu.core.cameras import Camera as JCamera
from gstk_tpu.core.gaussians import init_scene as jinit_scene
from gstk_tpu.extra_toolkit import articulated as jart
from gstk_tpu.utils import colormaps as jcmap
from gstk_torch.core import fisheye624 as tfish
from gstk_torch.core import rays as trays
from gstk_torch.core import trajectories as ttraj
from gstk_torch.core.cameras import Camera
from gstk_torch.core.gaussians import scene_from_numpy, scene_to_numpy
from gstk_torch.extra_toolkit import articulated as tart
from gstk_torch.utils import colormaps as tcmap

torch.set_num_threads(2)

MATH = dict(rtol=1e-5, atol=1e-6)
CMAP = dict(rtol=1e-6, atol=1e-7)
# a realistic Aria-like parameter set (gstk_tpu's tests/test_fisheye624.py)
PARAMS = np.array(
    [240.0, 242.0, 320.0, 240.0,
     0.35, -0.1, 0.02, -0.003, 0.0005, -0.0001,
     1e-3, -5e-4,
     2e-4, -1e-4, 3e-4, -2e-4],
    np.float32,
)


# -- trajectories -------------------------------------------------------------

def _random_pose(rng):
    q = rng.normal(size=4)
    pose = np.zeros((3, 4))
    pose[:, :3] = jtraj.quat_to_rotmat_np(q)
    pose[:, 3] = rng.normal(size=3)
    return pose


def test_trajectories_equal_gstk_tpu(rng):
    for _ in range(10):
        q = rng.normal(size=4)
        r = jtraj.quat_to_rotmat_np(q)
        np.testing.assert_array_equal(ttraj.quat_to_rotmat_np(q), r)
        np.testing.assert_array_equal(ttraj.rotmat_to_quat(r),
                                      jtraj.rotmat_to_quat(r))
        q1 = rng.normal(size=4)
        for t in (0.0, 0.3, 1.0):
            np.testing.assert_array_equal(ttraj.slerp(q, q1, t),
                                          jtraj.slerp(q, q1, t))
    # the near-parallel branch of slerp
    q0 = np.array([1.0, 0, 0, 0])
    q1 = np.array([1.0, 1e-3, 0, 0])
    np.testing.assert_array_equal(ttraj.slerp(q0, q1, 0.4),
                                  jtraj.slerp(q0, q1, 0.4))
    keys = [_random_pose(rng) for _ in range(4)]
    ours = ttraj.interpolate_poses(keys, steps_per_segment=7)
    theirs = jtraj.interpolate_poses(keys, steps_per_segment=7)
    assert len(ours) == len(theirs) == 22
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert ttraj.poses_to_camera_path(ours, 60.0, 480, 640, 24.0) == \
        jtraj.poses_to_camera_path(theirs, 60.0, 480, 640, 24.0)
    for a, b in zip(ttraj.orbit_path((0.5, -0.2, 1.0), 2.5, 0.4, 9),
                    jtraj.orbit_path((0.5, -0.2, 1.0), 2.5, 0.4, 9)):
        np.testing.assert_array_equal(a, b)


def test_quat_roundtrip_and_slerp_endpoints(rng):
    for _ in range(10):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        q2 = ttraj.rotmat_to_quat(ttraj.quat_to_rotmat_np(q))
        assert np.allclose(q, q2, atol=1e-6) or np.allclose(q, -q2, atol=1e-6)
    q0 = np.array([1.0, 0, 0, 0])
    q1 = np.array([np.cos(0.5), np.sin(0.5), 0, 0])
    np.testing.assert_allclose(ttraj.slerp(q0, q1, 0.0), q0, atol=1e-7)
    np.testing.assert_allclose(ttraj.slerp(q0, q1, 1.0), q1, atol=1e-7)
    np.testing.assert_allclose(np.linalg.norm(ttraj.slerp(q0, q1, 0.5)), 1.0,
                               atol=1e-7)


def test_interpolate_and_camera_path():
    a = np.eye(4)[:3]
    b = np.eye(4)[:3].copy()
    b[:3, 3] = [1, 0, 0]
    poses = ttraj.interpolate_poses([a, b], steps_per_segment=10)
    assert len(poses) == 11
    np.testing.assert_allclose(poses[5][:3, 3], [0.5, 0, 0], atol=1e-6)
    path = ttraj.poses_to_camera_path(poses)
    assert len(path["camera_path"]) == 11
    assert len(path["camera_path"][0]["camera_to_world"]) == 16
    assert len(ttraj.orbit_path(n_frames=12)) == 12


# -- colormaps ------------------------------------------------------------------

@pytest.mark.parametrize("cmap", ["turbo", "gray"])
def test_colormap_matches_jax(rng, cmap):
    x = rng.uniform(-0.2, 1.2, (16, 12)).astype(np.float32)
    got = tcmap.apply_colormap(torch.from_numpy(x), cmap).numpy()
    want = np.asarray(jcmap.apply_colormap(jnp.asarray(x), cmap))
    assert got.shape == (16, 12, 3)
    np.testing.assert_allclose(got, want, **CMAP)


@pytest.mark.parametrize("near_far", [(None, None), (1.5, 4.0)])
def test_depth_and_boolean_colormaps_match_jax(rng, near_far):
    """With near and far given, the map is held to the colormap tolerance.
    Without, each package takes the 2nd and 98th percentiles, and XLA fuses
    their interpolation, so the two differ by a few ulps (held to 4); the
    map is then held to the tolerance from gstk_tpu's near and far."""
    d = rng.uniform(1, 5, (16, 12)).astype(np.float32)
    acc = rng.uniform(0, 1, (16, 12)).astype(np.float32)
    near, far = near_far
    if near is None:
        jd = jnp.asarray(d)
        near, far = (float(jnp.percentile(jd, 2.0)), float(jnp.percentile(jd, 98.0)))
        for q, want in ((0.02, near), (0.98, far)):
            got = float(torch.quantile(torch.from_numpy(d).reshape(-1), q))
            assert abs(got - want) <= 4 * np.spacing(np.float32(want))
        got = tcmap.apply_depth_colormap(torch.from_numpy(d)).numpy()
        assert np.isfinite(got).all() and got.min() >= 0 and got.max() <= 1
    got = tcmap.apply_depth_colormap(torch.from_numpy(d), torch.from_numpy(acc),
                                     near, far).numpy()
    want = np.asarray(jcmap.apply_depth_colormap(jnp.asarray(d), jnp.asarray(acc),
                                                 near, far))
    np.testing.assert_allclose(got, want, **CMAP)
    mask = rng.uniform(size=(16, 12)) > 0.5
    got = tcmap.apply_boolean_colormap(torch.from_numpy(mask), (1.0, 0.5, 0.0),
                                       (0.0, 0.0, 1.0)).numpy()
    want = np.asarray(jcmap.apply_boolean_colormap(jnp.asarray(mask),
                                                   (1.0, 0.5, 0.0), (0.0, 0.0, 1.0)))
    np.testing.assert_array_equal(got, want)


# -- rays and fisheye624 -----------------------------------------------------------

def _cameras(c2w, fx, fy, cx, cy):
    j = JCamera(fx=jnp.float32(fx), fy=jnp.float32(fy), cx=jnp.float32(cx),
                cy=jnp.float32(cy), c2w=jnp.asarray(c2w, jnp.float32))
    return j, Camera.create(fx, fy, cx, cy, c2w, device="cpu")


def _bundle_close(got, want, **tol):
    for field in ("origins", "directions", "nears", "fars"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol,
                                       err_msg=field)


def _posed(rng):
    c2w = _random_pose(rng).astype(np.float32)
    c2w[:, 3] = [0.2, -0.1, 5.0]
    return c2w


@pytest.mark.parametrize("kind", ["pinhole", "equirect", "ods_left",
                                  "ods_right", "vr180", "orthographic",
                                  "fisheye624"])
def test_rays_match_jax(rng, kind):
    c2w = _posed(rng)
    jc, tc = _cameras(c2w, 50.0, 52.0, 32.0, 24.0)
    h, w = 48, 64
    if kind == "pinhole":
        got, want = trays.generate_rays(tc, h, w), jrays.generate_rays(jc, h, w)
    elif kind == "equirect":
        got = trays.generate_equirect_rays(tc, h, w)
        want = jrays.generate_equirect_rays(jc, h, w)
    elif kind.startswith("ods"):
        eye = kind.split("_")[1]
        got = trays.generate_ods_rays(tc, h, w, eye=eye, ipd=0.07)
        want = jrays.generate_ods_rays(jc, h, w, eye=eye, ipd=0.07)
    elif kind == "vr180":
        got = trays.generate_vr180_rays(tc, h, w, eye="right")
        want = jrays.generate_vr180_rays(jc, h, w, eye="right")
    elif kind == "orthographic":
        got = trays.generate_orthographic_rays(tc, h, w)
        want = jrays.generate_orthographic_rays(jc, h, w)
    else:
        jc, tc = _cameras(c2w, *PARAMS[:4])
        h, w = 48, 64
        got = trays.generate_fisheye624_rays(tc, h, w, PARAMS[4:])
        want = jrays.generate_fisheye624_rays(jc, h, w, jnp.asarray(PARAMS[4:]))
    _bundle_close(got, want, **MATH)


def test_colliders_match_jax(rng):
    c2w = _posed(rng)
    jc, tc = _cameras(c2w, 50.0, 50.0, 32.0, 24.0)
    tr, jr = trays.generate_rays(tc, 48, 64), jrays.generate_rays(jc, 48, 64)
    box = np.array([[-1.0, -1.2, -0.8], [1.1, 0.9, 1.3]], np.float32)
    _bundle_close(trays.aabb_collider(tr, torch.from_numpy(box), 0.05),
                  jrays.aabb_collider(jr, jnp.asarray(box), 0.05), **MATH)
    _bundle_close(trays.sphere_collider(tr, (0.1, 0.0, -0.2), 1.3),
                  jrays.sphere_collider(jr, (0.1, 0.0, -0.2), 1.3), **MATH)
    _bundle_close(trays.near_far_collider(tr, 0.1, 10.0),
                  jrays.near_far_collider(jr, 0.1, 10.0), **MATH)


def test_ray_generation_and_colliders():
    """gstk_tpu's tests/test_rays.py on the port."""
    c2w = np.eye(4)[:3].astype(np.float32)
    c2w[:3, 3] = [0, 0, 5.0]
    cam = Camera.create(50.0, 50.0, 32.0, 24.0, c2w, device="cpu")
    rays = trays.generate_rays(cam, 48, 64)
    assert rays.origins.shape == (48, 64, 3)
    np.testing.assert_allclose(rays.origins[0, 0].numpy(), [0, 0, 5.0])
    np.testing.assert_allclose(torch.linalg.norm(rays.directions, dim=-1).numpy(),
                               1.0, atol=1e-6)
    assert float(rays.directions[24, 32, 2]) < -0.99
    box = trays.aabb_collider(rays, torch.tensor([[-1.0, -1, -1], [1, 1, 1]]))
    sphere = trays.sphere_collider(rays, (0.0, 0.0, 0.0), 1.0)
    for out in (box, sphere):
        np.testing.assert_allclose(float(out.nears[24, 32]), 4.0, atol=0.02)
        np.testing.assert_allclose(float(out.fars[24, 32]), 6.0, atol=0.02)


@pytest.mark.parametrize("n_params", [16, 15])
def test_fisheye624_matches_jax(rng, n_params):
    params = PARAMS if n_params == 16 else np.concatenate([PARAMS[:1], PARAMS[2:]])
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(0.5, 2.0, 200)
    pts[:3] = [[0, 0, 1.0], [1e-12, 0, 1.0], [0.3, -0.2, 1e-12]]  # axis, z ~ 0
    uv = tfish.fisheye624_project(torch.from_numpy(pts), torch.from_numpy(params))
    juv = jfish.fisheye624_project(jnp.asarray(pts), jnp.asarray(params))
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), **MATH)
    dirs = tfish.fisheye624_unproject(torch.tensor(np.asarray(juv)),
                                      torch.from_numpy(params))
    jdirs = jfish.fisheye624_unproject(juv, jnp.asarray(params))
    np.testing.assert_allclose(dirs.numpy(), np.asarray(jdirs), **MATH)


def test_fisheye624_roundtrip_and_hand_value():
    """gstk_tpu's tests/test_fisheye624.py: the on-axis pixel and the
    round trip within the lens FOV."""
    uv = tfish.fisheye624_project(torch.tensor([[0.0, 0.0, 1.0]]),
                                  torch.from_numpy(PARAMS))
    np.testing.assert_allclose(uv[0].numpy(), [320.0, 240.0], atol=1e-5)
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    pts[:, 2] = 1.0
    pts[:, :2] = np.clip(pts[:, :2], -1.8, 1.8)
    uv = tfish.fisheye624_project(torch.from_numpy(pts), torch.from_numpy(PARAMS))
    dirs = tfish.fisheye624_unproject(uv, torch.from_numpy(PARAMS)).numpy()
    pn = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    np.testing.assert_allclose(dirs, pn, atol=2e-4)


# -- articulated -------------------------------------------------------------------

def _scenes(rng):
    pts = rng.uniform(-1, 1, (20, 3)).astype(np.float32)
    rgb = rng.uniform(0, 255, (20, 3)).astype(np.float32)
    js = jinit_scene(jax.random.PRNGKey(0), 32, (pts, rgb), sh_degree=0)
    arrays = {k: np.asarray(getattr(js, k)) for k in
              ("means", "scales", "quats", "features_dc", "features_rest",
               "opacities", "alive")}
    return pts, js, scene_from_numpy(arrays, "cpu"), arrays


@pytest.mark.parametrize("joint", ["prismatic", "revolute"])
def test_articulated_joints_match_jax(rng, joint):
    pts, js, ts, before = _scenes(rng)
    mask = np.arange(32) < 10
    if joint == "prismatic":
        args = ([0.2, 0.0, 1.0], 0.5)
    else:
        args = ([0.1, 0.2, 0.0], [0.3, 0.5, 1.0], 0.7)
    theirs = getattr(jart, f"{joint}_joint")(js, jnp.asarray(mask), *args)
    ours = getattr(tart, f"{joint}_joint")(ts, torch.from_numpy(mask), *args)
    np.testing.assert_allclose(ours.means.detach().numpy(),
                               np.asarray(theirs.means), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ours.quats.detach().numpy(),
                                  np.asarray(theirs.quats))
    # a new scene: the input is as it was, and the unmasked lanes are too
    after = scene_to_numpy(ts)
    for k, v in before.items():
        np.testing.assert_array_equal(after[k], v)
    assert ours.means.data_ptr() != ts.means.data_ptr()
    np.testing.assert_array_equal(ours.means.detach().numpy()[10:],
                                  before["means"][10:])


def test_articulated_joints():
    """gstk_tpu's test_articulated_joints on the port."""
    rng = np.random.default_rng(0)
    pts, _, scene, _ = _scenes(rng)
    mask = torch.arange(32) < 10
    moved = tart.prismatic_joint(scene, mask, [0, 0, 1.0], 0.5)
    np.testing.assert_allclose(moved.means[:10, 2].detach().numpy(),
                               pts[:10, 2] + 0.5, atol=1e-6)
    np.testing.assert_allclose(moved.means[10:20].detach().numpy(), pts[10:20],
                               atol=1e-6)
    rot = tart.revolute_joint(scene, mask, pivot=[0, 0, 0], axis=[0, 0, 1],
                              angle=np.pi / 2)
    expect = np.stack([-pts[:10, 1], pts[:10, 0], pts[:10, 2]], axis=-1)
    np.testing.assert_allclose(rot.means[:10].detach().numpy(), expect, atol=1e-5)
    q = rot.quats[:10].detach().numpy()
    np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-5)
    R = tart.axis_angle_rotation([0, 0, 1], np.pi / 2, device="cpu")
    np.testing.assert_array_equal(
        R.numpy(), np.asarray(jart.axis_angle_rotation([0, 0, 1], np.pi / 2)))


def test_rgbd_pointcloud_and_normals_match_jax(rng):
    depth = rng.uniform(0.5, 12.0, (10, 12)).astype(np.float32)
    rgb = rng.integers(0, 255, (10, 12, 3)).astype(np.uint8)
    mask = (rng.uniform(size=(10, 12)) > 0.3).astype(np.uint8)
    c2w = _random_pose(rng)
    for kw in ({}, {"c2w_opengl": c2w, "mask": mask, "max_depth": 8.0}):
        got = tart.rgbd_to_pointcloud(depth, rgb, 10.0, 11.0, 6.0, 5.0, **kw)
        want = jart.rgbd_to_pointcloud(depth, rgb, 10.0, 11.0, 6.0, 5.0, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    pts = rng.normal(size=(200, 3))
    np.testing.assert_array_equal(tart.estimate_normals(pts, k=12),
                                  jart.estimate_normals(pts, k=12))
    xs, ys = np.meshgrid(np.linspace(0, 1, 20), np.linspace(0, 1, 20))
    plane = np.stack([xs.ravel(), ys.ravel(), 0.3 * xs.ravel() + 0.1 * ys.ravel()],
                     axis=-1)
    expected = np.array([-0.3, -0.1, 1.0]) / np.linalg.norm([-0.3, -0.1, 1.0])
    assert np.all(np.abs(tart.estimate_normals(plane, k=12) @ expected) > 0.999)
