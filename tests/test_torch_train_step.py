"""The slice as a whole: gstk_torch's vanilla train step against gstk_tpu's
``make_train_step`` from the same state (CPU, 64x48, 300 Gaussians in a
capacity of 384, SH degree 1).

gstk_tpu's ``init_scene`` and ``init_train_state`` make the state;
``train_state_to_numpy`` / ``train_state_from_numpy`` carry it across under
the checkpoint's keys. Cases: black and white backgrounds (white puts
every empty pixel on the tie of ``min(rgb, 1)``), ``micro_batch=2`` and
``frozen_groups=("means",)``; each runs three steps, compared after each.
The antialiased mode (opacities times the EWA blur's compensation) runs
the same three steps, and its loss gradients are held group by group, on
a state whose log-scales reach sub-pixel sizes; an unknown mode raises in
both packages.

Tolerances:
  * loss, main_loss, psnr: rtol 1e-4;
  * gradients (every group, and the ``xys_offset`` gradient of the step's
    loss), first moments, and sqrt of the second moments (both proportional
    to the gradient): rtol 5e-3, atol 1e-4 max|g|, ``check_pallas_parity``'s
    gradient tolerance;
  * the two packages project independently, so an entry whose alpha lies
    within rounding of the 1/255 cutoff may be composited by one and not the
    other (ROADMAP Queue 3); as the render tests absorb it, at most 0.5% of
    a group's entries may fall outside the tolerance (the count is printed);
  * Adam's first steps move a parameter by about lr sign(g), so a gradient
    near 0 that rounds differently moves it by up to 2 lr: parameter
    updates are held to rtol 5e-3 where |g| > 1e-3 max|g| of the group and
    to 2 lr per step elsewhere;
  * the densify statistics: grad norms at the gradient tolerance, visibility
    counts and max radii within the same 0.5% of lanes.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstk_tpu.core import cameras as jcam
from gstk_tpu.core import gaussians as jgs
from gstk_tpu.models import vanilla as jvan
from gstk_tpu.ops.rasterize import RasterizeConfig as JRasterizeConfig
from gstk_tpu.train import checkpoint as jckpt
from gstk_tpu.train import optim as jopt
from gstk_tpu.train import step as jstep
from gstk_tpu.core import camera_opt as jco
from gstk_tpu.models import depth as jdepth
from gstk_tpu.models import surface as jsurf
from gstk_torch.core import camera_opt as tco
from gstk_torch.core import cameras as tcam
from gstk_torch.models import depth as tdepth
from gstk_torch.models import surface as tsurf
from gstk_torch.utils import losses as tlosses
from gstk_torch.models import vanilla as tvan
from gstk_torch.ops.rasterize import RasterizeConfig
from gstk_torch.train import checkpoint as tckpt
from gstk_torch.train import optim as topt
from gstk_torch.train import step as tstep

torch.set_num_threads(2)

H, W = 48, 64
FX = FY = 0.5 * W / np.tan(0.5 * np.deg2rad(60.0))
N, CAPACITY, SH = 300, 384, 1
ISECT = 1 << 13
RTOL_GRAD = 5e-3
MAX_OUTSIDE = 0.005
GROUPS = ("means", "scales", "quats", "features_dc", "features_rest",
          "opacities")


def _jax_state(seed=0, log_scales=(-3.0, -1.5)):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2.25, 2.25, N),
                    rng.uniform(-8, -2, N)], -1).astype(np.float32)
    rgb = rng.uniform(0, 255, (N, 3)).astype(np.float32)
    scene = jgs.init_scene(jax.random.PRNGKey(seed), CAPACITY, (pts, rgb),
                           sh_degree=SH, init_opacity=0.5)
    # anisotropic scales, as after some training (kNN init is isotropic,
    # which leaves the rotations without a gradient), and a few dead lanes
    # among the live ones, beside the padding
    scales = rng.uniform(*log_scales, (N, 3)).astype(np.float32)
    scene = scene._replace(scales=scene.scales.at[:N].set(jnp.asarray(scales)),
                           alive=scene.alive.at[::23].set(False))
    return jstep.init_train_state(scene)


def _flat(jstate, tmp_path) -> dict:
    """gstk_tpu's train state as its checkpoint's flat numpy arrays."""
    path = jckpt.save_checkpoint(tmp_path / "j", jstate)
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _c2w(i):
    """Pose i: the identity, or a small rotation and shift of it."""
    c2w = np.eye(4, dtype=np.float32)[:3]
    if i:
        a = 0.04 * np.array([np.sin(i), np.cos(2 * i), np.sin(3 * i)])
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        u, _, vt = np.linalg.svd(np.eye(3) + K)
        c2w[:, :3] = u @ vt
        c2w[:, 3] = 0.1 * np.array([np.cos(i), np.sin(i), 0.0])
    return c2w


def _cameras(poses):
    """Both packages' cameras; with a list of poses, one camera whose
    fields carry a leading micro-batch dimension."""
    if isinstance(poses, int):
        c2w = _c2w(poses)
        jc = jcam.Camera(fx=jnp.float32(FX), fy=jnp.float32(FY),
                         cx=jnp.float32(W / 2), cy=jnp.float32(H / 2),
                         c2w=jnp.asarray(c2w))
        return jc, tcam.Camera.create(FX, FY, W / 2, H / 2, c2w, device="cpu")
    c2w = np.stack([_c2w(i) for i in poses])
    m = len(poses)
    full = lambda v: np.full(m, v, np.float32)
    intr = dict(fx=full(FX), fy=full(FY), cx=full(W / 2), cy=full(H / 2))
    jc = jcam.Camera(**{k: jnp.asarray(v) for k, v in intr.items()},
                     c2w=jnp.asarray(c2w))
    tc = tcam.Camera(**{k: torch.from_numpy(v) for k, v in intr.items()},
                     c2w=torch.from_numpy(c2w))
    return jc, tc


def _outside(name, got, want, rtol, atol):
    """Entries outside the tolerance; at most MAX_OUTSIDE of them."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), name
    bad = ~np.isclose(got, want, rtol=rtol, atol=atol)
    print(f"{name}: {int(bad.sum())} of {bad.size} outside rtol {rtol:g} "
          f"atol {atol:.3g}")
    assert bad.mean() <= MAX_OUTSIDE, (
        f"{name}: {int(bad.sum())} of {bad.size} entries outside tolerance, "
        f"max abs err {np.abs(got - want).max():.3g}"
    )


def _grad_close(name, got, want):
    want = np.asarray(want)
    _outside(name, got, want, RTOL_GRAD, 1e-4 * max(np.abs(want).max(), 1e-30))


def _compare_states(label, t_flat, j_flat, before, lrs):
    """Moments, parameter updates and statistics after a step."""
    for g in GROUPS:
        mu_j = j_flat[f".adam/.mu/['{g}']"]
        _grad_close(f"{label} mu {g}", t_flat[f".adam/.mu/['{g}']"], mu_j)
        _grad_close(f"{label} sqrt nu {g}",
                    np.sqrt(t_flat[f".adam/.nu/['{g}']"]),
                    np.sqrt(j_flat[f".adam/.nu/['{g}']"]))
        key = f".scene/.{g}"
        d_t = t_flat[key] - before[key]
        d_j = j_flat[key] - before[key]
        strong = np.abs(mu_j) > 1e-3 * np.abs(mu_j).max()
        bad = np.where(strong, ~np.isclose(d_t, d_j, rtol=RTOL_GRAD, atol=0.0),
                       np.abs(d_t - d_j) > 2.0 * lrs[g] + 1e-7)
        print(f"{label} update {g}: {int(bad.sum())} of {bad.size} outside")
        assert bad.mean() <= MAX_OUTSIDE, f"{label} update {g}"
    _grad_close(f"{label} xys_grad_norm", t_flat[".refine/.xys_grad_norm"],
                j_flat[".refine/.xys_grad_norm"])
    for k in ("vis_counts", "max_2dsize"):
        _outside(f"{label} {k}", t_flat[f".refine/.{k}"], j_flat[f".refine/.{k}"],
                 1e-6, 0.0)
    for k in (".adam/.count", ".step", ".scene/.alive"):
        np.testing.assert_array_equal(t_flat[k], j_flat[k], err_msg=k)


CASES = {
    "black": dict(bg="black"),
    "white": dict(bg="white"),
    "micro_batch_2": dict(bg="black", micro_batch=2),
    "frozen_means": dict(bg="white", frozen_groups=("means",)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case, tmp_path):
    kw = dict(CASES[case])
    bg = kw.pop("bg")
    micro = kw.get("micro_batch", 1)
    jstate = _jax_state()
    flat0 = _flat(jstate, tmp_path)
    state = tckpt.train_state_from_numpy(flat0, device="cpu")
    # the carried state is the same state
    for k, v in tckpt.train_state_to_numpy(state).items():
        np.testing.assert_array_equal(v, flat0[k], err_msg=k)

    jfn = jax.jit(jstep.make_train_step(
        jvan.VanillaConfig(sh_degree=SH, background_color=bg),
        JRasterizeConfig(isect_capacity=ISECT), jopt.OptimizerConfig(),
        H, W, sh_degree=SH, **kw,
    ))
    tfn = tstep.make_train_step(
        tvan.VanillaConfig(sh_degree=SH, background_color=bg),
        RasterizeConfig(isect_capacity=ISECT), topt.OptimizerConfig(),
        H, W, sh_degree=SH, **kw,
    )
    cfg = topt.OptimizerConfig()
    rng = np.random.default_rng(7)
    before = flat0
    for i in range(3):
        if micro == 1:
            jc, tc = _cameras(i)
            gt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        else:
            jc, tc = _cameras([2 * i, 2 * i + 1])
            gt = rng.uniform(0, 1, (micro, H, W, 3)).astype(np.float32)
        lrs = {g: float(cfg.schedule_for(g)(torch.tensor(i))) for g in GROUPS}
        jstate, jm = jfn(jstate, jc, jnp.asarray(gt), jax.random.PRNGKey(i))
        state, tm = tfn(state, tc, torch.from_numpy(gt))
        for k in ("loss", "main_loss", "psnr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
        assert int(tm["num_alive"]) == int(jm["num_alive"])
        assert abs(int(tm["num_intersects"]) - int(jm["num_intersects"])) <= (
            0.01 * int(jm["num_intersects"])
        )
        j_flat = _flat(jstate, tmp_path)
        t_flat = tckpt.train_state_to_numpy(state)
        _compare_states(f"{case} step {i}", t_flat, j_flat, before, lrs)
        if "frozen_groups" in kw:
            assert not t_flat[".adam/.mu/['means']"].any()
            np.testing.assert_array_equal(t_flat[".scene/.means"],
                                          flat0[".scene/.means"])
        before = j_flat


@pytest.mark.parametrize("bg", ["black", "white"])
def test_step_loss_gradients_match_jax(bg, tmp_path):
    """The gradients the step takes, group by group and for the zero
    ``xys_offset``: each package's ``render_scene`` + ``rgb_loss``
    differentiated by its own autodiff from the same carried state."""
    jstate = _jax_state(seed=1)
    state = tckpt.train_state_from_numpy(_flat(jstate, tmp_path), device="cpu")
    jc, tc = _cameras(3)
    gt = np.random.default_rng(8).uniform(0, 1, (H, W, 3)).astype(np.float32)
    background = np.full(3, 1.0 if bg == "white" else 0.0, np.float32)
    jcfg = jvan.VanillaConfig(sh_degree=SH, background_color=bg)
    scene_j = jstate.scene

    def jloss(params, xys_off):
        scn = scene_j.with_params(params)
        out = jvan.render_scene(
            scn, jc, H, W, sh_degree=SH, background=jnp.asarray(background),
            config=jcfg, raster_config=JRasterizeConfig(isect_capacity=ISECT),
            xys_offset=xys_off,
        )
        return sum(jvan.rgb_loss(out["rgb"], jnp.asarray(gt), scn, jcfg).values())

    jval, (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        scene_j.params(), jnp.zeros((CAPACITY, 2), jnp.float32)
    )
    tcfg = tvan.VanillaConfig(sh_degree=SH, background_color=bg)
    xys_off = torch.zeros((CAPACITY, 2), requires_grad=True)
    out = tvan.render_scene(
        state.scene, tc, H, W, sh_degree=SH,
        background=torch.from_numpy(background), config=tcfg,
        raster_config=RasterizeConfig(isect_capacity=ISECT), xys_offset=xys_off,
    )
    loss = sum(tvan.rgb_loss(out["rgb"], torch.from_numpy(gt), state.scene,
                             tcfg).values())
    params = state.scene.params()
    grads = torch.autograd.grad(loss, [*params.values(), xys_off])
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-4)
    for name, g in zip(params, grads):
        _grad_close(f"{bg} grad {name}", g.numpy(), jg[name])
    _grad_close(f"{bg} grad xys_offset", grads[-1].numpy(), jgx)


# log-scales down to sub-pixel sizes: the antialiased mode's compensation
# sqrt(det(cov) / det(cov + 0.3 I)) then ranges from near 0 to near 1
AA_SCALES = (-6.0, -1.5)


def _compensation(state, camera) -> np.ndarray:
    """The port's antialiasing compensation of the lanes on screen."""
    with torch.no_grad():
        ins = [tvan.splat_inputs(state.scene, camera, H, W, sh_degree=SH,
                                 config=tvan.VanillaConfig(rasterize_mode=m))
               for m in ("antialiased", "classic")]
    on = (ins[0]["radii"] > 0) & (ins[1]["opacities"] > 0)
    return (ins[0]["opacities"][on] / ins[1]["opacities"][on]).numpy()


def test_antialiased_step_matches_jax(tmp_path):
    """``rasterize_mode="antialiased"``: three train steps from one state
    against gstk_tpu's, as ``test_train_step_matches_jax`` holds them (the
    opacities' moments carry the gradient through the compensation)."""
    jstate = _jax_state(seed=2, log_scales=AA_SCALES)
    flat0 = _flat(jstate, tmp_path)
    state = tckpt.train_state_from_numpy(flat0, device="cpu")
    comp = _compensation(state, _cameras(0)[1])
    assert comp.min() < 0.05 and comp.max() > 0.9
    assert 0.1 < (comp < 0.5).mean() < 0.9
    jfn = jax.jit(jstep.make_train_step(
        jvan.VanillaConfig(sh_degree=SH, background_color="black",
                           rasterize_mode="antialiased"),
        JRasterizeConfig(isect_capacity=ISECT), jopt.OptimizerConfig(),
        H, W, sh_degree=SH))
    tfn = tstep.make_train_step(
        tvan.VanillaConfig(sh_degree=SH, background_color="black",
                           rasterize_mode="antialiased"),
        RasterizeConfig(isect_capacity=ISECT), topt.OptimizerConfig(),
        H, W, sh_degree=SH)
    cfg = topt.OptimizerConfig()
    rng = np.random.default_rng(9)
    before = flat0
    for i in range(3):
        jc, tc = _cameras(i)
        gt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        lrs = {g: float(cfg.schedule_for(g)(torch.tensor(i))) for g in GROUPS}
        jstate, jm = jfn(jstate, jc, jnp.asarray(gt), jax.random.PRNGKey(i))
        state, tm = tfn(state, tc, torch.from_numpy(gt))
        for k in ("loss", "main_loss", "psnr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
        j_flat = _flat(jstate, tmp_path)
        _compare_states(f"antialiased step {i}", tckpt.train_state_to_numpy(state),
                        j_flat, before, lrs)
        before = j_flat


def test_antialiased_loss_gradients_match_jax(tmp_path):
    """The antialiased step's loss and each group's gradient, by each
    package's autodiff from one carried state: the opacity gradient
    through the compensation, and the scales' and means' through it."""
    jstate = _jax_state(seed=3, log_scales=AA_SCALES)
    state = tckpt.train_state_from_numpy(_flat(jstate, tmp_path), device="cpu")
    jc, tc = _cameras(2)
    gt = np.random.default_rng(10).uniform(0, 1, (H, W, 3)).astype(np.float32)
    bg = np.zeros(3, np.float32)
    jcfg = jvan.VanillaConfig(sh_degree=SH, rasterize_mode="antialiased")
    tcfg = tvan.VanillaConfig(sh_degree=SH, rasterize_mode="antialiased")
    scene_j = jstate.scene

    def jloss(params):
        scn = scene_j.with_params(params)
        out = jvan.render_scene(
            scn, jc, H, W, sh_degree=SH, background=jnp.asarray(bg),
            config=jcfg, raster_config=JRasterizeConfig(isect_capacity=ISECT))
        return sum(jvan.rgb_loss(out["rgb"], jnp.asarray(gt), scn, jcfg).values())

    jval, jg = jax.value_and_grad(jloss)(scene_j.params())
    out = tvan.render_scene(
        state.scene, tc, H, W, sh_degree=SH, background=torch.from_numpy(bg),
        config=tcfg, raster_config=RasterizeConfig(isect_capacity=ISECT))
    loss = sum(tvan.rgb_loss(out["rgb"], torch.from_numpy(gt), state.scene,
                             tcfg).values())
    params = state.scene.params()
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-4)
    for name, g in zip(params, grads):
        _grad_close(f"antialiased grad {name}", g.numpy(), jg[name])
    assert np.abs(grads[list(params).index("opacities")].numpy()).max() > 0


def test_unknown_rasterize_mode_raises(tmp_path):
    """Both packages refuse a mode other than classic and antialiased."""
    jstate = _jax_state()
    state = tckpt.train_state_from_numpy(_flat(jstate, tmp_path), device="cpu")
    jc, tc = _cameras(0)
    with pytest.raises(ValueError, match="Unknown rasterize_mode"):
        jvan.render_scene(
            jstate.scene, jc, H, W, sh_degree=SH, background=jnp.zeros(3),
            config=jvan.VanillaConfig(rasterize_mode="mip"),
            raster_config=JRasterizeConfig(isect_capacity=ISECT))
    with pytest.raises(ValueError, match="Unknown rasterize_mode"):
        tvan.render_scene(
            state.scene, tc, H, W, sh_degree=SH, background=torch.zeros(3),
            config=tvan.VanillaConfig(rasterize_mode="mip"),
            raster_config=RasterizeConfig(isect_capacity=ISECT))


def test_train_step_options_and_later_slices(tmp_path):
    """A random background needs an explicit generator; camera optimisation
    works (``camera_opt`` with a state made with ``num_cameras``); a
    data-parallel step (``axis_name``) needs a process group."""
    cfgs = (tvan.VanillaConfig(sh_degree=SH), RasterizeConfig(isect_capacity=ISECT),
            topt.OptimizerConfig(), H, W)
    state = tckpt.train_state_from_numpy(_flat(_jax_state(), tmp_path),
                                         device="cpu")
    step_fn = tstep.make_train_step(*cfgs, sh_degree=SH)
    gt = torch.full((H, W, 3), 0.5)
    with pytest.raises(ValueError, match="generator"):
        step_fn(state, _cameras(0)[1], gt)
    state, m = step_fn(state, _cameras(0)[1], gt,
                       generator=torch.Generator().manual_seed(0))
    assert int(state.step) == 1 and np.isfinite(float(m["loss"]))
    with pytest.raises(RuntimeError, match="process group"):
        tstep.make_train_step(*cfgs, sh_degree=SH, axis_name="data")
    cam_fn = tstep.make_train_step(
        *cfgs, sh_degree=SH, camera_opt=tco.CameraOptConfig(mode="SO3xR3"))
    cam_state = tstep.init_train_state(state.scene, num_cameras=3)
    assert cam_state.cam_adjust.shape == (3, 6)
    assert not cam_state.cam_adjust.any() and int(cam_state.cam_adam.count) == 0
    cam_state, m = cam_fn(cam_state, _cameras(0)[1], gt,
                          generator=torch.Generator().manual_seed(0),
                          camera_index=torch.tensor(1, dtype=torch.int32))
    assert int(cam_state.cam_adam.count) == 1
    moved = cam_state.cam_adjust.abs().sum(-1) > 0
    assert moved[1] and np.isfinite(float(m["camera_opt_rotation"]))


# the methods' steps: (package -> config), options, camera-opt mode,
# micro-batch; each runs 3 steps from step 0 (the depth and planar gates,
# step > 0, open at step 1; the sparse gate, step % 100 == 0, at step 0)
_COGS = dict(sh_degree=SH, background_color="black", use_sparse_loss=True,
             depth_loss_start_iteration=0, using_planar_loss=True,
             planar_loss_start_iteration=0, local_patch_size=16)
_MONO = dict(sh_degree=SH, background_color="black", use_est_depth=True,
             use_pearson_depth=True, use_scaled_est_depth=True,
             use_depth_regularization=True, using_tv_loss=True,
             depth_loss_start_iteration=0, local_patch_size=16)
METHODS = {
    "co-gs": (lambda pkg: pkg.DepthConfig(**_COGS), {}, "off", 1),
    "co-gs_mono_masked": (lambda pkg: pkg.DepthConfig(**_MONO), {}, "off", 1),
    "surface-gs": (lambda pkg: pkg.SurfaceConfig(sh_degree=SH,
                                                 background_color="white"),
                   dict(frozen_groups=("means",)), "off", 1),
    "vanilla_SE3": (lambda pkg: pkg.VanillaConfig(sh_degree=SH,
                                                  background_color="black"),
                    {}, "SE3", 1),
    "co-gs_SO3xR3_micro_batch_2": (lambda pkg: pkg.DepthConfig(**_COGS), {},
                                   "SO3xR3", 2),
}
NUM_CAMERAS = 5


def _jax_origins(cfg, key, shape):
    """The patch origins gstk_tpu's step draws from its key, in the order
    the port draws them (Pearson, then planar)."""
    h, w = shape
    _, kdepth = jax.random.split(key)
    draw = lambda k, n, size: tuple(
        torch.from_numpy(np.array(jax.random.randint(
            kk, (n,), 0, max(lim - size, 1)))) for kk, lim in
        zip(jax.random.split(k), (w, h)))
    out = []
    if not isinstance(cfg, tdepth.DepthConfig):
        return out
    if cfg.use_est_depth and cfg.use_pearson_depth:
        size = min(cfg.local_patch_size, min(shape) - 1)
        out.append((8, size, draw(jax.random.split(kdepth)[0], 8, size)))
    if cfg.using_planar_loss:
        size = min(cfg.local_patch_size, min(shape) // 2)
        out.append((16, size, draw(kdepth, 16, size)))
    return out


@pytest.mark.parametrize("case", list(METHODS))
def test_method_step_matches_jax(case, tmp_path, monkeypatch):
    """co-gs (sensor depth with the sparse and planar terms; the mono-depth
    terms with a mask and mono scale and shift), surface-gs with frozen
    means, vanilla with SE3 camera optimisation and co-gs with SO3xR3 at
    ``micro_batch=2``: three steps of the port against gstk_tpu's
    ``make_train_step`` from the same state, the camera-opt group included.
    The port's patch origins are the ones gstk_tpu draws from its key."""
    make_cfg, kw, mode, micro = METHODS[case]
    jcfg = make_cfg(types.SimpleNamespace(
        DepthConfig=jdepth.DepthConfig, SurfaceConfig=jsurf.SurfaceConfig,
        VanillaConfig=jvan.VanillaConfig))
    tcfg = make_cfg(types.SimpleNamespace(
        DepthConfig=tdepth.DepthConfig, SurfaceConfig=tsurf.SurfaceConfig,
        VanillaConfig=tvan.VanillaConfig))
    num_cams = NUM_CAMERAS if mode != "off" else None
    jstate = _jax_state()
    jstate = jstep.init_train_state(jstate.scene, num_cameras=num_cams)
    flat0 = _flat(jstate, tmp_path)
    state = tckpt.train_state_from_numpy(flat0, device="cpu")
    assert (state.cam_adjust is None) == (num_cams is None)
    jfn = jax.jit(jstep.make_train_step(
        jcfg, JRasterizeConfig(isect_capacity=ISECT), jopt.OptimizerConfig(),
        H, W, sh_degree=SH, camera_opt=jco.CameraOptConfig(mode=mode),
        micro_batch=micro, **kw,
    ))
    tfn = tstep.make_train_step(
        tcfg, RasterizeConfig(isect_capacity=ISECT), topt.OptimizerConfig(),
        H, W, sh_degree=SH, camera_opt=tco.CameraOptConfig(mode=mode),
        micro_batch=micro, **kw,
    )
    queue = []

    def jax_drawn(n, size, shape, generator, device):
        want_n, want_size, origins = queue.pop(0)
        assert (n, size) == (want_n, want_size)
        return origins

    monkeypatch.setattr(tlosses, "patch_origins", jax_drawn)
    cfg = topt.OptimizerConfig()
    cam_cfg = jco.CameraOptConfig()
    rng = np.random.default_rng(17)
    lead = () if micro == 1 else (micro,)
    before = flat0
    for i in range(3):
        key = jax.random.PRNGKey(100 + i)
        poses = i if micro == 1 else [2 * i, 2 * i + 1]
        jc, tc = _cameras(poses)
        gt = rng.uniform(0, 1, lead + (H, W, 3)).astype(np.float32)
        depth = rng.uniform(2.0, 8.0, lead + (H, W)).astype(np.float32)
        depth[rng.uniform(size=depth.shape) < 0.2] = 0.0
        mask = rng.uniform(size=lead + (H, W)) < 0.9
        scale = np.full(lead, 0.9, np.float32)
        shift = np.full(lead, 0.1, np.float32)
        index = (np.int32(i + 1) if micro == 1
                 else np.array([i, i + 2], np.int32))
        keys = [key] if micro == 1 else list(jax.random.split(key, micro))
        for k in keys:
            queue.extend(_jax_origins(tcfg, k, (H, W)))
        use_mask = case == "co-gs_mono_masked"
        jargs = [jnp.asarray(gt), key, jnp.asarray(mask) if use_mask else None,
                 jnp.asarray(depth), jnp.asarray(scale), jnp.asarray(shift),
                 jnp.asarray(index) if num_cams else None]
        targs = [torch.from_numpy(gt), None,
                 torch.from_numpy(mask) if use_mask else None,
                 torch.from_numpy(depth), torch.from_numpy(scale),
                 torch.from_numpy(shift),
                 torch.as_tensor(index) if num_cams else None]
        lrs = {g: float(cfg.schedule_for(g)(torch.tensor(i))) for g in GROUPS}
        jstate, jm = jfn(jstate, jc, *jargs)
        state, tm = tfn(state, tc, *targs)
        assert not queue, "the port drew fewer origins than gstk_tpu"
        for k in ("loss", "main_loss", "psnr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"{case} step {i} {k}")
        j_flat = _flat(jstate, tmp_path)
        t_flat = tckpt.train_state_to_numpy(state)
        assert sorted(t_flat) == sorted(j_flat)
        _compare_states(f"{case} step {i}", t_flat, j_flat, before, lrs)
        if num_cams:
            for k in (".cam_adam/.mu/['camera_opt']",):
                _grad_close(f"{case} step {i} {k}", t_flat[k], j_flat[k])
            _grad_close(f"{case} step {i} sqrt cam nu",
                        np.sqrt(t_flat[".cam_adam/.nu/['camera_opt']"]),
                        np.sqrt(j_flat[".cam_adam/.nu/['camera_opt']"]))
            d_t = t_flat[".cam_adjust"] - before[".cam_adjust"]
            d_j = j_flat[".cam_adjust"] - before[".cam_adjust"]
            lr = float(jopt.exponential_decay(
                cam_cfg.lr, cam_cfg.lr_final, cam_cfg.max_steps)(i))
            np.testing.assert_allclose(d_t, d_j, rtol=RTOL_GRAD,
                                       atol=2.0 * lr * 1e-3)
            np.testing.assert_array_equal(t_flat[".cam_adam/.count"],
                                          j_flat[".cam_adam/.count"])
            for k in ("camera_opt_translation", "camera_opt_rotation"):
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=RTOL_GRAD)
            moved = np.abs(d_t).sum(-1) > 0
            assert moved[np.atleast_1d(index)].all()
        if isinstance(tcfg, tdepth.DepthConfig):
            assert "depth_l1" in tm or "depth_local_pearson" in tm
        if "frozen_groups" in kw:
            assert not t_flat[".adam/.mu/['means']"].any()
            np.testing.assert_array_equal(t_flat[".scene/.means"],
                                          flat0[".scene/.means"])
        before = j_flat
