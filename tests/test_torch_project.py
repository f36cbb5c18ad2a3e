"""The projection kernels' dispatch, wrapper checks and plain twin (CPU).

``models/vanilla.py::splat_inputs`` takes the two kernels of
``ops/project_cuda.py`` for CUDA tensors under the rasterizer's ``"auto"``
backend, camera gradients included; for CPU tensors and under ``"plain"`` it
runs ``splat_inputs_plain``, which is held here against
gstk_tpu's render_scene up to the rasterizer (tests/test_torch_ops.py's
projection tolerances). The kernels themselves run on the card only
(tests/test_torch_gpu.py); here their wrapper must refuse what they do not
take before any launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstk_tpu.core import cameras as jcam
from gstk_torch.core import cameras as tcam
from gstk_torch.core import gaussians as tgs
from gstk_torch.core.scene_box import SceneBox
from gstk_torch.models import vanilla as tvan
from gstk_torch.ops import project_cuda

torch.set_num_threads(2)

H, W = 48, 64
FX = FY = 0.5 * W / np.tan(0.5 * np.deg2rad(60.0))


def _arrays(n=300, sh=3, seed=0):
    r = np.random.default_rng(seed)
    arrays = {
        "means": np.stack([r.uniform(-2, 2, n), r.uniform(-1.5, 1.5, n),
                           r.uniform(-8, 0.5, n)], -1),
        "scales": r.uniform(-4, -1, (n, 3)),
        "quats": r.normal(size=(n, 4)),
        "features_dc": r.normal(size=(n, 3)),
        "features_rest": 0.3 * r.normal(size=(n, (sh + 1) ** 2 - 1, 3)),
        "opacities": r.uniform(-1, 3, (n, 1)),
    }
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    arrays["alive"] = r.random(n) > 0.15
    return arrays


def _camera(requires_grad=False):
    c2w = torch.eye(4)[:3].clone()
    c2w[:, 3] = torch.tensor([0.1, -0.2, 0.3])
    if requires_grad:
        c2w.requires_grad_()
    f = lambda x: torch.tensor(x, dtype=torch.float32)
    return tcam.Camera(f(FX), f(FY), f(W / 2), f(H / 2), c2w)


@pytest.mark.parametrize("case", ["cpu", "cuda", "cpu_plain", "cuda_plain",
                                  "unknown"])
def test_dispatch_rule(case):
    """The rasterizer's backend rule: ``"auto"`` takes the kernels for CUDA
    tensors, ``"plain"`` keeps the plain path on any device, another name
    is refused."""
    device = torch.device(case.split("_")[0] if case != "unknown" else "cuda")
    backend = {"unknown": "fused"}.get(
        case, "plain" if case.endswith("_plain") else "auto")
    if case == "unknown":
        with pytest.raises(ValueError, match="fused"):
            tvan._takes_kernels(device, backend)
        return
    assert tvan._takes_kernels(device, backend) == (case == "cuda")


@pytest.mark.parametrize("case", ["plain", "crop_box", "camera_grad"])
def test_splat_inputs_on_cpu_is_the_plain_twin(case):
    """On the CPU splat_inputs is splat_inputs_plain bit for bit and
    launches no kernel; with a camera that requires grad the pose gets a
    gradient."""
    scene = tgs.scene_from_numpy(_arrays(), device="cpu")
    camera = _camera(requires_grad=case == "camera_grad")
    box = SceneBox(torch.tensor([[-1.0, -1.0, -6.0], [1.0, 1.0, -1.0]]))
    crop = box if case == "crop_box" else None
    before = (project_cuda.project_fwd.launches,
              project_cuda.project_bwd.launches)
    got = tvan.splat_inputs(scene, camera, H, W, sh_degree=2,
                            config=tvan.VanillaConfig(
                                rasterize_mode="antialiased"),
                            crop_box=crop)
    viewmat, fullmat = tcam.camera_matrices(camera, H, W)
    alive = scene.alive if crop is None else (
        scene.alive & box.within(scene.means.detach()))
    want = tvan.splat_inputs_plain(
        scene, camera, viewmat, fullmat, alive, H, W, sh_degree=2,
        config=tvan.VanillaConfig(rasterize_mode="antialiased"))
    assert list(got) == list(want) == list(project_cuda.OUTPUT_NAMES)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert (project_cuda.project_fwd.launches,
            project_cuda.project_bwd.launches) == before
    if case == "crop_box":
        full = tvan.splat_inputs_plain(
            scene, camera, viewmat, fullmat, scene.alive, H, W, sh_degree=2)
        assert 0 < int((got["radii"] > 0).sum()) < int((full["radii"] > 0).sum())
    if case == "camera_grad":
        (g,) = torch.autograd.grad(got["xys"].sum(), camera.c2w)
        assert float(g.abs().sum()) > 0


def _jax_splat_inputs(arrays, c2w, degree, mode):
    """gstk_tpu's render_scene up to the rasterizer: its splat inputs."""
    from gstk_tpu.ops.projection import project_gaussians
    from gstk_tpu.ops.sh import spherical_harmonics
    from gstk_tpu.utils.math import normalize

    a = {k: jnp.asarray(v) for k, v in arrays.items()}
    camera = jcam.Camera(fx=jnp.float32(FX), fy=jnp.float32(FY),
                         cx=jnp.float32(W / 2), cy=jnp.float32(H / 2),
                         c2w=jnp.asarray(c2w))
    viewmat, fullmat = jcam.camera_matrices(camera, H, W)
    proj = project_gaussians(a["means"], jnp.exp(a["scales"]), 1.0,
                             normalize(a["quats"]), viewmat, fullmat,
                             camera.fx, camera.fy, camera.cx, camera.cy, H, W)
    coeffs = jnp.concatenate([a["features_dc"][:, None], a["features_rest"]], 1)
    viewdirs = normalize(a["means"] - camera.position[None, :])
    rgbs = jnp.maximum(spherical_harmonics(degree, viewdirs, coeffs) + 0.5, 0.0)
    opac = 1.0 / (1.0 + jnp.exp(-a["opacities"][:, 0]))
    if mode == "antialiased":
        opac = opac * proj.compensation
    alive = a["alive"]
    return {
        "xys": proj.xys, "depths": proj.depths,
        "radii": jnp.where(alive, proj.radii, 0), "conics": proj.conics,
        "num_tiles_hit": jnp.where(alive, proj.num_tiles_hit, 0),
        "colors": jnp.concatenate([rgbs, proj.depths[:, None]], -1),
        "opacities": jnp.where(alive, opac, 0.0),
    }


@pytest.mark.parametrize("degree,mode", [(0, "classic"), (1, "antialiased"),
                                         (2, "classic"), (3, "antialiased")])
def test_plain_twin_matches_jax(degree, mode):
    """splat_inputs_plain (the kernels' twin) against gstk_tpu's render_scene
    up to the rasterizer, dead lanes and lanes behind the camera included,
    with test_torch_ops.py's projection tolerances: radii and tile counts
    equal on 99% of lanes (one ulp may flip one), the projected floats on the
    lanes both keep (xys rtol 1e-4 / atol 1e-4, depths 1e-5 / 1e-6, conics
    1e-4 / 1e-5), colours and opacities rtol 1e-5 / atol 1e-6."""
    arrays = _arrays(sh=3, seed=degree)
    camera = _camera()
    c2w = camera.c2w.numpy()
    want = {k: np.asarray(v)
            for k, v in _jax_splat_inputs(arrays, c2w, degree, mode).items()}
    scene = tgs.scene_from_numpy(arrays, device="cpu")
    viewmat, fullmat = tcam.camera_matrices(camera, H, W)
    with torch.no_grad():
        got = tvan.splat_inputs_plain(
            scene, camera, viewmat, fullmat, scene.alive, H, W,
            sh_degree=degree, config=tvan.VanillaConfig(rasterize_mode=mode))
    got = {k: v.numpy() for k, v in got.items()}
    for k in ("radii", "num_tiles_hit"):
        assert np.mean(got[k] != want[k]) <= 0.01, k
    both = (got["radii"] > 0) & (want["radii"] > 0)
    assert both.sum() > 20
    tol = dict(xys=(1e-4, 1e-4), depths=(1e-5, 1e-6), conics=(1e-4, 1e-5),
               colors=(1e-5, 1e-6), opacities=(1e-5, 1e-6))
    for k, (rtol, atol) in tol.items():
        np.testing.assert_allclose(got[k][both], want[k][both], rtol=rtol,
                                   atol=atol, err_msg=k)


def _wrapper_args(case):
    """The wrapper's arguments with one fault, ``case``."""
    scene = tgs.scene_from_numpy(_arrays(n=32), device="cpu")
    params = [getattr(scene, k).detach() for k in project_cuda.PARAM_NAMES]
    alive = scene.alive
    view = torch.zeros(project_cuda.VIEW_FLOATS)
    setting = project_cuda.Setting(H, W, 16, 3, False, False)
    if case == "dtype":
        params[0] = params[0].double()
    elif case == "shape":
        params[2] = params[2][:, :3]
    elif case == "contiguous":
        params[0] = params[0].t().contiguous().t()
    elif case == "alive":
        alive = alive.to(torch.uint8)
    elif case == "degree":
        params[4] = params[4][:, :7]
    elif case == "sigmoid":
        setting = setting._replace(sh_degree=1, sigmoid_colors=True)
    return params, alive, view, setting


WRAPPER_FAULTS = {"device": "CUDA tensors", "dtype": "float32 expected",
                  "shape": "expected means", "contiguous": "contiguous",
                  "alive": "alive must be bool", "degree": "sh_degree",
                  "sigmoid": "sigmoid"}


@pytest.mark.parametrize("entry", ["fwd", "bwd"])
@pytest.mark.parametrize("case", list(WRAPPER_FAULTS))
def test_wrapper_refuses_what_the_kernels_do_not_take(case, entry):
    """Wrong device (the kernels take CUDA tensors only), dtype, shape,
    strides, alive mask type, SH rows short of the degree, sigmoid colours
    above degree 0: ValueError before any launch."""
    params, alive, view, setting = _wrapper_args(case)
    before = (project_cuda.project_fwd.launches,
              project_cuda.project_bwd.launches)
    with pytest.raises(ValueError, match=WRAPPER_FAULTS[case]):
        if entry == "fwd":
            project_cuda.project_fwd(params, alive, view, setting)
        else:
            project_cuda.project_bwd(params, alive, view,
                                     (None,) * 5, setting)
    assert (project_cuda.project_fwd.launches,
            project_cuda.project_bwd.launches) == before


def test_view_params_carry_the_matrices_gradient_only():
    """The view tensor is differentiable in viewmat and fullmat, entry for
    entry, and in nothing else: the camera position is detached (as the
    plain path's view directions are), and intrinsics that require grad
    are refused."""
    camera = _camera(requires_grad=True)
    viewmat, fullmat = (m.detach().clone().requires_grad_()
                        for m in tcam.camera_matrices(camera, H, W))
    v = project_cuda.view_params(camera, viewmat, fullmat)
    w = torch.arange(project_cuda.VIEW_FLOATS, dtype=torch.float32)
    g_vm, g_fm, g_c2w = torch.autograd.grad(
        (v * w).sum(), (viewmat, fullmat, camera.c2w), allow_unused=True)
    assert torch.equal(g_vm[:3].reshape(-1), w[:12])
    assert torch.equal(g_vm[3], torch.zeros(4))
    assert torch.equal(g_fm.reshape(-1), w[12:28])
    assert g_c2w is None  # the position, read from c2w, is detached
    intrinsic = tcam.Camera(camera.fx.clone().requires_grad_(), camera.fy,
                            camera.cx, camera.cy, camera.c2w)
    with pytest.raises(ValueError, match="not fx, fy, cx or cy"):
        project_cuda.view_params(intrinsic, viewmat, fullmat)


def test_view_params_layout():
    """viewmat rows 0-2, fullmat, fx, fy, cx, cy, the camera position."""
    camera = _camera()
    viewmat, fullmat = tcam.camera_matrices(camera, H, W)
    v = project_cuda.view_params(camera, viewmat, fullmat)
    assert v.shape == (project_cuda.VIEW_FLOATS,) and v.dtype == torch.float32
    assert torch.equal(v[:12], viewmat[:3].reshape(-1))
    assert torch.equal(v[12:28], fullmat.reshape(-1))
    assert torch.equal(v[28:32], torch.stack([camera.fx, camera.fy,
                                              camera.cx, camera.cy]))
    assert torch.equal(v[32:], camera.position)
