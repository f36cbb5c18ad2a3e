"""Gradients at exact ties: where gstk_tpu clips a differentiated value with
``jnp.minimum``/``jnp.maximum``/``jnp.clip``/``jnp.max``, JAX splits the
gradient in half between tied operands; the port must too (``torch.clamp``
or ``torch.max(dim)`` would pass all of it to one side).

Each case builds inputs that sit exactly on a tie and compares the port's
gradient with ``jax.grad``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gstk_tpu.core import cameras as jcam
from gstk_tpu.core import gaussians as jgs
from gstk_tpu.models import vanilla as jvan
from gstk_tpu.ops import projection as jproj
from gstk_torch.core import cameras as tcam
from gstk_torch.core import gaussians as tgs
from gstk_torch.models import vanilla as tvan
from gstk_torch.ops import projection as tproj

torch.set_num_threads(2)

H, W = 48, 64
FX = FY = 0.5 * W / np.tan(0.5 * np.deg2rad(60.0))


def test_projection_clip_tie_matches_jax():
    """Means exactly on the 1.3 tan(fov) view-space clip, on both sides."""
    tan_x = np.float32(0.5 * W / np.float32(FX))
    tan_y = np.float32(0.5 * H / np.float32(FY))
    lim_x, lim_y = np.float32(1.3) * tan_x, np.float32(1.3) * tan_y
    z = np.float32(2.0)  # 1 / z is exact, so t * (1 / z) lands on the limit
    means = np.array([[z * lim_x, -z * lim_y, z], [-z * lim_x, 0.1, z],
                      [0.2, 0.3, 3.0]], np.float32)
    assert means[0, 0] * (1 / z) == lim_x and means[0, 1] * (1 / z) == -lim_y
    r = np.random.default_rng(3)
    cov = [r.uniform(0.01, 0.1, 3).astype(np.float32) for _ in range(6)]
    w_out = r.normal(size=(3, 3)).astype(np.float32)
    view = np.eye(4, dtype=np.float32)

    def jloss(m):
        cov2d, _, _ = jproj._project_cov3d_ewa(
            m, [jnp.asarray(c) for c in cov], jnp.asarray(view),
            jnp.float32(FX), jnp.float32(FY), jnp.float32(tan_x),
            jnp.float32(tan_y),
        )
        return jnp.sum(cov2d * w_out)

    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(means)))
    m = torch.tensor(means, requires_grad=True)
    cov2d, _, _ = tproj._project_cov3d_ewa(
        m, [torch.from_numpy(c) for c in cov], torch.from_numpy(view),
        torch.tensor(FX, dtype=torch.float32), torch.tensor(FY, dtype=torch.float32),
        torch.tensor(tan_x), torch.tensor(tan_y),
    )
    (tgrad,) = torch.autograd.grad((cov2d * torch.from_numpy(w_out)).sum(), m)
    np.testing.assert_allclose(tgrad.numpy(), jgrad, rtol=1e-5, atol=1e-6)


def _sh_tie_dc() -> np.float32:
    """A DC coefficient d with f32(SH_C0 * d) == -0.5 exactly, so the
    color's ``max(rgb + 0.5, 0)`` sits on its tie."""
    c0 = np.float32(0.28209479177387814)
    d = np.float32(-0.5 / c0)
    for _ in range(8):
        if c0 * d == np.float32(-0.5):
            return d
        d = np.nextafter(d, np.float32(0.0) if c0 * d < -0.5 else np.float32(-1.0))
    raise AssertionError("no exact tie found")


def test_render_scene_ties_match_jax():
    """White background: every pixel no Gaussian reaches is exactly 1.0, the
    tie of ``min(rgb, 1)``; Gaussian 0's red sits on ``max(rgb + 0.5, 0)``.
    Gradients of a weighted rgb sum w.r.t. the background and every
    parameter must match jax.grad's (gradient tolerances, rtol 5e-3)."""
    r = np.random.default_rng(4)
    n = 12
    arrays = {
        "means": np.stack([r.uniform(-1.5, 1.5, n), r.uniform(-1, 1, n),
                           r.uniform(-6, -4, n)], -1),
        "scales": r.uniform(-2.5, -1.5, (n, 3)),
        "quats": r.normal(size=(n, 4)),
        "features_dc": r.normal(size=(n, 3)),
        "features_rest": np.zeros((n, 3, 3)),
        "opacities": r.uniform(0.0, 2.0, (n, 1)),
    }
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    arrays["means"][0] = (0.0, 0.0, -5.0)
    arrays["features_dc"][0, 0] = _sh_tie_dc()
    arrays["alive"] = np.ones(n, bool)
    w_rgb = r.normal(size=(H, W, 3)).astype(np.float32)
    bg = np.ones(3, np.float32)
    cfg_kw = dict(sh_degree=1, background_color="white")
    names = ("means", "scales", "quats", "features_dc", "opacities")

    jscene = jgs.GaussianScene(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jcamera = jcam.Camera(fx=jnp.float32(FX), fy=jnp.float32(FY),
                          cx=jnp.float32(W / 2), cy=jnp.float32(H / 2),
                          c2w=jnp.asarray(np.eye(4, dtype=np.float32)[:3]))

    def jloss(params, b):
        out = jvan.render_scene(
            jscene._replace(**params), jcamera, H, W, sh_degree=0,
            background=b, config=jvan.VanillaConfig(**cfg_kw),
            raster_config=jvan.RasterizeConfig(isect_capacity=1 << 12),
        )
        return jnp.sum(out["rgb"] * w_rgb), out["rgb"]

    (_, jrgb), (jgp, jgb) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        {k: getattr(jscene, k) for k in names}, jnp.asarray(bg)
    )
    scene = tgs.scene_from_numpy(arrays, device="cpu")
    camera = tcam.Camera.create(FX, FY, W / 2, H / 2, np.eye(4)[:3], device="cpu")
    b = torch.tensor(bg, requires_grad=True)
    out = tvan.render_scene(
        scene, camera, H, W, sh_degree=0, background=b,
        config=tvan.VanillaConfig(**cfg_kw),
        raster_config=tvan.RasterizeConfig(isect_capacity=1 << 12),
    )
    # the tie of min(rgb, 1) is really there: empty pixels are exactly 1.0
    assert (out["rgb"] == 1.0).float().mean() > 0.3
    params = [getattr(scene, k) for k in names]
    grads = torch.autograd.grad((out["rgb"] * torch.from_numpy(w_rgb)).sum(),
                                params + [b])
    np.testing.assert_allclose(out["rgb"].detach().numpy(), np.asarray(jrgb),
                               rtol=1e-4, atol=1e-5)
    # a sum over all pixels: rounding of the order, 1e-5 of the largest
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgb), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(jgb)).max())
    for name, g in zip(names, grads[:-1]):
        want = np.asarray(jgp[name])
        np.testing.assert_allclose(g.numpy(), want, rtol=5e-3,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)
    assert jgp["features_dc"][0, 0] != 0.0  # the SH tie passes half


def test_scale_regularizer_ties_match_jax():
    """Two equal largest axes: jnp.max splits the gradient between them."""
    n = 4
    scales = np.log(np.array([[1.0, 1.0, 0.05], [0.5, 0.02, 0.5],
                              [0.3, 0.3, 0.3], [2.0, 0.1, 0.1]], np.float32))
    arrays = {
        "means": np.zeros((n, 3), np.float32), "scales": scales,
        "quats": np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
        "features_dc": np.zeros((n, 3), np.float32),
        "features_rest": np.zeros((n, 0, 3), np.float32),
        "opacities": np.zeros((n, 1), np.float32), "alive": np.ones(n, bool),
    }
    img = np.full((16, 16, 3), 0.5, np.float32)
    cfg_kw = dict(use_scale_regularization=True)
    jscene = jgs.GaussianScene(**{k: jnp.asarray(v) for k, v in arrays.items()})

    def jreg(s):
        return jvan.rgb_loss(jnp.asarray(img), jnp.asarray(img),
                             jscene._replace(scales=s),
                             jvan.VanillaConfig(**cfg_kw),
                             apply_scale_reg=True)["scale_reg"]

    jgrad = np.asarray(jax.grad(jreg)(jnp.asarray(scales)))
    scene = tgs.scene_from_numpy(arrays, device="cpu")
    reg = tvan.rgb_loss(torch.from_numpy(img), torch.from_numpy(img), scene,
                        tvan.VanillaConfig(**cfg_kw), apply_scale_reg=True)
    (tgrad,) = torch.autograd.grad(reg["scale_reg"], scene.scales)
    np.testing.assert_allclose(float(reg["scale_reg"].detach()),
                               float(jreg(jnp.asarray(scales))), rtol=1e-6)
    np.testing.assert_allclose(tgrad.numpy(), jgrad, rtol=1e-5, atol=1e-7)
    assert jgrad[0, 0] == jgrad[0, 1] != 0.0
