"""Vanilla 3D Gaussian Splatting model: render and loss (port of
``gstk_tpu/models/vanilla.py``).

:func:`render_scene` runs projection and SH (:func:`splat_inputs`) and one
fused rasterization pass with RGB plus depth as a 4th channel; a zero
``xys_offset`` gives the screen-space positional gradient that densification
reads. :func:`rgb_loss` is (1 - lambda) L1 + lambda (1 - SSIM) with an
optional mask and scale regularizer. Wherever gstk_tpu clips a
differentiated value with ``jnp.minimum``/``jnp.maximum``, the port uses
``torch.minimum``/``torch.maximum``, whose gradient splits at a tie as
JAX's does (``torch.clamp`` would pass all of it). The crop box is not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from gstk_torch.core.cameras import Camera, camera_matrices
from gstk_torch.core.gaussians import GaussianScene
from gstk_torch.ops.projection import project_gaussians
from gstk_torch.ops.rasterize import RasterizeConfig, rasterize
from gstk_torch.ops.sh import spherical_harmonics
from gstk_torch.utils import losses
from gstk_torch.utils.math import normalize


@dataclasses.dataclass(frozen=True)
class VanillaConfig:
    """Model hyperparameters (the same fields as gstk_tpu's VanillaConfig;
    rendering reads ``sh_degree``, ``sh_degree_interval`` and
    ``rasterize_mode``)."""

    warmup_length: int = 500
    refine_every: int = 100
    resolution_schedule: int = 2000
    background_color: str = "random"  # random | black | white
    num_downscales: int = 2
    cull_alpha_thresh: float = 0.1
    cull_scale_thresh: float = 0.5
    continue_cull_post_densification: bool = True
    reset_alpha_every: int = 30
    densify_grad_thresh: float = 0.0002
    densify_size_thresh: float = 0.01
    n_split_samples: int = 2
    sh_degree_interval: int = 1000
    cull_screen_size: float = 0.15
    split_screen_size: float = 0.05
    stop_screen_size_at: int = 4000
    random_init: bool = False
    num_random: int = 50000
    random_scale: float = 10.0
    ssim_lambda: float = 0.2
    stop_split_at: int = 10_000
    sh_degree: int = 3
    use_scale_regularization: bool = False
    max_gauss_ratio: float = 10.0
    rasterize_mode: str = "classic"  # classic | antialiased


def active_sh_degree(cfg: VanillaConfig, step) -> torch.Tensor:
    """SH degree schedule: step // interval, capped at cfg.sh_degree."""
    return torch.clamp(
        torch.as_tensor(step) // cfg.sh_degree_interval, max=cfg.sh_degree
    )


def downscale_factor(cfg: VanillaConfig, step: int) -> int:
    """Coarse-to-fine image downscale factor at ``step`` (host-side)."""
    return 2 ** max(cfg.num_downscales - int(step) // cfg.resolution_schedule, 0)


def splat_inputs(
    scene: GaussianScene,
    camera: Camera,
    img_height: int,
    img_width: int,
    *,
    sh_degree: int,
    config: VanillaConfig = VanillaConfig(),
    block_width: int = 16,
) -> Dict[str, torch.Tensor]:
    """Projection, SH colors and opacities of one view: the arguments of
    :func:`gstk_torch.ops.rasterize.rasterize` (``colors`` holds RGB plus
    depth as a 4th channel; dead lanes have radius, tile count and opacity
    0)."""
    means = scene.means
    quats = normalize(scene.quats)
    scales = torch.exp(scene.scales)
    viewmat, fullmat = camera_matrices(camera, img_height, img_width)

    proj = project_gaussians(
        means, scales, 1.0, quats, viewmat, fullmat,
        camera.fx, camera.fy, camera.cx, camera.cy,
        img_height, img_width, block_width,
    )
    # dead lanes never enter binning or compositing
    alive = scene.alive

    if sh_degree > 0 or config.sh_degree > 0:
        coeffs = torch.cat(
            [scene.features_dc[:, None, :], scene.features_rest], dim=1
        )
        viewdirs = normalize(means.detach() - camera.position.detach()[None, :])
        rgbs = spherical_harmonics(int(sh_degree), viewdirs, coeffs)
        rgbs = rgbs + 0.5
        rgbs = torch.maximum(rgbs, torch.zeros_like(rgbs))
    else:
        rgbs = torch.sigmoid(scene.features_dc)

    opac = torch.sigmoid(scene.opacities)[:, 0]
    if config.rasterize_mode == "antialiased":
        opac = opac * proj.compensation
    elif config.rasterize_mode != "classic":
        raise ValueError(f"Unknown rasterize_mode {config.rasterize_mode}")
    return {
        "xys": proj.xys,
        "depths": proj.depths,
        "radii": torch.where(alive, proj.radii, 0),
        "conics": proj.conics,
        "num_tiles_hit": torch.where(alive, proj.num_tiles_hit, 0),
        # one fused pass: RGB + depth as a 4th channel
        "colors": torch.cat([rgbs, proj.depths[:, None]], dim=-1),
        "opacities": torch.where(alive, opac, 0.0),
    }


def render_scene(
    scene: GaussianScene,
    camera: Camera,
    img_height: int,
    img_width: int,
    *,
    sh_degree: int,
    background: torch.Tensor,
    config: VanillaConfig = VanillaConfig(),
    raster_config: RasterizeConfig = RasterizeConfig(),
    xys_offset: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Render one camera view: rgb (H,W,3), depth (H,W), alpha (H,W),
    background, radii, visible, num_intersects.

    ``sh_degree`` is the active degree. ``xys_offset`` is an optional (C, 2)
    zero tensor added to the projected centers; its gradient is the
    screen-space positional gradient that densification reads."""
    inputs = splat_inputs(
        scene, camera, img_height, img_width, sh_degree=sh_degree,
        config=config, block_width=raster_config.block_width,
    )
    if xys_offset is not None:
        inputs["xys"] = inputs["xys"] + xys_offset
    bg4 = torch.cat([background, background.new_zeros(1)])  # depth bg = 0
    img4, alpha, raster_info = rasterize(
        **inputs, img_height=img_height, img_width=img_width,
        background=bg4, config=raster_config, return_info=True,
    )
    rgb = img4[..., :3]
    rgb = torch.minimum(rgb, torch.ones_like(rgb))
    depth_acc = img4[..., 3]
    # depth / alpha where alpha > 0, else the max accumulated depth
    fill = depth_acc.max().detach()
    depth = torch.where(
        alpha > 0,
        depth_acc / torch.maximum(alpha, torch.full_like(alpha, 1e-10)),
        fill,
    )
    return {
        "rgb": rgb,
        "depth": depth,
        "alpha": alpha,
        "background": background,
        "radii": inputs["radii"],
        "visible": inputs["radii"] > 0,
        "num_intersects": raster_info["num_intersects"],
    }


def composite_gt_with_background(image: torch.Tensor, background: torch.Tensor):
    """RGBA ground truth over the train background."""
    if image.shape[-1] == 4:
        a = image[..., 3:4]
        return a * image[..., :3] + (1.0 - a) * background
    return image


def rgb_loss(
    pred: torch.Tensor,
    gt: torch.Tensor,
    scene: GaussianScene,
    config: VanillaConfig,
    mask: Optional[torch.Tensor] = None,
    apply_scale_reg: bool = False,
) -> Dict[str, torch.Tensor]:
    """(1-lambda) L1 + lambda (1-SSIM), and the scale regularizer
    (``scale_reg``, zero unless ``config.use_scale_regularization`` and
    ``apply_scale_reg``)."""
    if mask is not None:
        m = mask.to(pred.dtype)
        if m.ndim == 2:
            m = m[..., None]
        pred = pred * m
        gt = gt * m
    ll1 = losses.l1(pred, gt)
    simloss = 1.0 - losses.ssim(gt, pred)
    out = {
        "main_loss": (1.0 - config.ssim_lambda) * ll1
        + config.ssim_lambda * simloss,
    }
    if config.use_scale_regularization and apply_scale_reg:
        scale_exp = torch.exp(scene.scales)
        # amax/amin split the gradient among tied axes, as jnp.max/min do
        lo = torch.amin(scale_exp, dim=-1)
        ratio = torch.amax(scale_exp, dim=-1) / torch.maximum(
            lo, torch.full_like(lo, 1e-12)
        )
        reg = torch.maximum(
            ratio, torch.full_like(ratio, config.max_gauss_ratio)
        ) - config.max_gauss_ratio
        # only alive lanes contribute, normalized by the alive count
        reg = torch.where(scene.alive, reg, 0.0)
        denom = torch.clamp(scene.num_alive.to(reg.dtype), min=1.0)
        out["scale_reg"] = 0.1 * reg.sum() / denom
    else:
        out["scale_reg"] = pred.new_zeros(())
    return out
