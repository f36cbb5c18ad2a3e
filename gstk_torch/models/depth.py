"""Depth-supervised Gaussian Splatting ("co-gs"): the config and its loss
terms (port of ``gstk_tpu/models/depth.py``).

The render path is vanilla's (depth is composited as the 4th channel);
:func:`depth_loss_terms` adds the depth-loss zoo with the reference's
iteration gates as float tensors computed from the step counter on the
device, so a step neither branches on the step in Python nor waits for the
device:

  * sensor path: masked depth L1 over nonzero GT;
  * mono-depth path (``use_est_depth``): local Pearson patches, the
    scale/shift-corrected log-L1 with image-gradient weights, edge-aware
    depth smoothing, TV;
  * sparse opacity entropy every 100 steps, in sigmoid space;
  * the planar prior by least-squares local plane fits.

gstk_tpu's deviations from the reference are kept: ``main_loss`` stays
vanilla's (1 - lambda) L1 + lambda (1 - SSIM) and the sensor term is
weighted by ``depth_lambda``; ``mono_depth_l1_start_iteration`` is never
read; the TV gate is ``step < 20_000``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from gstk_torch.core.gaussians import GaussianScene
from gstk_torch.models.vanilla import VanillaConfig
from gstk_torch.utils import losses


@dataclasses.dataclass(frozen=True)
class DepthConfig(VanillaConfig):
    """co-gs hyperparameters (depth_gs.py:39-145)."""

    num_downscales: int = 0
    stop_screen_size_at: int = 8000
    stop_split_at: int = 25_000
    use_sparse_loss: bool = False
    sparse_lambda: float = 0.1
    use_depth_loss: bool = True
    depth_lambda: float = 0.1
    depth_loss_start_iteration: int = 6_000
    depth_loss_stop_iteration: int = 25_000
    use_est_depth: bool = False
    use_pearson_depth: bool = False
    mono_depth_l1_start_iteration: int = 15_000
    use_scaled_est_depth: bool = False
    local_patch_size: int = 128
    use_depth_regularization: bool = False
    using_planar_loss: bool = False
    planar_loss_start_iteration: int = 10_000
    using_tv_loss: bool = False


def depth_loss_terms(
    cfg: DepthConfig,
    step: torch.Tensor,
    pred_depth: torch.Tensor,
    gt_depth: Optional[torch.Tensor],
    gt_img: torch.Tensor,
    scene: GaussianScene,
    generator: Optional[torch.Generator] = None,
    mask: Optional[torch.Tensor] = None,
    mono_scale: Optional[torch.Tensor] = None,
    mono_shift: Optional[torch.Tensor] = None,
    camera=None,
    pearson_origins: Optional[losses.Origins] = None,
    planar_origins: Optional[losses.Origins] = None,
) -> Dict[str, torch.Tensor]:
    """The loss terms beyond the vanilla RGB loss, by name. ``step`` is the
    0-d step counter on the device. The Pearson origins are drawn from
    ``generator`` before the planar ones, each only when its term is on,
    unless given as ``pearson_origins`` / ``planar_origins``."""
    out: Dict[str, torch.Tensor] = {}
    f32 = torch.float32

    if cfg.use_sparse_loss:
        gate = (step % 100 == 0).to(f32)
        out["sparse_loss"] = (
            cfg.sparse_lambda
            * gate
            * losses.sparse_opacity_loss(
                torch.sigmoid(scene.opacities[:, 0]), scene.alive
            )
        )

    if gt_depth is None or not cfg.use_depth_loss:
        return out

    if mask is not None:
        m = mask.to(pred_depth.dtype)
        pred_depth = pred_depth * m
        gt_depth = gt_depth * m

    in_window = (step > cfg.depth_loss_start_iteration).to(f32)
    before_stop = (step < cfg.depth_loss_stop_iteration).to(f32)

    if cfg.use_est_depth:
        if cfg.use_pearson_depth:
            out["depth_local_pearson"] = (
                in_window
                * before_stop
                * losses.local_pearson_loss(
                    pred_depth, gt_depth,
                    box_size=min(cfg.local_patch_size,
                                 min(pred_depth.shape) - 1),
                    generator=generator, origins=pearson_origins,
                )
            )
        if cfg.use_scaled_est_depth and mono_scale is not None:
            out["log_depth"] = in_window * losses.log_depth_gradient_loss(
                pred_depth, gt_depth, gt_img, mono_scale, mono_shift
            )
        if cfg.use_depth_regularization:
            out["depth_reg_loss"] = in_window * losses.edge_aware_smooth_loss(
                pred_depth, gt_img
            )
        if cfg.using_tv_loss:
            tv_gate = (step < 20_000).to(f32)
            out["tv_loss"] = in_window * tv_gate * losses.total_variation(
                pred_depth
            )
    else:
        out["depth_l1"] = (
            cfg.depth_lambda * in_window * losses.depth_l1(pred_depth, gt_depth)
        )

    if cfg.using_planar_loss and camera is not None:
        gate = (step > cfg.planar_loss_start_iteration).to(f32)
        out["planar_loss"] = gate * 10.0 * losses.local_planar_loss(
            pred_depth, camera.fx, camera.fy, camera.cx, camera.cy,
            generator,
            patch_size=min(cfg.local_patch_size, min(pred_depth.shape) // 2),
            origins=planar_origins,
        )
    return out
