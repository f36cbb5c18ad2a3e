"""The train step: render, loss, backward, per-group Adam and densify
statistics (port of ``gstk_tpu/train/step.py``, vanilla method).

The step is eager PyTorch on the state's device. Gradients come from
``torch.autograd.grad`` over the scene's parameters and a zero
``xys_offset`` (the screen-space positional gradient that densification
reads), as gstk_tpu's functional ``value_and_grad`` gives them; Adam then
updates the parameters and moments in place under ``torch.no_grad()``, and
the statistics accumulate into the state's :class:`RefineState`.

``micro_batch`` > 1 sums gradients and statistics over that many cameras in
a Python loop and applies Adam once to the sum. Camera optimisation and the
depth and surface methods (M14), and data parallelism (M15), are later
slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from gstk_torch.core.cameras import Camera
from gstk_torch.core.gaussians import GaussianScene
from gstk_torch.models.vanilla import (
    VanillaConfig,
    composite_gt_with_background,
    render_scene,
    rgb_loss,
)
from gstk_torch.ops.rasterize import RasterizeConfig
from gstk_torch.train.optim import AdamState, OptimizerConfig, adam_step, init_adam
from gstk_torch.train.strategy import RefineState, init_refine_state


@dataclasses.dataclass
class TrainState:
    """What a train step reads and updates; the step mutates it in place."""

    scene: GaussianScene
    adam: AdamState
    refine: RefineState
    step: torch.Tensor  # () int32


def init_train_state(scene: GaussianScene, num_cameras: Optional[int] = None
                     ) -> TrainState:
    """Fresh Adam moments, zero statistics and step 0 on the scene's
    device."""
    if num_cameras is not None:
        raise NotImplementedError(
            "camera optimisation (num_cameras) is not ported yet (M14)"
        )
    device = scene.means.device
    return TrainState(
        scene=scene,
        adam=init_adam(scene.params()),
        refine=init_refine_state(scene.capacity, device),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def _background(generator: Optional[torch.Generator], mode: str,
                device: torch.device) -> torch.Tensor:
    if mode == "random":
        if generator is None:
            raise ValueError("background_color='random' needs a generator")
        return torch.rand(3, generator=generator, device=device)
    if mode == "white":
        return torch.ones(3, device=device)
    if mode == "black":
        return torch.zeros(3, device=device)
    raise ValueError(mode)


def _camera_at(cameras: Camera, i: int) -> Camera:
    """Micro-step i's camera from a Camera whose fields have a leading
    micro-batch dimension."""
    return Camera(**{f.name: getattr(cameras, f.name)[i]
                     for f in dataclasses.fields(Camera)})


def make_train_step(
    model_cfg: VanillaConfig,
    raster_cfg: RasterizeConfig,
    optim_cfg: OptimizerConfig,
    img_height: int,
    img_width: int,
    sh_degree: int,
    apply_scale_reg: bool = False,
    axis_name: Optional[str] = None,
    frozen_groups: tuple = (),
    camera_opt=None,
    micro_batch: int = 1,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The step function for a fixed (image size, active SH degree).

    With ``micro_batch`` = 1 it is ``(state, camera, gt_image,
    generator=None, mask=None) -> (state, metrics)``, ``gt_image`` (H, W,
    3|4) in [0, 1]; with ``micro_batch`` > 1 ``camera``, ``gt_image`` and
    ``mask`` gain a leading micro-batch dimension. ``generator`` draws the
    background when ``model_cfg.background_color`` is "random".
    ``frozen_groups`` get zero gradients. The state is updated in place and
    returned; metrics are 0-d tensors on the device (no host sync)."""
    if axis_name is not None:
        raise NotImplementedError(
            "data parallelism (axis_name) is not ported yet (M15)"
        )
    if camera_opt is not None:
        raise NotImplementedError(
            "camera optimisation (camera_opt) is not ported yet (M14)"
        )
    if type(model_cfg) is not VanillaConfig:
        raise NotImplementedError(
            f"{type(model_cfg).__name__}: the depth and surface methods are "
            "not ported yet (M14)"
        )
    if micro_batch < 1:
        raise ValueError(f"micro_batch must be >= 1, got {micro_batch}")
    max_img_size = max(img_height, img_width)

    def grads_once(state, camera, gt_image, generator, mask):
        """Forward and backward for one camera."""
        scene = state.scene
        device = scene.means.device
        background = _background(generator, model_cfg.background_color, device)
        gt = composite_gt_with_background(gt_image, background)
        xys_offset = torch.zeros((scene.capacity, 2), device=device,
                                 requires_grad=True)
        out = render_scene(
            scene, camera, img_height, img_width, sh_degree=sh_degree,
            background=background, config=model_cfg,
            raster_config=raster_cfg, xys_offset=xys_offset,
        )
        ld = rgb_loss(out["rgb"], gt, scene, model_cfg, mask, apply_scale_reg)
        loss = sum(ld.values())
        params = scene.params()
        grads = torch.autograd.grad(
            loss, [*params.values(), xys_offset], allow_unused=True
        )
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip([*params.values(), xys_offset], grads)]
        mse = torch.mean((out["rgb"].detach() - gt[..., :3]) ** 2)
        metrics = {
            "loss": loss.detach(),
            "main_loss": ld["main_loss"].detach(),
            "psnr": -10.0 * torch.log10(torch.clamp(mse, min=1e-10)),
            "num_intersects": out["num_intersects"],
        }
        return dict(zip(params, grads[:-1])), grads[-1], out["radii"], metrics

    def apply(state, grads, refine):
        """Adam on the summed gradients, the new statistics, the step."""
        grads = {k: torch.zeros_like(v) if k in frozen_groups else v
                 for k, v in grads.items()}
        state.adam = adam_step(
            state.scene.params(), grads, state.adam, state.step, optim_cfg,
            update_mask=state.scene.alive,
        )
        state.refine = refine
        state.step = state.step + 1
        return state

    def train_step(state: TrainState, camera: Camera, gt_image: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   mask: Optional[torch.Tensor] = None):
        num_alive = state.scene.num_alive
        grads, g_xys, radii, metrics = grads_once(
            state, camera, gt_image, generator, mask
        )
        refine = RefineState(
            xys_grad_norm=state.refine.xys_grad_norm
            + torch.linalg.norm(g_xys, dim=-1),
            vis_counts=state.refine.vis_counts + (radii > 0).to(torch.float32),
            max_2dsize=torch.maximum(
                state.refine.max_2dsize,
                radii.to(torch.float32) / max_img_size,
            ),
        )
        metrics["num_alive"] = num_alive
        return apply(state, grads, refine), metrics

    if micro_batch == 1:
        return train_step

    def micro_train_step(state: TrainState, cameras: Camera,
                         gt_images: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         masks: Optional[torch.Tensor] = None):
        num_alive = state.scene.num_alive
        capacity = state.scene.capacity
        zeros = lambda: torch.zeros(capacity, dtype=torch.float32,
                                    device=state.scene.means.device)
        gsum, gx_sum, vis_sum, rad_max, ys = None, zeros(), zeros(), zeros(), []
        for i in range(micro_batch):
            grads, g_xys, radii, m = grads_once(
                state, _camera_at(cameras, i), gt_images[i], generator,
                None if masks is None else masks[i],
            )
            gsum = grads if gsum is None else {k: gsum[k] + v
                                               for k, v in grads.items()}
            gx_sum = gx_sum + torch.linalg.norm(g_xys, dim=-1)
            vis_sum = vis_sum + (radii > 0).to(torch.float32)
            rad_max = torch.maximum(rad_max, radii.to(torch.float32))
            ys.append(m)
        refine = RefineState(
            xys_grad_norm=state.refine.xys_grad_norm + gx_sum,
            vis_counts=state.refine.vis_counts + vis_sum,
            max_2dsize=torch.maximum(state.refine.max_2dsize,
                                     rad_max / max_img_size),
        )
        stacked = {k: torch.stack([m[k] for m in ys]) for k in ys[0]}
        metrics = {
            "loss": stacked["loss"].mean(),
            "main_loss": stacked["main_loss"].mean(),
            "psnr": stacked["psnr"].mean(),
            "num_alive": num_alive,
            "num_intersects": stacked["num_intersects"].max(),
        }
        return apply(state, gsum, refine), metrics

    return micro_train_step
