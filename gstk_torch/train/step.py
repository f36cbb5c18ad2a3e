"""The train step: render, loss, backward, per-group Adam and densify
statistics (port of ``gstk_tpu/train/step.py``).

The step is eager PyTorch on the state's device. Gradients come from
``torch.autograd.grad`` over the scene's parameters, a zero ``xys_offset``
(the screen-space positional gradient that densification reads) and, with
camera optimisation, the pose adjustments, as gstk_tpu's functional
``value_and_grad`` gives them; Adam then updates the parameters and moments
in place under ``torch.no_grad()``, and the statistics accumulate into the
state's :class:`RefineState`.

Every method of ``configs/methods.py`` trains through it: a
:class:`DepthConfig` adds :func:`depth_loss_terms` (co-gs), and
``frozen_groups=("means",)`` holds surface-gs's means. With a
``camera_opt`` whose mode is not "off", the state's (num_cameras, 6)
adjustment of the step's camera is composed onto it, the L2 pose penalty
joins the loss, and the adjustments get their own exp-decayed Adam group,
stepped at the state's step with no update mask.

``micro_batch`` > 1 sums gradients and statistics over that many cameras in
a Python loop and applies Adam once to the sum.

With ``axis_name`` (``"data"``) the step is one rank's share of a
data-parallel step over the mesh's axis of that name
(:mod:`gstk_torch.parallel.mesh`), each rank with its own camera: the
gradients of every group and the loss metrics are averaged over the axis
(gstk_tpu's ``pmean``: a sum, then a division by the axis size) in one flat
f32 all-reduce, the visibility counts summed as int32 (exact) and the radii
and intersection counts maxed in one int32 all-reduce each, so every rank
applies the same update and the same densify statistics. A mesh with a
``"gauss"`` axis shards the scene over it
(:mod:`gstk_torch.parallel.gaussian_sharding`): the step renders through
the gathered projection, sums the alive count and the camera group's
gradient over that axis, and keeps Adam and the statistics local.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from gstk_torch.core.camera_opt import (
    CameraOptConfig,
    apply_to_camera,
    init_camera_opt,
    pose_regularizer,
)
from gstk_torch.core.cameras import Camera
from gstk_torch.core.gaussians import GaussianScene
from gstk_torch.models.depth import DepthConfig, depth_loss_terms
from gstk_torch.models.vanilla import (
    VanillaConfig,
    composite_gt_with_background,
    render_scene,
    rgb_loss,
)
from gstk_torch.ops.rasterize import RasterizeConfig
from gstk_torch.parallel import gaussian_sharding
from gstk_torch.parallel.mesh import Mesh, get_mesh
from gstk_torch.train.optim import AdamState, OptimizerConfig, adam_step, init_adam
from gstk_torch.train.strategy import RefineState, init_refine_state
from gstk_torch.utils.losses import f32_convolutions


@dataclasses.dataclass
class TrainState:
    """What a train step reads and updates; the step mutates it in place."""

    scene: GaussianScene
    adam: AdamState
    refine: RefineState
    step: torch.Tensor  # () int32
    # camera-pose refinement (None unless enabled): (num_cameras, 6)
    # tangent-space adjustments and their own Adam moments
    cam_adjust: Optional[torch.Tensor] = None
    cam_adam: Optional[AdamState] = None


def init_train_state(scene: GaussianScene, num_cameras: Optional[int] = None
                     ) -> TrainState:
    """Fresh Adam moments, zero statistics and step 0 on the scene's
    device; ``num_cameras`` adds zero pose adjustments and their Adam
    moments (the camera-opt group)."""
    device = scene.means.device
    cam_adjust = cam_adam = None
    if num_cameras is not None:
        cam_adjust = init_camera_opt(num_cameras, device)
        cam_adam = init_adam({"camera_opt": cam_adjust})
    return TrainState(
        scene=scene,
        adam=init_adam(scene.params()),
        refine=init_refine_state(scene.capacity, device),
        step=torch.zeros((), dtype=torch.int32, device=device),
        cam_adjust=cam_adjust,
        cam_adam=cam_adam,
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


def _lane_norm(g: torch.Tensor) -> torch.Tensor:
    """Each row's Euclidean norm of an (N, 2) tensor, lane by lane:
    ``torch.linalg.norm`` reduces in vectors whose split follows N, so a
    Gaussian shard's norms would differ from the whole scene's in the last
    bit."""
    return torch.sqrt(g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1])


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
    camera_opt: Optional[CameraOptConfig] = None,
    micro_batch: int = 1,
    mesh: Optional[Mesh] = None,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The step function for a fixed (image size, active SH degree).

    With ``micro_batch`` = 1 it is ``(state, camera, gt_image,
    generator=None, mask=None, depth=None, mono_scale=None,
    mono_shift=None, camera_index=None) -> (state, metrics)``,
    ``gt_image`` (H, W, 3|4) in [0, 1], ``depth`` (H, W), ``mono_scale`` /
    ``mono_shift`` 0-d and ``camera_index`` a 0-d integer tensor on the
    state's device. With ``micro_batch`` > 1 the step takes
    ``cameras``, ``gt_images``, ``masks``, ``depths``, ``mono_scales``,
    ``mono_shifts`` and ``camera_indices`` with a leading micro-batch
    dimension.

    ``generator`` draws, for each camera in turn, the background when
    ``model_cfg.background_color`` is "random", then the patch origins of
    the Pearson and planar depth terms when they are on (gstk_tpu splits
    one key into a background key and a depth key instead). A
    :class:`DepthConfig` with a ``depth`` adds the depth-loss terms, gated
    on the state's step, and logs each under its name. ``frozen_groups``
    get zero gradients. With ``camera_opt`` (mode not "off") the state
    must carry the camera-opt group (``init_train_state(scene,
    num_cameras=N)``) and the step needs ``camera_index``. The state is
    updated in place and returned; metrics are 0-d tensors on the device
    (no host sync).

    ``axis_name`` names the data-parallel axis of ``mesh`` (by default the
    one-axis mesh over the whole process group, so it needs one); a
    ``mesh`` with a ``"gauss"`` axis takes a state sharded along it
    (``gaussian_sharding.shard_train_state``)."""
    if axis_name is not None and mesh is None:
        mesh = get_mesh()
    data_axis = mesh[axis_name] if axis_name is not None else None
    gauss_axis = (mesh[gaussian_sharding.GAUSS_AXIS]
                  if mesh is not None and gaussian_sharding.GAUSS_AXIS in mesh
                  else None)
    if not isinstance(model_cfg, VanillaConfig):
        raise TypeError(f"{type(model_cfg).__name__} is not a method config")
    if micro_batch < 1:
        raise ValueError(f"micro_batch must be >= 1, got {micro_batch}")
    use_cam_opt = camera_opt is not None and camera_opt.mode != "off"
    if use_cam_opt:
        cam_optim_cfg = OptimizerConfig(
            lrs=(("camera_opt", camera_opt.lr),),
            extra_exp=(
                ("camera_opt", camera_opt.lr_final, camera_opt.max_steps),
            ),
            eps=1e-15,
        )
    is_depth_model = isinstance(model_cfg, DepthConfig)
    max_img_size = max(img_height, img_width)
    # loss terms that read the scene (over every lane, gathered when sharded)
    reads_scene = ((model_cfg.use_scale_regularization and apply_scale_reg)
                   or getattr(model_cfg, "use_sparse_loss", False))

    def synchronize(grads, cam_grad, cam_rep, g_norm, visible, radii,
                    metrics):
        """The cross-rank reductions of one step: gradients and loss metrics
        averaged over the data axis, the screen-gradient norms and
        visibility counts summed, radii and intersection counts maxed; over
        the Gaussian axis the camera group's partial gradients summed, then
        ``cam_rep``, the gradient every rank holds whole, added. Returns
        them with ``num_alive`` (summed over the Gaussian axis)."""
        num_alive = metrics.pop("num_alive")
        if gauss_axis is not None:
            num_alive = gauss_axis.sum_(num_alive.clone())
            if cam_grad is not None:
                cam_grad = gauss_axis.sum_(cam_grad.clone()) + cam_rep
        if data_axis is not None:
            means = [k for k in metrics if k != "num_intersects"]
            names = list(grads)
            parts = ([g_norm] + [grads[k] for k in names]
                     + ([cam_grad] if cam_grad is not None else [])
                     + [metrics[k] for k in means])
            flat = torch.cat([x.reshape(-1).to(torch.float32) for x in parts])
            data_axis.sum_(flat)
            n = g_norm.numel()
            flat[n:].div_(data_axis.size)
            pieces = list(torch.split(flat, [x.numel() for x in parts]))
            g_norm = pieces.pop(0)
            grads = {k: pieces.pop(0).reshape(grads[k].shape) for k in names}
            if cam_grad is not None:
                cam_grad = pieces.pop(0).reshape(cam_grad.shape)
            metrics = {**metrics,
                       **{k: pieces.pop(0).reshape(()) for k in means}}
            visible = data_axis.sum_(visible.to(torch.int32))
            peak = data_axis.max_(torch.cat(
                [radii.to(torch.int32),
                 metrics["num_intersects"].reshape(1).to(torch.int32)]))
            radii = peak[:-1]
            metrics["num_intersects"] = peak[-1].to(
                metrics["num_intersects"].dtype)
        metrics["num_alive"] = num_alive
        return grads, cam_grad, g_norm, visible, radii, metrics

    def grads_once(state, camera, gt_image, generator, mask, depth,
                   mono_scale, mono_shift, camera_index):
        """Forward and backward for one camera."""
        scene = state.scene
        device = scene.means.device
        background = _background(generator, model_cfg.background_color, device)
        gt = composite_gt_with_background(gt_image, background)
        xys_offset = torch.zeros((scene.capacity, 2), device=device,
                                 requires_grad=True)
        params = scene.params()
        wrt = [*params.values(), xys_offset]
        cam = camera
        if use_cam_opt:
            if camera_index is None:
                raise ValueError("camera optimisation needs camera_index")
            cam_adj = state.cam_adjust.detach().requires_grad_()
            wrt.append(cam_adj)
            cam = apply_to_camera(
                camera,
                cam_adj.index_select(0, camera_index.reshape(1).long())[0],
                camera_opt.mode,
            )
        render_kw = dict(sh_degree=sh_degree, background=background,
                         config=model_cfg, raster_config=raster_cfg,
                         xys_offset=xys_offset)
        loss_scene = scene
        if gauss_axis is None:
            out = render_scene(scene, cam, img_height, img_width, **render_kw)
        else:
            out = gaussian_sharding.render_scene_gauss_sharded(
                scene, cam, img_height, img_width, mesh=gauss_axis, **render_kw)
            if reads_scene:
                loss_scene = gaussian_sharding.loss_scene(scene, gauss_axis)
        ld = rgb_loss(out["rgb"], gt, loss_scene, model_cfg, mask,
                      apply_scale_reg)
        depth_terms = {}
        if is_depth_model:
            depth_terms = depth_loss_terms(
                model_cfg, state.step, out["depth"], depth, gt, loss_scene,
                generator, mask=mask, mono_scale=mono_scale,
                mono_shift=mono_shift, camera=cam,
            )
            ld.update(depth_terms)
        loss = sum(ld.values())
        cam_rep = None
        if use_cam_opt:
            reg = pose_regularizer(cam_adj, camera_opt)
            ld["camera_opt_regularizer"] = reg
            if gauss_axis is None:
                loss = loss + reg
            else:
                # every rank holds the whole regulariser but only its lanes'
                # share of the projection's camera gradient: the regulariser's
                # gradient is kept apart and added after the shares are summed
                cam_rep = torch.autograd.grad(reg, cam_adj)[0]
        with f32_convolutions():  # SSIM's convolution backward, in f32 too
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        if cam_rep is not None:
            loss = loss + reg  # logged whole, as without the Gaussian axis
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(wrt, grads)]
        mse = torch.mean((out["rgb"].detach() - gt[..., :3]) ** 2)
        metrics = {
            "loss": loss.detach(),
            "main_loss": ld["main_loss"].detach(),
            "psnr": -10.0 * torch.log10(torch.clamp(mse, min=1e-10)),
            "num_intersects": out["num_intersects"],
            **{k: v.detach() for k, v in depth_terms.items()},
        }
        n = len(params)
        cam_grad = grads[n + 1] if use_cam_opt else None
        return (dict(zip(params, grads[:n])), grads[n], cam_grad, cam_rep,
                out["radii"], metrics)

    def apply(state, grads, cam_grad, refine):
        """Adam on the summed gradients (and on the camera group's), the
        new statistics, the step."""
        grads = {k: torch.zeros_like(v) if k in frozen_groups else v
                 for k, v in grads.items()}
        state.adam = adam_step(
            state.scene.params(), grads, state.adam, state.step, optim_cfg,
            update_mask=state.scene.alive,
        )
        if use_cam_opt:
            state.cam_adam = adam_step(
                {"camera_opt": state.cam_adjust}, {"camera_opt": cam_grad},
                state.cam_adam, state.step, cam_optim_cfg,
            )
        state.refine = refine
        state.step = state.step + 1
        return state

    def camera_metrics(state, metrics):
        """The reference's camera-opt metrics (camera_optimizers.py:139-148),
        of the updated adjustments."""
        if use_cam_opt:
            adj = state.cam_adjust
            metrics["camera_opt_translation"] = torch.mean(
                torch.linalg.norm(adj[:, :3], dim=-1))
            metrics["camera_opt_rotation"] = torch.mean(
                torch.linalg.norm(adj[:, 3:], dim=-1))
        return metrics

    def train_step(state: TrainState, camera: Camera, gt_image: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   mask: Optional[torch.Tensor] = None,
                   depth: Optional[torch.Tensor] = None,
                   mono_scale: Optional[torch.Tensor] = None,
                   mono_shift: Optional[torch.Tensor] = None,
                   camera_index=None):
        num_alive = state.scene.num_alive
        grads, g_xys, cam_grad, cam_rep, radii, metrics = grads_once(
            state, camera, gt_image, generator, mask, depth, mono_scale,
            mono_shift, camera_index,
        )
        metrics["num_alive"] = num_alive
        grads, cam_grad, g_norm, visible, radii, metrics = synchronize(
            grads, cam_grad, cam_rep, _lane_norm(g_xys), radii > 0,
            radii, metrics)
        refine = RefineState(
            xys_grad_norm=state.refine.xys_grad_norm + g_norm,
            vis_counts=state.refine.vis_counts + visible.to(torch.float32),
            max_2dsize=torch.maximum(
                state.refine.max_2dsize,
                radii.to(torch.float32) / max_img_size,
            ),
        )
        state = apply(state, grads, cam_grad, refine)
        return state, camera_metrics(state, metrics)

    if micro_batch == 1:
        return train_step

    def micro_train_step(state: TrainState, cameras: Camera,
                         gt_images: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         masks: Optional[torch.Tensor] = None,
                         depths: Optional[torch.Tensor] = None,
                         mono_scales: Optional[torch.Tensor] = None,
                         mono_shifts: Optional[torch.Tensor] = None,
                         camera_indices=None):
        num_alive = state.scene.num_alive
        capacity = state.scene.capacity
        zeros = lambda dtype: torch.zeros(capacity, dtype=dtype,
                                          device=state.scene.means.device)
        gsum, csum, rsum, ys = None, None, None, []
        gx_sum = zeros(torch.float32)
        vis_sum, rad_max = zeros(torch.int32), zeros(torch.int32)
        at = lambda xs, i: None if xs is None else xs[i]
        for i in range(micro_batch):
            grads, g_xys, cam_grad, cam_rep, radii, m = grads_once(
                state, _camera_at(cameras, i), gt_images[i], generator,
                at(masks, i), at(depths, i), at(mono_scales, i),
                at(mono_shifts, i), at(camera_indices, i),
            )
            gsum = grads if gsum is None else {k: gsum[k] + v
                                               for k, v in grads.items()}
            if use_cam_opt:
                csum = cam_grad if csum is None else csum + cam_grad
            if cam_rep is not None:
                rsum = cam_rep if rsum is None else rsum + cam_rep
            gx_sum = gx_sum + _lane_norm(g_xys)
            vis_sum = vis_sum + (radii > 0).to(torch.int32)
            rad_max = torch.maximum(rad_max, radii.to(torch.int32))
            ys.append(m)
        stacked = {k: torch.stack([m[k] for m in ys]) for k in ys[0]}
        metrics = {k: v.mean() for k, v in stacked.items()
                   if k != "num_intersects"}
        metrics["num_alive"] = num_alive
        metrics["num_intersects"] = stacked["num_intersects"].max()
        gsum, csum, gx_sum, vis_sum, rad_max, metrics = synchronize(
            gsum, csum, rsum, gx_sum, vis_sum, rad_max, metrics)
        refine = RefineState(
            xys_grad_norm=state.refine.xys_grad_norm + gx_sum,
            vis_counts=state.refine.vis_counts + vis_sum.to(torch.float32),
            max_2dsize=torch.maximum(state.refine.max_2dsize,
                                     rad_max.to(torch.float32) / max_img_size),
        )
        state = apply(state, gsum, csum, refine)
        return state, camera_metrics(state, metrics)

    return micro_train_step
