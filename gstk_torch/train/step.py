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

One body runs every step; ``micro_batch`` > 1 hands it that many cameras,
whose gradients and statistics it sums before Adam steps once on the sum.

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
from gstk_torch.utils.profiler import timer


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
            with timer("camera"):
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
        with timer("loss"):
            ld = rgb_loss(out["rgb"], gt, loss_scene, model_cfg, mask,
                          apply_scale_reg)
            depth_terms = {}
            if is_depth_model:
                with timer("depth_terms"):
                    depth_terms = depth_loss_terms(
                        model_cfg, state.step, out["depth"], depth, gt,
                        loss_scene, generator, mask=mask,
                        mono_scale=mono_scale, mono_shift=mono_shift,
                        camera=cam,
                    )
                ld.update(depth_terms)
            loss = sum(ld.values())
            if use_cam_opt:
                with timer("camera"):
                    reg = pose_regularizer(cam_adj, camera_opt)
                ld["camera_opt_regularizer"] = reg
                if gauss_axis is None:
                    loss = loss + reg
        cam_rep = None
        with timer("backward"):
            if use_cam_opt and gauss_axis is not None:
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
            update_mask=state.scene.alive, backend=raster_cfg.backend,
        )
        if use_cam_opt:
            with timer("camera"):
                state.cam_adam = adam_step(
                    {"camera_opt": state.cam_adjust}, {"camera_opt": cam_grad},
                    state.cam_adam, state.step, cam_optim_cfg,
                    backend=raster_cfg.backend,
                )
        state.refine = refine
        state.step = state.step + 1
        return state

    def camera_metrics(state, metrics):
        """The reference's camera-opt metrics (camera_optimizers.py:139-148),
        of the updated adjustments."""
        if use_cam_opt:
            with timer("camera"):
                adj = state.cam_adjust
                metrics["camera_opt_translation"] = torch.mean(
                    torch.linalg.norm(adj[:, :3], dim=-1))
                metrics["camera_opt_rotation"] = torch.mean(
                    torch.linalg.norm(adj[:, 3:], dim=-1))
        return metrics

    def step(state, views):
        """The step over ``views``, each camera's arguments of grads_once:
        later cameras add to the first's gradients and statistics (radii and
        intersection counts maxed, metrics averaged), then one update."""
        with timer("step"):
            num_alive = state.scene.num_alive
            g_xys, radii = [], []
            for i, view in enumerate(views):
                grads, g_x, cam_g, rep, r, m = grads_once(state, *view)
                g_xys.append(g_x)
                radii.append(r)
                if i == 0:
                    gsum, csum, rsum, metrics = grads, cam_g, rep, m
                    continue
                gsum = {k: gsum[k] + v for k, v in grads.items()}
                if csum is not None:
                    csum = csum + cam_g
                if rsum is not None:
                    rsum = rsum + rep
                metrics = {k: torch.maximum(v, m[k]) if k == "num_intersects"
                           else v + m[k] for k, v in metrics.items()}
            if len(g_xys) > 1:
                metrics = {k: v if k == "num_intersects" else v / len(g_xys)
                           for k, v in metrics.items()}
            metrics["num_alive"] = num_alive
            with timer("update"):
                g_norm, visible, peak = (_lane_norm(g_xys[0]), radii[0] > 0,
                                         radii[0])
                for g_x, r in zip(g_xys[1:], radii[1:]):
                    g_norm = g_norm + _lane_norm(g_x)
                    visible = visible.to(torch.int32) + (r > 0)
                    peak = torch.maximum(peak, r)
                gsum, csum, g_norm, visible, peak, metrics = synchronize(
                    gsum, csum, rsum, g_norm, visible, peak, metrics)
                refine = RefineState(
                    xys_grad_norm=state.refine.xys_grad_norm + g_norm,
                    vis_counts=state.refine.vis_counts
                    + visible.to(torch.float32),
                    max_2dsize=torch.maximum(
                        state.refine.max_2dsize,
                        peak.to(torch.float32) / max_img_size,
                    ),
                )
                state = apply(state, gsum, csum, refine)
                metrics = camera_metrics(state, metrics)
            return state, metrics

    def train_step(state: TrainState, camera: Camera, gt_image: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   mask: Optional[torch.Tensor] = None,
                   depth: Optional[torch.Tensor] = None,
                   mono_scale: Optional[torch.Tensor] = None,
                   mono_shift: Optional[torch.Tensor] = None,
                   camera_index=None):
        return step(state, [(camera, gt_image, generator, mask, depth,
                             mono_scale, mono_shift, camera_index)])

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
        at = lambda xs, i: None if xs is None else xs[i]
        return step(state, (
            (_camera_at(cameras, i), gt_images[i], generator, at(masks, i),
             at(depths, i), at(mono_scales, i), at(mono_shifts, i),
             at(camera_indices, i))
            for i in range(micro_batch)))

    return micro_train_step
