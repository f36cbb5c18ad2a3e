"""Trainer: the host-side loop around the train step (port of
``gstk_tpu/train/trainer.py``).

Responsibilities, as in gstk_tpu:

  * build the datamanager, the scene (kNN seed init) and the train state,
    or resume them from a checkpoint with its capacity and raster metadata;
  * per step: pick the coarse-to-fine resolution bucket and the SH degree,
    take the next train camera (image, mask, depth and mono-depth scale and
    shift) from the device-resident cache of the train split, and run the
    method's train step (the co-gs depth terms; surface-gs's frozen means;
    the camera-opt group with the camera's train index);
  * every ``refine_every`` steps run :func:`gstk_torch.train.strategy.refine`;
  * grow the Gaussian capacity, the intersection capacity and the raster
    bands between steps when the fetched counts cross gstk_tpu's thresholds;
  * eval cadence, checkpoints, writer logging, host-clock profiler.

Device values are fetched only every ``log_every`` steps (and at evals and
saves), so the loop adds no host sync to a step. Random numbers (random
backgrounds, split noise) come from one ``torch.Generator`` on the device,
seeded ``seed + 1``, in place of gstk_tpu's PRNG key.

Not ported yet, and refused at ``setup``: Gaussian sharding, multi-host
runs and data parallelism over more than one visible device (M15), the
viewer (M16).
gstk_tpu's persistent compile cache has no counterpart in eager PyTorch.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from gstk_torch import DeviceLike, resolve_device
from gstk_torch.core.camera_opt import CameraOptConfig
from gstk_torch.core.cameras import Camera
from gstk_torch.core.gaussians import grow_scene, init_scene
from gstk_torch.data.datamanager import CachedFrame, FullImageDatamanager
from gstk_torch.data.dataparser import DataparserConfig
from gstk_torch.models.surface import FROZEN_GROUPS
from gstk_torch.models.vanilla import (
    VanillaConfig,
    composite_gt_with_background,
    downscale_factor,
    render_scene,
)
from gstk_torch.ops.rasterize import RasterizeConfig
from gstk_torch.train import checkpoint as ckpt
from gstk_torch.train.optim import AdamState, OptimizerConfig
from gstk_torch.train.step import (
    TrainState,
    _camera_at,
    init_train_state,
    make_train_step,
)
from gstk_torch.train.strategy import RefineState, refine
from gstk_torch.utils import losses as loss_utils
from gstk_torch.utils.colors import EVAL_BACKGROUND
from gstk_torch.utils.lpips import lpips
from gstk_torch.utils.profiler import PROFILER, timer
from gstk_torch.utils.writer import (
    EventName,
    GLOBAL_WRITER,
    JsonlWriter,
    LocalWriter,
)

_EVAL_BACKGROUND = np.array(EVAL_BACKGROUND, np.float32)


def _eval_gt(image: np.ndarray) -> np.ndarray:
    """An eval frame's GT on the host: RGBA composited over the eval
    background (the side-by-side eval image)."""
    return composite_gt_with_background(image, _EVAL_BACKGROUND)


@dataclasses.dataclass
class TrainerConfig:
    """gstk_tpu's TrainerConfig, every field (the reference TrainerConfig
    and method defaults, configs/method_configs.py:87-140)."""

    data: Path = Path(".")
    output_dir: Path = Path("outputs")
    experiment_name: str = "experiment"
    method_name: str = "gaussian-splatting"
    max_num_iterations: int = 15_000
    steps_per_save: int = 2_000
    steps_per_eval_image: int = 100
    steps_per_eval_all_images: int = 1_000
    save_only_latest_checkpoint: bool = True
    seed: int = 42
    log_every: int = 10
    model: VanillaConfig = dataclasses.field(default_factory=VanillaConfig)
    optim: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    # learned camera-pose refinement (mode "off" | "SO3xR3" | "SE3")
    camera_opt: CameraOptConfig = dataclasses.field(
        default_factory=CameraOptConfig
    )
    dataparser: DataparserConfig = dataclasses.field(default_factory=DataparserConfig)
    raster_chunk: int = 32
    initial_capacity_headroom: float = 4.0
    capacity_growth: float = 1.5
    # hard ceiling on Gaussian capacity: once reached, densification
    # saturates (refine drops children that do not fit)
    max_capacity: int = 1 << 21
    isect_capacity: int = 1 << 20
    # device-resident training set: the train split is uploaded once per
    # coarse-to-fine bucket and indexed on the device per step; budget in
    # MiB per bucket, 0 disables
    device_data_cache_mb: int = 4096
    load_dir: Optional[Path] = None
    enable_tensorboard: bool = False
    vis: str = "none"  # none | viewer (M16)
    viewer_port: int = 7007
    # data parallelism over cameras: "auto" uses every visible device when
    # there is more than one (M15); "off" forces one device
    data_parallel: str = "auto"  # auto | off
    # Gaussian sharding over devices (M15)
    param_sharding: str = "off"  # off | auto
    # multi-host bootstrap (M15)
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    @property
    def run_dir(self) -> Path:
        return Path(self.output_dir) / self.experiment_name / self.method_name


def _round_up_pow2(x: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(x, 1)))), 0)


def _round_up_bucket(n: int) -> int:
    """Smallest m * 2^k >= n with m in {4..7} (3-bit mantissa), min 4096:
    intersection-capacity buckets, at most 4 per octave, each a multiple of
    1024."""
    n = max(int(n), 4096)
    q = 1 << max((n - 1).bit_length() - 3, 10)
    return -(-n // q) * q


def _quantize_cache_images(imgs_np: np.ndarray, device: DeviceLike = None
                           ) -> torch.Tensor:
    """The device GT cache as uint8 when that is LOSSLESS (4x less memory):
    images from 8-bit sources (n/255 in f32) round-trip exactly; any other
    float image stays f32."""
    device = resolve_device(device)
    if imgs_np.dtype == np.float32:
        q = np.rint(imgs_np * 255.0)
        if (
            q.min() >= 0 and q.max() <= 255
            and (q.astype(np.float32) / np.float32(255.0) == imgs_np).all()
        ):
            return torch.from_numpy(q.astype(np.uint8)).to(device)
    return torch.from_numpy(np.ascontiguousarray(imgs_np)).to(device)


def _dequantize_image(img: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_quantize_cache_images`` for one indexed frame. The
    divisor is a tensor on the image's device: on the card a tensor
    divided by a host scalar is multiplied by its reciprocal, which misses
    n / 255 by an ulp for about half the bytes, and the cache must give
    back exactly the image it was given."""
    if img.dtype == torch.uint8:
        return img.to(torch.float32).div_(
            torch.full((), 255.0, dtype=torch.float32, device=img.device))
    return img


def score_views(render: Callable[[CachedFrame], torch.Tensor], frames,
                background: torch.Tensor, lpips_params=None,
                return_preds: bool = False):
    """PSNR, SSIM and, with ``lpips_params``, LPIPS of each frame's render
    against its ground truth, computed on ``background``'s device, view by
    view: ``render(frame)`` gives the (H, W, 3) prediction there; each GT is
    uploaded as uint8 when that is lossless and RGBA is composited over
    ``background``. The stacked scalars are fetched once at the end and,
    with ``return_preds``, the (n, H, W, 3) predictions in one more
    transfer (equal shapes only). Returns numpy ``(psnrs, ssims, lpips or
    None, preds or None)``. The trainer's evals and gs-eval both score
    through this function."""
    device = background.device
    psnrs, ssims, lps, preds = [], [], [], []
    for frame in frames:
        pred = render(frame)
        gt = composite_gt_with_background(
            _dequantize_image(_quantize_cache_images(frame.image, device)),
            background)
        mse = torch.mean((pred - gt) ** 2)
        psnrs.append(-10.0 * torch.log10(torch.clamp(mse, min=1e-10)))
        ssims.append(loss_utils.ssim(gt, pred))
        if lpips_params is not None:
            lps.append(lpips(lpips_params, gt, pred))
        if return_preds:
            preds.append(pred)
    host = lambda xs: torch.stack(xs).cpu().numpy() if xs else None
    return host(psnrs), host(ssims), host(lps), host(preds)


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of OpenCV's INTER_AREA along one axis (its
    ``computeResizeAreaTab``): each output pixel averages the input pixels
    its cell covers, weighted by the covered length."""
    scale = 1.0 / (n_out / n_in)
    out = np.zeros((n_out, n_in), np.float64)
    for dx in range(n_out):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, n_in - fsx1)
        sx2 = min(int(np.floor(fsx2)), n_in - 1)
        sx1 = min(int(np.ceil(fsx1)), sx2)
        if sx1 - fsx1 > 1e-3:
            out[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
        out[dx, sx1:sx2] = np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            out[dx, sx2] = np.float32(min(fsx2 - sx2, 1.0, cell) / cell)
    return out


def area_downscale(images: torch.Tensor, d: int) -> torch.Tensor:
    """Coarse-to-fine downscale on the images' device: (..., H, W, C) float
    -> (..., H // d, W // d, C), OpenCV INTER_AREA's pixel-area average.
    Where d divides the size that is the d x d block mean."""
    h, w = images.shape[-3:-1]
    wy, wx = (
        torch.as_tensor(_area_weights(n, n // d), dtype=images.dtype,
                        device=images.device)
        for n in (h, w)
    )
    return torch.einsum("yh,...hwc,xw->...yxc", wy, images, wx)


def train_cache_bytes(n: int, shape, d: int, has_mask: bool,
                      has_depth: bool = False) -> int:
    """The device bytes the train cache of ``n`` frames of ``shape`` (H, W,
    C) reaches while it is built at downscale ``d``: the f32 bucket, the
    masks and the f32 depths it keeps and, for d > 1, one full-resolution
    f32 frame three times over (the upload and ``area_downscale``'s copy
    and intermediates, which are no larger)."""
    h, w, c = shape[0], shape[1], shape[2] if len(shape) > 2 else 1
    kept = n * (h // d) * (w // d) * (
        c * 4 + (1 if has_mask else 0) + (4 if has_depth else 0))
    if d == 1:
        return kept
    return kept + 3 * h * w * c * 4


def _cache_images(frames, d: int, device) -> torch.Tensor:
    """The cached GT of ``frames`` at downscale d on ``device``: the
    (losslessly quantized) stack at d = 1; at d > 1 the f32 bucket, filled
    one frame at a time as the per-frame path makes each (uploaded, then
    downscaled on the device), so the full-resolution stack is never
    there."""
    if d == 1:
        return _quantize_cache_images(np.stack([f.image for f in frames]),
                                      device)
    h, w, c = frames[0].image.shape
    out = torch.empty((len(frames), h // d, w // d, c), dtype=torch.float32,
                      device=device)
    for i, frame in enumerate(frames):
        out[i] = area_downscale(torch.from_numpy(frame.image).to(device), d)
    return out


def _subsample(m: np.ndarray, d: int, h: int, w: int) -> np.ndarray:
    """A mask or depth map at downscale d: every d-th pixel (no area
    average), cut to the (h, w) of the downscaled image."""
    return np.ascontiguousarray(m if d == 1 else m[::d, ::d][:h, :w])


def _stack_cameras(frames, d: int, device) -> Camera:
    """One Camera whose fields have a leading frame dimension."""
    f32 = lambda vals: torch.tensor(vals, dtype=torch.float32, device=device)
    return Camera(
        fx=f32([f.fx / d for f in frames]), fy=f32([f.fy / d for f in frames]),
        cx=f32([f.cx / d for f in frames]), cy=f32([f.cy / d for f in frames]),
        c2w=torch.from_numpy(np.stack([f.c2w for f in frames])).to(device),
    )


class Trainer:
    def __init__(self, config: TrainerConfig, device: DeviceLike = None):
        """``device`` defaults to ``cuda``; without a card and without a
        device this raises."""
        self.config = config
        self.device = resolve_device(device)
        # device-scalar intersection counts of every step since the last
        # metrics fetch: growth sees the window's peak, so a spike on a
        # step that is not logged still grows the buffer
        self._isect_window: list = []
        self._step_cache: Dict = {}
        self._dev_cache: Dict = {}

    # -- setup ------------------------------------------------------------
    def _check_supported(self) -> None:
        cfg = self.config
        if cfg.param_sharding != "off":
            raise NotImplementedError(
                "Gaussian sharding (param_sharding) is not ported yet (M15)"
            )
        if cfg.coordinator_address is not None:
            raise NotImplementedError(
                "multi-host training (coordinator_address) is not ported yet "
                "(M15)"
            )
        visible = torch.cuda.device_count() if self.device.type == "cuda" else 1
        if cfg.data_parallel == "auto" and visible > 1:
            raise NotImplementedError(
                f"data parallelism over {visible} visible devices is not "
                "ported yet (M15); pass --data-parallel off or show one device"
            )
        if cfg.vis != "none":
            raise NotImplementedError(f"vis={cfg.vis!r}: the viewer is M16")

    def setup(self) -> None:
        cfg = self.config
        self._check_supported()
        self.run_dir = cfg.run_dir
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.datamanager = FullImageDatamanager(cfg.dataparser, seed=cfg.seed)
        seed = self.datamanager.seed_points()
        n_seed = (
            seed[0].shape[0] if seed is not None else cfg.model.num_random
        )
        capacity = _round_up_pow2(int(n_seed * cfg.initial_capacity_headroom))
        scene = init_scene(
            torch.Generator().manual_seed(cfg.seed), capacity, seed,
            num_random=cfg.model.num_random,
            random_scale=cfg.model.random_scale,
            sh_degree=cfg.model.sh_degree, device=self.device,
        )
        # the camera-opt group: one adjustment a train view
        num_cams = (self.datamanager.num_train
                    if cfg.camera_opt.mode != "off" else None)
        self.state = init_train_state(scene, num_cameras=num_cams)
        # train indices on the device, for the camera-opt group: indexing
        # this keeps the step free of a host-to-device copy
        self._cam_indices = torch.arange(self.datamanager.num_train,
                                         dtype=torch.int32, device=self.device)
        self.raster_cfg = RasterizeConfig(
            chunk_size=cfg.raster_chunk, isect_capacity=cfg.isect_capacity
        )
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed + 1)
        self.writer = GLOBAL_WRITER
        self.writer.backends = [
            LocalWriter(cfg.max_num_iterations, cfg.log_every),
            JsonlWriter(self.run_dir / "metrics.jsonl"),
        ]
        if cfg.enable_tensorboard:
            from gstk_torch.utils.writer import TensorBoardWriter

            self.writer.backends.append(TensorBoardWriter(self.run_dir / "tb"))
        if cfg.load_dir is not None:
            path = ckpt.latest_checkpoint(cfg.load_dir)
            if path is not None:
                # parameters take the CHECKPOINT's capacity: densification
                # may have grown it past this fresh init
                ckpt_cap = ckpt.peek_capacity(path)
                if ckpt_cap is not None and ckpt_cap > self.state.scene.capacity:
                    self.state = init_train_state(
                        grow_scene(self.state.scene, ckpt_cap),
                        num_cameras=num_cams,
                    )
                self.state = ckpt.load_checkpoint(path, self.state)
                meta = ckpt.peek_meta(path)
                if "isect_capacity" in meta:
                    self.raster_cfg = dataclasses.replace(
                        self.raster_cfg,
                        isect_capacity=max(
                            int(meta["isect_capacity"]),
                            self.raster_cfg.isect_capacity,
                        ),
                        bands=max(
                            int(meta.get("bands", 1)), self.raster_cfg.bands
                        ),
                    )
                print(f"Resumed from {path} (raster: {self.raster_cfg})")

    # -- device-resident training set --------------------------------------
    def _device_train_cache(self, d: int):
        """(cameras, images, masks, depths, mono scales, mono shifts) of the
        whole train split at downscale d, on the device (None where the
        frames have none); None (the per-frame path) when frames have mixed
        shapes or the device bytes the build reaches
        (:func:`train_cache_bytes`) exceed ``config.device_data_cache_mb``.
        Only the current coarse-to-fine bucket is kept: ``downscale_factor``
        never increases with the step, so the earlier bucket is dropped
        before the new one is built."""
        if d in self._dev_cache:
            return self._dev_cache[d]
        budget = self.config.device_data_cache_mb
        frames = self.datamanager.train_frames
        shape0 = frames[0].image.shape if frames else None
        cache = None
        self._dev_cache = {}
        if (budget > 0 and frames
                and all(f.image.shape == shape0 for f in frames)
                and train_cache_bytes(len(frames), shape0, d,
                                      frames[0].mask is not None,
                                      frames[0].depth is not None)
                <= budget * (1 << 20)):
            h, w = shape0[0] // d, shape0[1] // d
            stack = lambda field: (
                torch.from_numpy(np.stack(
                    [_subsample(getattr(f, field), d, h, w) for f in frames]
                )).to(self.device)
                if getattr(frames[0], field) is not None else None
            )
            scalars = lambda field: (
                torch.tensor([getattr(f, field) for f in frames],
                             dtype=torch.float32, device=self.device)
                if getattr(frames[0], field) is not None else None
            )
            cache = (_stack_cameras(frames, d, self.device),
                     _cache_images(frames, d, self.device), stack("mask"),
                     stack("depth"), scalars("mono_scale"),
                     scalars("mono_shift"))
        self._dev_cache = {d: cache}
        return cache

    def _frame_to_device(self, frame: CachedFrame, d: int):
        """(camera, gt, mask, depth, mono scale, mono shift) of one frame at
        downscale d (no cache; None where the frame has none)."""
        img = torch.from_numpy(frame.image).to(self.device)
        if d > 1:
            img = area_downscale(img, d)
        h, w = img.shape[:2]
        camera = Camera.create(frame.fx / d, frame.fy / d, frame.cx / d,
                               frame.cy / d, frame.c2w, device=self.device)
        maps = [None if m is None else _subsample(m, d, h, w)
                for m in (frame.mask, frame.depth)]
        scalars = [None if v is None else np.float32(v)
                   for v in (frame.mono_scale, frame.mono_shift)]
        return (camera, img, *(
            None if x is None else torch.as_tensor(x, device=self.device)
            for x in maps + scalars))

    def _train_inputs(self, cam_idx: int, frame: CachedFrame, d: int):
        """The step's (camera, gt, mask, depth, mono scale, mono shift) of
        train view ``cam_idx``: indexed in the device cache, or uploaded."""
        cache = self._device_train_cache(d)
        if cache is None:
            return self._frame_to_device(frame, d)
        cams, imgs, *rest = cache
        return (_camera_at(cams, cam_idx), _dequantize_image(imgs[cam_idx]),
                *(None if x is None else x[cam_idx] for x in rest))

    def _camera_index(self, cam_idx: int) -> Optional[torch.Tensor]:
        """The step's ``camera_index`` (the train index, a 0-d tensor on the
        device), or None without camera optimisation."""
        if self.config.camera_opt.mode == "off":
            return None
        return self._cam_indices[cam_idx]

    # -- step-function cache (per resolution bucket / sh degree) ----------
    def _step_fn(self, h: int, w: int, sh_degree: int, scale_reg: bool):
        key = (h, w, sh_degree, scale_reg, self.raster_cfg)
        if key not in self._step_cache:
            frozen = (FROZEN_GROUPS
                      if getattr(self.config.model, "freeze_means", False)
                      else ())
            self._step_cache[key] = make_train_step(
                self.config.model, self.raster_cfg, self.config.optim,
                h, w, sh_degree, apply_scale_reg=scale_reg,
                frozen_groups=frozen, camera_opt=self.config.camera_opt,
            )
        return self._step_cache[key]

    def _sh_degree(self, step: int) -> int:
        model = self.config.model
        return min(step // model.sh_degree_interval, model.sh_degree)

    def _ckpt_meta(self) -> Dict:
        """Run metadata saved with checkpoints: the grown raster shape (a
        densified scene needs the grown intersection budget) and the active
        SH degree, which offline eval renders with."""
        return {
            "isect_capacity": self.raster_cfg.isect_capacity,
            "bands": self.raster_cfg.bands,
            "sh_degree": self._sh_degree(int(self.state.step)),
        }

    def _refine(self) -> None:
        """Refine the state at its step, in place."""
        s = self.state
        _, _, s.refine, _ = refine(
            s.scene, s.adam, s.refine, s.step, self.config.model,
            self.datamanager.num_train, max(self.datamanager.image_size),
            generator=self.generator,
        )

    # -- capacity management ----------------------------------------------
    def _drain_isect_window(self, metrics_host: Dict) -> Dict:
        """``metrics_host`` with ``num_intersects`` raised to the peak over
        every step since the last fetch; empties the window."""
        if not self._isect_window:
            return metrics_host
        peak = max(float(x) for x in self._isect_window)
        self._isect_window.clear()
        out = dict(metrics_host)
        out["num_intersects"] = max(peak, out.get("num_intersects", 0))
        return out

    def _grow_capacity(self, new_cap: int) -> None:
        state = self.state
        extra = new_cap - state.scene.capacity
        pad = lambda x: torch.cat([x, x.new_zeros((extra,) + x.shape[1:])])
        self.state = TrainState(
            scene=grow_scene(state.scene, new_cap),
            adam=AdamState(
                count=state.adam.count,
                mu={k: pad(v) for k, v in state.adam.mu.items()},
                nu={k: pad(v) for k, v in state.adam.nu.items()},
            ),
            refine=RefineState(*(pad(x) for x in state.refine)),
            step=state.step,
            cam_adjust=state.cam_adjust,
            cam_adam=state.cam_adam,
        )

    def _maybe_grow(self, metrics: Dict) -> None:
        """gstk_tpu's growth policy on fetched counts: Gaussian capacity x
        ``capacity_growth`` (rounded to a power of two, at most
        ``max_capacity``) past 0.85 of it; the intersection buffer to the
        next 3-bit-mantissa bucket with 1.2x headroom past 0.9 of it, up to
        2^21, then one more band; a band merged back when the per-band load
        would stay under 0.6 of the buffer."""
        cfg = self.config
        num_alive = int(metrics.get("num_alive", 0))
        cap = self.state.scene.capacity
        if num_alive > 0.85 * cap:
            new_cap = min(
                _round_up_pow2(int(cap * cfg.capacity_growth)),
                cfg.max_capacity,
            )
            if new_cap <= cap:
                if not getattr(self, "_cap_warned", False):
                    print(
                        f"Gaussian capacity at max ({cap}); densification "
                        "will saturate (children past capacity are dropped)"
                    )
                    self._cap_warned = True
            else:
                print(f"Growing Gaussian capacity {cap} -> {new_cap}")
                with timer("grow_capacity"):
                    self._grow_capacity(new_cap)
        n_isect = int(metrics.get("num_intersects", 0))
        if n_isect > 0.9 * self.raster_cfg.isect_capacity:
            max_cap = 1 << 21
            new_isect = min(_round_up_bucket(int(n_isect * 1.2) + 1), max_cap)
            if new_isect > self.raster_cfg.isect_capacity:
                print(
                    f"Growing intersection capacity "
                    f"{self.raster_cfg.isect_capacity} -> {new_isect}"
                )
                self.raster_cfg = dataclasses.replace(
                    self.raster_cfg, isect_capacity=new_isect
                )
            else:
                new_bands = max(self.raster_cfg.bands, 1) + 1
                print(
                    f"Intersections ({n_isect}) near the sort ceiling at "
                    f"capacity {self.raster_cfg.isect_capacity}; splitting "
                    f"into {new_bands} rasterization bands"
                )
                self.raster_cfg = dataclasses.replace(
                    self.raster_cfg, bands=new_bands
                )
        elif (
            self.raster_cfg.bands > 1
            and n_isect * self.raster_cfg.bands
            < 0.6 * self.raster_cfg.isect_capacity * (self.raster_cfg.bands - 1)
        ):
            # With B-1 bands the worst band sees roughly n * B / (B-1);
            # merging only under 0.6 of the buffer (against the 0.9 growth
            # trigger) keeps a post-reset spike from oscillating the count.
            new_bands = self.raster_cfg.bands - 1
            print(
                f"Intersections ({n_isect}/band) well under budget; "
                f"merging to {new_bands} rasterization band(s)"
            )
            self.raster_cfg = dataclasses.replace(
                self.raster_cfg, bands=new_bands
            )

    # -- main loop ---------------------------------------------------------
    def train(self) -> None:
        cfg = self.config
        h_full, w_full = self.datamanager.image_size
        start_step = int(self.state.step)
        t_start = time.time()
        t_window = time.perf_counter()
        last_log_step = start_step - 1
        for step in range(start_step, cfg.max_num_iterations):
            d = downscale_factor(cfg.model, step)
            h, w = h_full // d, w_full // d
            scale_reg = cfg.model.use_scale_regularization and step % 10 == 0
            step_fn = self._step_fn(h, w, self._sh_degree(step), scale_reg)
            cam_idx, frame = self.datamanager.next_train()
            inputs = self._train_inputs(cam_idx, frame, d)
            with timer("train_iteration"):
                self.state, metrics = step_fn(
                    self.state, *inputs[:2], self.generator, *inputs[2:],
                    camera_index=self._camera_index(cam_idx),
                )
            self._isect_window.append(metrics["num_intersects"])

            if (step + 1) % cfg.model.refine_every == 0:
                with timer("refinement"):
                    self._refine()

            if step % cfg.log_every == 0 or step == cfg.max_num_iterations - 1:
                # the window's amortized wall time per step: only this
                # fetch waits for the device
                metrics_host = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                dt = (now - t_window) / max(step - last_log_step, 1)
                t_window = now
                last_log_step = step
                self.writer.put_dict(metrics_host, step)
                self.writer.put_scalar(
                    EventName.TRAIN_RAYS_PER_SEC, h * w / max(dt, 1e-9), step
                )
                self.writer.put_scalar(EventName.ITER_TRAIN_TIME, dt, step)
                self.writer.write_out_storage()
                self._maybe_grow(self._drain_isect_window(metrics_host))

            if cfg.steps_per_save > 0 and (step + 1) % cfg.steps_per_save == 0:
                with timer("save_checkpoint"):
                    ckpt.save_checkpoint(
                        self.run_dir / "ckpts", self.state,
                        cfg.save_only_latest_checkpoint,
                        extras=self._ckpt_meta(),
                    )
            if (
                cfg.steps_per_eval_image > 0
                and (step + 1) % cfg.steps_per_eval_image == 0
            ):
                self.eval_image(step)
            if (
                cfg.steps_per_eval_all_images > 0
                and (step + 1) % cfg.steps_per_eval_all_images == 0
            ):
                self.eval_all(step)

        ckpt.save_checkpoint(
            self.run_dir / "ckpts", self.state,
            cfg.save_only_latest_checkpoint, extras=self._ckpt_meta(),
        )
        total = time.time() - t_start
        print(f"Training done in {total / 60:.1f} min. {PROFILER.report()}")

    # -- eval ---------------------------------------------------------------
    def _eval_setting(self) -> Tuple[int, torch.Tensor]:
        """Eval renders at the scheduled SH degree, as the reference's model
        reads its step in eval too, on the fixed eval background."""
        return (self._sh_degree(int(self.state.step)),
                torch.from_numpy(_EVAL_BACKGROUND).to(self.device))

    def _render_eval(self, frame: CachedFrame, setting=None
                     ) -> Dict[str, torch.Tensor]:
        """An eval render of ``frame`` at ``setting`` (``_eval_setting()``
        when None); the binning skips the permutation only the backward
        needs."""
        sh_degree, background = setting or self._eval_setting()
        h, w = frame.image.shape[:2]
        camera = Camera.create(frame.fx, frame.fy, frame.cx, frame.cy,
                               frame.c2w, device=self.device)
        with torch.no_grad():
            return render_scene(
                self.state.scene, camera, h, w, sh_degree=sh_degree,
                background=background, config=self.config.model,
                raster_config=dataclasses.replace(self.raster_cfg,
                                                  forward_only=True),
            )

    def eval_image(self, step: int) -> Dict[str, float]:
        """Render ONE eval view, cycling through the split, and log its
        PSNR / SSIM and test rays/s: a cheap signal between full evals."""
        frames = self.datamanager.eval_frames
        if not frames:
            return {}
        cadence = max(self.config.steps_per_eval_image, 1)
        i = ((step + 1) // cadence) % len(frames)
        frame = frames[i]
        t0 = time.perf_counter()
        (psnr,), (ssim,) = self._score_views([frame])
        dt = time.perf_counter() - t0
        h, w = frame.image.shape[:2]
        results = {"eval_image_psnr": float(psnr),
                   "eval_image_ssim": float(ssim), "eval_image_idx": float(i)}
        self.writer.put_dict(results, step)
        self.writer.put_scalar(
            EventName.TEST_RAYS_PER_SEC, h * w / max(dt, 1e-9), step
        )
        self.writer.write_out_storage()
        return results

    def eval_all(self, step: int) -> Dict[str, float]:
        frames = self.datamanager.eval_frames
        if not frames:
            return {}
        t0 = time.perf_counter()
        psnrs, ssims = self._score_views(frames)
        # side-by-side GT | prediction
        pred0 = self._render_eval(frames[0])["rgb"].cpu().numpy()
        self.writer.put_image(
            "eval/img", np.concatenate([_eval_gt(frames[0].image), pred0],
                                       axis=1), step
        )
        dt = time.perf_counter() - t0
        h, w = frames[0].image.shape[:2]
        results = {
            "eval_psnr": float(np.mean(psnrs)),
            "eval_ssim": float(np.mean(ssims)),
            "fps": len(frames) / dt,
            "num_rays_per_sec": len(frames) * h * w / dt,
        }
        self.writer.put_dict(results, step)
        self.writer.write_out_storage()
        return results

    def _score_views(self, frames) -> Tuple[np.ndarray, np.ndarray]:
        """PSNR and SSIM of each view (:func:`score_views`)."""
        setting = self._eval_setting()
        psnrs, ssims, _, _ = score_views(
            lambda frame: self._render_eval(frame, setting)["rgb"], frames,
            setting[1])
        return psnrs, ssims
