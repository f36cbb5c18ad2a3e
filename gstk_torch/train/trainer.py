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
  * eval cadence, checkpoints, writer logging, layer spans;
  * with ``vis="viewer"``, a live viewer (:func:`make_viewer`) started at
    setup and given a snapshot of the scene at every log step.

Device values are fetched only every ``log_every`` steps (and at evals and
saves), so the loop adds no host sync to a step. Random numbers (random
backgrounds, split noise) come from one ``torch.Generator`` on the device,
seeded ``seed + 1``, in place of gstk_tpu's PRNG key.

Multi-device training runs one process per device
(:mod:`gstk_torch.parallel`): ``coordinator_address`` / ``num_processes`` /
``process_id`` (or ``torchrun``'s environment) start the process group at
``setup``. With more than one rank, ``param_sharding="auto"`` shards the
state over the ranks (each renders every step's camera through the
gathered projection; refinement, growth, checkpoints and the viewer's
snapshot keep it sharded: no rank holds the whole state), else
``data_parallel="auto"`` gives each rank its share of the train views
(``num_shards`` = world size) and averages the gradients. Under
data parallelism each rank draws its step's random numbers from its own
generator, seeded from (seed, rank), where gstk_tpu splits one key; the
refinement noise comes from the shared generator, so every rank holds the
same state. Rank 0 alone writes checkpoints, metrics and evals. gstk_tpu's
persistent compile cache has no counterpart in eager PyTorch.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

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
from gstk_torch.parallel import gaussian_sharding as gsharding
from gstk_torch.parallel import mesh as pmesh
from gstk_torch.train import checkpoint as ckpt
from gstk_torch.train.optim import OptimizerConfig
from gstk_torch.train.step import (
    _camera_at,
    init_train_state,
    make_train_step,
)
from gstk_torch.train.strategy import refine
from gstk_torch.utils import losses as loss_utils
from gstk_torch.utils.colors import EVAL_BACKGROUND
from gstk_torch.utils.lpips import lpips
from gstk_torch.utils.math import area_weights
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
    vis: str = "none"  # none | viewer
    viewer_port: int = 7007
    # data parallelism over cameras: "auto" trains on every rank of the
    # process group when it has more than one
    data_parallel: str = "auto"  # auto | off
    # Gaussian sharding over the ranks ("auto"; before data parallelism)
    param_sharding: str = "off"  # off | auto
    # the process group's rendezvous: one process per device
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
    through this function; its means (:func:`loss_utils.ordered_mean`) do
    not depend on the CPU's thread count."""
    device = background.device
    psnrs, ssims, lps, preds = [], [], [], []
    for frame in frames:
        pred = render(frame)
        gt = composite_gt_with_background(
            _dequantize_image(_quantize_cache_images(frame.image, device)),
            background)
        mse = loss_utils.ordered_mean((pred - gt) ** 2)
        psnrs.append(-10.0 * torch.log10(torch.clamp(mse, min=1e-10)))
        ssims.append(loss_utils.ssim(gt, pred, mean=loss_utils.ordered_mean))
        if lpips_params is not None:
            lps.append(lpips(lpips_params, gt, pred))
        if return_preds:
            preds.append(pred)
    host = lambda xs: torch.stack(xs).cpu().numpy() if xs else None
    return host(psnrs), host(ssims), host(lps), host(preds)


def area_downscale(images: torch.Tensor, d: int) -> torch.Tensor:
    """Coarse-to-fine downscale on the images' device: (..., H, W, C) float
    -> (..., H // d, W // d, C), OpenCV INTER_AREA's pixel-area average.
    Where d divides the size that is the d x d block mean."""
    h, w = images.shape[-3:-1]
    wy, wx = (
        torch.as_tensor(area_weights(n, n // d), dtype=images.dtype,
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
        # (step, message) of each capacity growth, band split and merge
        self.growth_events: list = []
        # device peak MiB up to the end of each Gaussian capacity (on the card)
        self.peak_by_lanes: Dict[int, float] = {}
        self._step_cache: Dict = {}
        self._dev_cache: Dict = {}
        # one process, one rank, until setup joins a process group
        self.world, self.rank = 1, 0
        self.mesh = self.gauss_mesh = None

    # -- setup ------------------------------------------------------------
    def _check_supported(self) -> None:
        cfg = self.config
        if cfg.vis not in ("none", "viewer"):
            raise ValueError(f"vis={cfg.vis!r}: none or viewer")
        for name in ("data_parallel", "param_sharding"):
            if getattr(cfg, name) not in ("auto", "off"):
                raise ValueError(f"{name}={getattr(cfg, name)!r}: auto or off")
        visible = torch.cuda.device_count() if self.device.type == "cuda" else 1
        if (visible > 1 and self.device.index is None
                and not pmesh.group_configured(cfg.coordinator_address)
                and "auto" in (cfg.data_parallel, cfg.param_sharding)):
            raise RuntimeError(
                f"{visible} CUDA devices are visible and there is no process "
                "group: gstk_torch drives one device a process. Start one "
                f"process per device (torchrun --nproc-per-node {visible} -m "
                "gstk_torch.scripts.train ..., or --coordinator-address "
                "--num-processes --process-id on each), or train on one "
                "(--data-parallel off, or CUDA_VISIBLE_DEVICES)"
            )

    def _start_group(self) -> None:
        """Join the process group (when configured) and lay out the mesh:
        Gaussian sharding or data parallelism over more than one rank."""
        cfg = self.config
        pmesh.initialize_distributed(cfg.coordinator_address,
                                     cfg.num_processes, cfg.process_id,
                                     device=self.device)
        grouped = dist.is_initialized()
        self.world = dist.get_world_size() if grouped else 1
        self.rank = dist.get_rank() if grouped else 0
        self.mesh = self.gauss_mesh = None
        if grouped and self.device.type == "cuda":
            self.device = pmesh.local_device(self.device)
        if self.world > 1:
            if cfg.param_sharding == "auto":
                self.gauss_mesh = gsharding.make_gauss_mesh()
                print(f"Gaussian-sharded training over {self.world} ranks")
            elif cfg.data_parallel == "auto":
                self.mesh = pmesh.get_mesh()
                print(f"Data-parallel training over {self.world} ranks")
            else:
                raise ValueError(
                    f"{self.world} ranks with data_parallel and param_sharding "
                    "both off: each rank would train alone"
                )

    def setup(self) -> None:
        cfg = self.config
        self._check_supported()
        self._start_group()
        self.run_dir = cfg.run_dir
        self.run_dir.mkdir(parents=True, exist_ok=True)
        dp = self.mesh is not None
        self.datamanager = FullImageDatamanager(
            cfg.dataparser, seed=cfg.seed,
            num_shards=self.world if dp else 1,
            shard_index=self.rank if dp else 0,
        )
        seed = self.datamanager.seed_points()
        n_seed = (
            seed[0].shape[0] if seed is not None else cfg.model.num_random
        )
        capacity = _round_up_pow2(int(n_seed * cfg.initial_capacity_headroom))
        # under Gaussian sharding the whole state is made (or loaded) on the
        # host, and only this rank's lanes go to the device
        home = self.device if self.gauss_mesh is None else torch.device("cpu")
        scene = init_scene(
            torch.Generator().manual_seed(cfg.seed), capacity, seed,
            num_random=cfg.model.num_random,
            random_scale=cfg.model.random_scale,
            sh_degree=cfg.model.sh_degree, device=home,
        )
        # the camera-opt group: one adjustment a train view (of every rank)
        num_cams = (self.datamanager.num_train_global
                    if cfg.camera_opt.mode != "off" else None)
        self.state = init_train_state(scene, num_cameras=num_cams)
        # global train indices on the device, for the camera-opt group:
        # indexing this keeps the step free of a host-to-device copy
        self._cam_indices = torch.arange(
            self.datamanager.num_train_global, dtype=torch.int32,
            device=self.device,
        )[self.datamanager.shard_index::self.datamanager.num_shards]
        self.raster_cfg = RasterizeConfig(
            chunk_size=cfg.raster_chunk, isect_capacity=cfg.isect_capacity
        )
        # the shared generator: refinement (every rank alike) and, unless
        # ranks train on their own cameras, the steps
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed + 1)
        self.step_generator = self.generator
        if dp:
            self.step_generator = torch.Generator(device=self.device)
            self.step_generator.manual_seed(int(np.random.SeedSequence(
                (cfg.seed, self.rank)).generate_state(1)[0]))
        self.writer = GLOBAL_WRITER
        self.writer.backends = [] if self.rank else [
            LocalWriter(cfg.max_num_iterations, cfg.log_every),
            JsonlWriter(self.run_dir / "metrics.jsonl"),
        ]
        if cfg.enable_tensorboard and not self.rank:
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
        if self.gauss_mesh is not None:
            self.state = ckpt.train_state_from_numpy(ckpt.train_state_to_numpy(
                gsharding.shard_train_state(self.state, self.gauss_mesh)),
                self.device)
        self.viewer = None
        if cfg.vis == "viewer" and not self.rank:
            from gstk_torch.viewer.viser_viewer import make_viewer

            # renders as the evals do; the caller stops it (viewer.stop())
            self.viewer = make_viewer(
                cfg.model,
                dataclasses.replace(self.raster_cfg, forward_only=True),
                port=cfg.viewer_port, device=self.device,
                run_info={
                    "config_path": str(self.run_dir / "config.yml"),
                    "export_dir": str(self.run_dir / "exports"),
                },
            ).start()

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
                axis_name=pmesh.DATA_AXIS if self.mesh is not None else None,
                mesh=self.mesh or self.gauss_mesh,
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

    def _capacity(self) -> int:
        """The scene's capacity over every rank."""
        return self.state.scene.capacity * (
            self.world if self.gauss_mesh is not None else 1)

    def _refine(self) -> None:
        """Refine the state at its step, in place (each rank its own lanes
        under Gaussian sharding)."""
        s = self.state
        with timer("refine"):
            _, _, s.refine, _ = refine(
                s.scene, s.adam, s.refine, s.step, self.config.model,
                self.datamanager.num_train_global,
                max(self.datamanager.image_size), generator=self.generator,
                mesh=self.gauss_mesh,
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
        self.state = gsharding.grow_train_state(self.state, new_cap,
                                                self.gauss_mesh)

    def _grown(self, step: Optional[int], message: str) -> None:
        """Print a growth ``message``, with the step it follows when known,
        and keep it in ``growth_events`` as (step, message)."""
        self.growth_events.append((step, message))
        print(message if step is None else f"step {step}: {message}")

    def _maybe_grow(self, metrics: Dict, step: Optional[int] = None) -> None:
        """gstk_tpu's growth policy on fetched counts: Gaussian capacity x
        ``capacity_growth`` (rounded to a power of two, at most
        ``max_capacity``) past 0.85 of it; the intersection buffer to the
        next 3-bit-mantissa bucket with 1.2x headroom past 0.9 of it, up to
        2^21, then one more band; a band merged back when the per-band load
        would stay under 0.6 of the buffer. ``step``: the step whose
        metrics these are, for the messages."""
        cfg = self.config
        num_alive = int(metrics.get("num_alive", 0))
        cap = self._capacity()
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
                self._grown(step, f"Growing Gaussian capacity {cap} -> {new_cap}")
                self._note_peak(cap)
                with timer("grow_capacity"):
                    self._grow_capacity(new_cap)
        n_isect = int(metrics.get("num_intersects", 0))
        if n_isect > 0.9 * self.raster_cfg.isect_capacity:
            max_cap = 1 << 21
            new_isect = min(_round_up_bucket(int(n_isect * 1.2) + 1), max_cap)
            if new_isect > self.raster_cfg.isect_capacity:
                self._grown(
                    step, f"Growing intersection capacity "
                    f"{self.raster_cfg.isect_capacity} -> {new_isect}"
                )
                self.raster_cfg = dataclasses.replace(
                    self.raster_cfg, isect_capacity=new_isect
                )
            else:
                new_bands = max(self.raster_cfg.bands, 1) + 1
                self._grown(
                    step, f"Intersections ({n_isect}) near the sort ceiling "
                    f"at capacity {self.raster_cfg.isect_capacity}; "
                    f"splitting into {new_bands} rasterization bands"
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
            self._grown(
                step, f"Intersections ({n_isect}/band) well under budget; "
                f"merging to {new_bands} rasterization band(s)"
            )
            self.raster_cfg = dataclasses.replace(
                self.raster_cfg, bands=new_bands
            )

    def _note_peak(self, lanes: int) -> None:
        """Keep the device peak so far as the peak at ``lanes``, the
        capacity that trained until now. The counter is the process's and
        is never reset here; capacity only grows, so the value at each
        capacity is the peak of training up to the end of it."""
        if self.device.type != "cuda":
            return
        peak = torch.cuda.max_memory_allocated(self.device) / 2**20
        self.peak_by_lanes[lanes] = max(peak, self.peak_by_lanes.get(lanes, 0))

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
            self.state, metrics = step_fn(
                self.state, *inputs[:2], self.step_generator, *inputs[2:],
                camera_index=self._camera_index(cam_idx),
            )
            self._isect_window.append(metrics["num_intersects"])

            if (step + 1) % cfg.model.refine_every == 0:
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
                self._maybe_grow(self._drain_isect_window(metrics_host), step)
                scene = self.state.scene
                if cfg.vis == "viewer" and self.gauss_mesh is not None:
                    scene = gsharding.scene_to_rank0(scene, self.gauss_mesh)
                if self.viewer is not None:
                    self.viewer.update_scene(scene, metrics_host)

            if cfg.steps_per_save > 0 and (step + 1) % cfg.steps_per_save == 0:
                with timer("save_checkpoint"):
                    self._save_checkpoint()
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

        self._save_checkpoint()
        total = time.time() - t_start
        peak = ""
        if self.device.type == "cuda":
            self._note_peak(self._capacity())
            peak = (f" Device peak {max(self.peak_by_lanes.values()):.1f} MiB"
                    " (by lanes: " + ", ".join(
                        f"{k}: {v:.1f}" for k, v in
                        sorted(self.peak_by_lanes.items())) + ").")
        print(f"Training done in {total / 60:.1f} min.{peak} Growth events: "
              f"{len(self.growth_events)}. {PROFILER.report()}")

    def _save_checkpoint(self) -> None:
        """Rank 0 writes the whole state (under Gaussian sharding every rank
        sends its lanes to rank 0's host)."""
        if self.rank and self.gauss_mesh is None:
            return
        ckpt.save_checkpoint(
            self.run_dir / "ckpts", self.state,
            self.config.save_only_latest_checkpoint,
            extras=self._ckpt_meta(), mesh=self.gauss_mesh,
        )

    def _evals_here(self) -> bool:
        """Evals render on rank 0, and on every rank under Gaussian sharding
        (the render gathers over the ranks); rank 0 alone logs them."""
        return not self.rank or self.gauss_mesh is not None

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
        kw = dict(sh_degree=sh_degree, background=background,
                  config=self.config.model,
                  raster_config=dataclasses.replace(self.raster_cfg,
                                                    forward_only=True))
        with torch.no_grad():
            if self.gauss_mesh is not None:
                return gsharding.render_scene_gauss_sharded(
                    self.state.scene, camera, h, w, mesh=self.gauss_mesh, **kw)
            return render_scene(self.state.scene, camera, h, w, **kw)

    def eval_image(self, step: int) -> Dict[str, float]:
        """Render ONE eval view, cycling through the split, and log its
        PSNR / SSIM and test rays/s: a cheap signal between full evals."""
        frames = self.datamanager.eval_frames
        if not frames or not self._evals_here():
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
        if not frames or not self._evals_here():
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
