"""Offline renderer: checkpoint -> (pose in, rgb/depth out) (port of
``gstk_tpu/render/renderer.py``).

Loads a trained scene from a gstk_tpu-layout checkpoint and renders
arbitrary camera poses with :func:`gstk_torch.models.vanilla.render_scene`
under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from gstk_torch import DeviceLike, resolve_device
from gstk_torch.core.cameras import Camera
from gstk_torch.models.vanilla import VanillaConfig, render_scene
from gstk_torch.ops.rasterize import RasterizeConfig
from gstk_torch.train.checkpoint import latest_checkpoint, load_scene, peek_meta
from gstk_torch.utils.profiler import timer


class Renderer:
    def __init__(
        self,
        checkpoint: Union[str, Path],
        model_config: VanillaConfig = VanillaConfig(),
        raster_config: Optional[RasterizeConfig] = None,
        background=(0.0, 0.0, 0.0),
        precision: str = "exact",
        device: DeviceLike = None,
    ):
        """``checkpoint`` is a checkpoint file, or a directory holding one
        directly or under ``ckpts/`` (the latest step is taken).

        ``precision`` is gstk_tpu's TPU-only render precision; it is
        accepted and ignored: the port always composites in exact f32.
        ``device`` defaults to ``cuda`` and the constructor raises when CUDA
        is absent and no device was given."""
        self.device = resolve_device(device)
        path = Path(checkpoint)
        if path.is_dir():
            found = latest_checkpoint(path)
            if found is None:
                found = latest_checkpoint(path / "ckpts")
            if found is None:
                raise FileNotFoundError(f"no checkpoint under {path}")
            path = found
        self.scene, self.step = load_scene(path, self.device)
        self.model_config = model_config
        # The trainer saves the grown rasterizer shape (isect_capacity,
        # bands) and the active SH degree with every checkpoint: a densified
        # scene needs the grown intersection budget, and rendering with
        # cfg.sh_degree instead of the active degree would only match while
        # the inactive rest coefficients are still zero.
        meta = peek_meta(path)
        self._meta_bands = int(meta.get("bands", 0))
        self._meta_isect = int(meta.get("isect_capacity", 0))
        self.sh_degree = int(meta.get("sh_degree", model_config.sh_degree))
        if raster_config is None:
            # full per-band budget, floored at the checkpoint's grown
            # capacity; bands=0 resolves per render size in _raster_for
            raster_config = RasterizeConfig(
                isect_capacity=max(1 << 20, self._meta_isect), bands=0,
                forward_only=True,
            )
        self.raster_config = raster_config
        self.background = torch.as_tensor(
            background, dtype=torch.float32, device=self.device
        )

    def _raster_for(self, h: int, w: int) -> RasterizeConfig:
        """The per-size config: auto bands from the pixel count, floored at
        the band count the checkpoint trained with. Explicit bands >= 1
        opt out of the floor."""
        rc = self.raster_config
        bands = rc.bands
        if bands == 0:
            bands = max(1, -(-h * w // 640_000), self._meta_bands)
        if bands != rc.bands:
            rc = dataclasses.replace(rc, bands=bands)
        return rc

    def render(
        self, c2w: np.ndarray, fx: float, fy: float, cx: float, cy: float,
        height: int, width: int, crop_box=None,
    ) -> Dict[str, torch.Tensor]:
        """Render one pose ((3,4) or (4,4) OpenGL c2w) and keep the result
        on the device: :func:`render_scene`'s outputs."""
        camera = Camera.create(
            fx, fy, cx, cy, np.asarray(c2w, np.float32), device=self.device
        )
        with torch.no_grad():
            return render_scene(
                self.scene, camera, height, width,
                sh_degree=self.sh_degree, background=self.background,
                config=self.model_config,
                raster_config=self._raster_for(height, width),
                crop_box=crop_box,
            )

    def get_output_from_pose(
        self, c2w: np.ndarray, fx: float, fy: float, cx: float, cy: float,
        height: int, width: int, crop_box=None,
    ) -> Dict[str, np.ndarray]:
        """Render one pose ((3,4) or (4,4) OpenGL c2w). Returns numpy rgb
        (H,W,3), depth (H,W), accumulation (H,W), and the true intersection
        count ``num_intersects`` (above the capacity means truncation).
        ``crop_box`` is an optional ``SceneBox`` / ``OrientedBox`` filtering
        the Gaussians."""
        out = self.render(c2w, fx, fy, cx, cy, height, width, crop_box)
        with timer("copy_out"):
            return {
                "rgb": out["rgb"].cpu().numpy(),
                "depth": out["depth"].cpu().numpy(),
                "accumulation": out["alpha"].cpu().numpy(),
                "num_intersects": int(out["num_intersects"]),
            }
