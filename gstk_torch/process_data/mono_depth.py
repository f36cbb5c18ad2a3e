"""Monocular depth estimation hook, model-gated (port of
``gstk_tpu/process_data/mono_depth.py``).

The reference's DepthAnything integration with a pluggable backend, as in
gstk_tpu:

  * ``register_depth_model(name, fn)`` — plug in any images -> depths
    callable (a torch model on the card, say);
  * ``estimate_depths(...)`` — runs the selected backend over a directory
    and writes the 16-bit PNG depth estimates the alignment stage reads;
  * a ``gradient`` placeholder keeps the pipeline runnable end to end for
    tests (NOT a real depth estimator).

Images are read by :func:`gstk_torch.utils.io.load_image` (PNG without
Pillow) and the estimates written by :func:`write_png`, where gstk_tpu uses
Pillow for both; the decoded arrays are the same. ``transformers`` is
imported only by :func:`try_load_local_dpt`.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np

from gstk_torch import DeviceLike, resolve_device
from gstk_torch.utils.io import load_image, write_png

_DEPTH_MODELS: Dict[str, Callable] = {}


def register_depth_model(name: str, fn: Callable) -> None:
    """fn(list of HxWx3 uint8 images) -> list of HxW float depth maps."""
    _DEPTH_MODELS[name] = fn


def try_load_depth_anything(device: DeviceLike = None) -> bool:
    """Attempt to register DepthAnything via torch.hub (needs network and
    weights; returns False in offline images), run on ``device``
    (``cuda`` unless given)."""
    try:
        import torch

        device = resolve_device(device)
        model = torch.hub.load(
            "LiheYoung/Depth-Anything", "DepthAnything_vits14",
            pretrained=True,
        ).to(device)
        model.eval()

        def run(images):
            outs = []
            with torch.no_grad():
                for img in images:
                    t = (
                        torch.from_numpy(img).to(device).float()
                        .permute(2, 0, 1)[None] / 255.0
                    )
                    outs.append(model(t)[0].cpu().numpy())
            return outs

        register_depth_model("depth_anything", run)
        return True
    except Exception:
        return False


def try_load_local_dpt(model_dir=None, device: DeviceLike = None) -> bool:
    """Register a DPT / DepthAnything backend from a *local* transformers
    checkpoint directory (``model_dir`` or $GSTK_DEPTH_MODEL_DIR), run on
    ``device`` (``cuda`` unless given): the way to supply depth weights in
    an offline image (docs/WEIGHTS.md). Returns False when no directory is
    set or found, or the load fails."""
    model_dir = model_dir or os.environ.get("GSTK_DEPTH_MODEL_DIR")
    if not model_dir or not Path(model_dir).exists():
        return False
    device = resolve_device(device)
    try:
        import torch
        from transformers import (
            AutoImageProcessor,
            AutoModelForDepthEstimation,
        )

        model = AutoModelForDepthEstimation.from_pretrained(
            model_dir, local_files_only=True
        ).to(device)
        model.eval()
        try:
            proc = AutoImageProcessor.from_pretrained(
                model_dir, local_files_only=True
            )
        except Exception:
            proc = None

        def run(images):
            outs = []
            with torch.no_grad():
                for img in images:
                    if proc is not None:
                        inputs = proc(images=img, return_tensors="pt")
                        t = inputs["pixel_values"]
                    else:
                        t = (
                            torch.from_numpy(img).float()
                            .permute(2, 0, 1)[None] / 255.0
                        )
                    d = model(pixel_values=t.to(device)).predicted_depth[0]
                    d = torch.nn.functional.interpolate(
                        d[None, None], size=img.shape[:2], mode="bilinear",
                        align_corners=False,
                    )[0, 0]
                    outs.append(d.cpu().numpy())
            return outs

        register_depth_model("local_dpt", run)
        return True
    except Exception as e:  # depends on the local weights
        print(f"local DPT load failed: {e}", file=sys.stderr)
        return False


def _gradient_fallback(images: List[np.ndarray]) -> List[np.ndarray]:
    """Deterministic placeholder 'depth' (vertical gradient modulated by
    luminance) — keeps the est-depth pipeline executable offline. NOT a
    real depth estimator: selecting it requires an explicit opt-in
    (``allow_toy=True`` / --allow-toy-depth)."""
    outs = []
    for img in images:
        h, w = img.shape[:2]
        lum = img.mean(axis=-1) / 255.0
        grad = np.linspace(1.0, 0.2, h)[:, None] * np.ones((1, w))
        outs.append((grad * (0.5 + 0.5 * lum)).astype(np.float32))
    return outs


register_depth_model("gradient", _gradient_fallback)


def estimate_depths(
    image_dir: Path,
    out_dir: Path,
    method: str = "auto",
    allow_toy: bool = False,
    device: DeviceLike = None,
) -> List[Path]:
    """Estimate depth for every image; write scaled uint16 PNGs named
    depth_*.png (the layout align_mono_depth expects).

    ``method="auto"`` resolves, in order: an already-registered real model,
    torch-hub DepthAnything (needs network), a local transformers DPT
    checkpoint ($GSTK_DEPTH_MODEL_DIR, run on ``device``). If none exists it
    RAISES — training co-gs against the toy gradient silently would poison
    the depth losses; pass ``allow_toy=True`` to opt into the placeholder
    for smoke tests.
    """
    if method == "auto":
        if ("depth_anything" in _DEPTH_MODELS
                or try_load_depth_anything(device=device)):
            method = "depth_anything"
        elif "local_dpt" in _DEPTH_MODELS or try_load_local_dpt(
                device=device):
            method = "local_dpt"
        elif allow_toy:
            method = "gradient"
        else:
            raise RuntimeError(
                "No real monocular depth model is available: torch-hub "
                "DepthAnything needs network access, and no local "
                "checkpoint was found. Set GSTK_DEPTH_MODEL_DIR to a "
                "transformers DPT/DepthAnything checkpoint directory "
                "(see docs/WEIGHTS.md), register one via "
                "register_depth_model(), or pass allow_toy=True / "
                "--allow-toy-depth to knowingly use the placeholder "
                "gradient (unusable for training)."
            )
    if method == "gradient" and not allow_toy:
        raise RuntimeError(
            "The 'gradient' depth backend is a test placeholder; pass "
            "allow_toy=True / --allow-toy-depth to use it knowingly."
        )
    if method not in _DEPTH_MODELS:
        raise ValueError(
            f"unknown depth model '{method}'; register one via "
            "register_depth_model"
        )
    files = sorted(
        p for p in Path(image_dir).iterdir()
        if p.suffix.lower() in (".jpg", ".jpeg", ".png")
    )
    images = [load_image(p)[..., :3] for p in files]
    depths = _DEPTH_MODELS[method](images)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for p, d in zip(files, depths):
        d = np.asarray(d, np.float32)
        d = (d - d.min()) / max(float(d.max() - d.min()), 1e-9) * 255.0
        name = p.stem.replace("frame_", "depth_") + ".png"
        out = out_dir / name
        write_png(out, d.astype(np.uint16))
        written.append(out)
    return written
