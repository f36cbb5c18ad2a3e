"""Equirectangular -> perspective view extraction (port of
``gstk_tpu/process_data/equirect.py``, a numpy copy).

Samples a set of planar pinhole views out of 360° equirectangular captures
so they can run through the standard SfM + splat pipeline. gstk_tpu samples
with ``cv2.remap(INTER_LINEAR, BORDER_WRAP)``; here the same bilinear sample
with a wrap on both axes is numpy in float64, rounded back to the image's
dtype, so a uint8 view is within one level of OpenCV's. Files go through
:func:`gstk_torch.utils.io.read_png` / :func:`write_png`; a JPEG capture is
read by Pillow, imported only then.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np

from gstk_torch.utils.io import load_image, write_png


def remap_bilinear_wrap(image: np.ndarray, u: np.ndarray, v: np.ndarray
                        ) -> np.ndarray:
    """``image`` sampled at pixel positions (u, v) (x, y; pixel centres at
    integers) by bilinear interpolation in float64, both axes wrapped;
    integer images are rounded back to their dtype."""
    h, w = image.shape[:2]
    u, v = np.asarray(u, np.float64), np.asarray(v, np.float64)
    x0, y0 = np.floor(u), np.floor(v)
    fx, fy = u - x0, v - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    x0, x1 = x0 % w, (x0 + 1) % w
    y0, y1 = y0 % h, (y0 + 1) % h
    img = image.astype(np.float64)
    if img.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]
    top = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
    bottom = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
    out = top * (1 - fy) + bottom * fy
    if np.issubdtype(image.dtype, np.integer):
        info = np.iinfo(image.dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(image.dtype)
    return out.astype(image.dtype)


def perspective_from_equirect(
    equirect: np.ndarray,
    yaw: float,
    pitch: float,
    fov_deg: float = 90.0,
    out_hw: Tuple[int, int] = (720, 960),
) -> np.ndarray:
    """Extract one pinhole view (yaw/pitch radians) from an equirect image."""
    h_out, w_out = out_hw
    f = 0.5 * w_out / np.tan(0.5 * np.deg2rad(fov_deg))
    xs = (np.arange(w_out) - w_out / 2 + 0.5) / f
    ys = (np.arange(h_out) - h_out / 2 + 0.5) / f
    xg, yg = np.meshgrid(xs, ys)
    dirs = np.stack([xg, yg, np.ones_like(xg)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    d = dirs @ (ry @ rx).T

    he, we = equirect.shape[:2]
    lon = np.arctan2(d[..., 0], d[..., 2])
    lat = np.arcsin(np.clip(d[..., 1], -1, 1))
    u = ((lon / (2 * np.pi) + 0.5) * we).astype(np.float32)
    v = ((lat / np.pi + 0.5) * he).astype(np.float32)
    return remap_bilinear_wrap(equirect, u, v)


def generate_planar_projections_from_equirectangular(
    image_dir: Path,
    out_dir: Path,
    samples_per_image: int = 8,
    fov_deg: float = 90.0,
    out_hw: Tuple[int, int] = (720, 960),
) -> List[Path]:
    """Sample ``samples_per_image`` yaw-spaced views for every equirect
    image in ``image_dir``; each view is written as an RGB PNG."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    yaws = np.linspace(0, 2 * np.pi, samples_per_image, endpoint=False)
    files = sorted(
        p for p in Path(image_dir).iterdir()
        if p.suffix.lower() in (".jpg", ".jpeg", ".png")
    )
    for p in files:
        img = load_image(p)[..., :3]
        for j, yaw in enumerate(yaws):
            view = perspective_from_equirect(img, yaw, 0.0, fov_deg, out_hw)
            out = out_dir / f"{p.stem}_view{j:02d}.png"
            write_png(out, view)
            written.append(out)
    return written
