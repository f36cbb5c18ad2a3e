"""Depth alignment against COLMAP sparse geometry (port of
``gstk_tpu/process_data/depth_align.py``, a numpy copy).

Numpy port of the alignment math in
``gs_toolkit/process_data/colmap_utils.py:409-591``:

  * :func:`align_sensor_depth` — global metric scale: per-image mean of
    (measured depth / SfM z) over filtered triangulated points, averaged
    over images (the toolkit's "sensor depth scale alignment");
  * :func:`align_mono_depth` — per-image least-squares (m, c) such that
    est_depth ~= m * sfm_z + c (mono-depth scale/shift alignment).

Both operate on an in-memory COLMAP model (see :mod:`gstk_torch.process_data.colmap`) plus a
callable mapping image name -> depth array, so they are testable without
running COLMAP.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from gstk_torch.process_data.colmap import (
    ColmapImage,
    ColmapPoint3D,
    qvec_to_rotmat,
)


def _filtered_points(
    im: ColmapImage,
    points: Dict[int, ColmapPoint3D],
    width: int,
    height: int,
    min_depth: float,
    max_depth: float,
    max_reproj_err: float,
    min_n_visible: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """SfM z and pixel uv of this image's triangulated points after the
    reference's quality filters (colmap_utils.py:470-495)."""
    has_pt = im.point3d_ids != -1
    pids = im.point3d_ids[has_pt]
    uv = im.xys[has_pt]
    xyz = np.array([points[pid].xyz for pid in pids]).reshape(-1, 3)
    errors = np.array([points[pid].error for pid in pids])
    n_vis = np.array([len(points[pid].image_ids) for pid in pids])
    rot = qvec_to_rotmat(im.qvec)
    z = (rot @ xyz.T)[-1] + im.tvec[-1]
    keep = (
        (z >= min_depth)
        & (z <= max_depth)
        & (errors <= max_reproj_err)
        & (n_vis >= min_n_visible)
        & (uv[:, 0] >= 0)
        & (uv[:, 0] < width)
        & (uv[:, 1] >= 0)
        & (uv[:, 1] < height)
    )
    return z[keep], uv[keep]


def align_sensor_depth(
    images: Dict[int, ColmapImage],
    points: Dict[int, ColmapPoint3D],
    depth_lookup: Callable[[str], np.ndarray],
    width: int,
    height: int,
    min_depth: float = 0.001,
    max_depth: float = 10_000,
    max_reproj_err: float = 2.5,
    min_n_visible: int = 2,
    depth_min_mm: float = 30,
    depth_max_mm: float = 1_000,
) -> float:
    """Global scale = mean over images of mean(measured/sfm_z).

    ``depth_lookup(name)`` returns the raw sensor depth image in mm.
    """
    scales, variances = [], []
    for im in images.values():
        depth_img = depth_lookup(im.name)
        if depth_img is None:
            continue
        z, uv = _filtered_points(
            im, points, width, height, min_depth, max_depth,
            max_reproj_err, min_n_visible,
        )
        if len(z) == 0:
            continue
        uu = uv[:, 0].astype(int)
        vv = uv[:, 1].astype(int)
        measured = depth_img[vv, uu].astype(np.float64)
        ok = (measured > depth_min_mm) & (measured < depth_max_mm)
        if not ok.any():
            continue
        ratio = (measured[ok] / 1000.0) / z[ok]
        scales.append(ratio.mean())
        variances.append(ratio.var())
    if not scales:
        raise RuntimeError("no overlapping depth/SfM points found")
    mean_scale = float(np.mean(scales))
    if np.mean(variances) / mean_scale > 0.1:
        print(
            f"Warning: high scale variance ({np.mean(variances):.4f} over "
            f"mean {mean_scale:.4f}); alignment may be inaccurate."
        )
    return mean_scale


def align_mono_depth(
    images: Dict[int, ColmapImage],
    points: Dict[int, ColmapPoint3D],
    depth_lookup: Callable[[str], np.ndarray],
    width: int,
    height: int,
    min_depth: float = 0.001,
    max_depth: float = 10_000,
    max_reproj_err: float = 2.5,
    min_n_visible: int = 2,
) -> Tuple[Dict[int, float], Dict[int, float]]:
    """Per-image (scale, shift): est_depth ~= m * sfm_z + c.

    ``depth_lookup(name)`` returns the mono-depth estimate image (raw units;
    divided by 255 like the reference, colmap_utils.py:581).
    """
    scales, shifts = {}, {}
    for im_id, im in images.items():
        depth_img = depth_lookup(im.name)
        if depth_img is None:
            continue
        z, uv = _filtered_points(
            im, points, width, height, min_depth, max_depth,
            max_reproj_err, min_n_visible,
        )
        if len(z) < 2:
            continue
        uu = uv[:, 0].astype(int)
        vv = uv[:, 1].astype(int)
        est = depth_img[vv, uu].astype(np.float64) / 255.0
        a = np.vstack([z, np.ones(len(z))]).T
        (m, c), *_ = np.linalg.lstsq(a, est, rcond=None)
        scales[im_id] = float(m)
        shifts[im_id] = float(c)
    return scales, shifts
