"""The band-limited raytraced capture of the quality reference (port of
``tools/gen_raytraced_sharded.py``).

This is the dataset behind the reference's published 240-view result, and
it differs from the serial generator's (``gstk_torch.data.raytraced``) in
two ways that change the seed cloud:

  * each view draws its seed points from ``np.random.default_rng(1000 +
    i)``; the views' points are merged in shard order (views 0, 3, 6, ...
    then 1, 4, 7, ... for 3 workers) and ``default_rng(0)`` then picks
    ``--seed-points`` of them (the serial generator draws everything from
    one ``default_rng(seed)``);
  * the depth mask, the seed choice and the seed colours come from the
    centre ray's own shading; only the image takes the ss² box filter and
    its majority hit.

The views are shaded on ``--device`` (``cuda`` unless given) through the
serial generator's ``render_view``, all in this one process: the original
split the view loop over worker processes because its numpy loop was slow
on a CPU. ``--workers`` stays, because it fixes the merge order and so the
seed cloud. PNGs are written by :func:`gstk_torch.utils.io.write_png`.

Usage:
  python -m gstk_torch.tools.gen_raytraced_sharded --output-dir rt_ss3 \\
      [--n-views 240] [--supersample 3] [--workers 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from gstk_torch import DeviceLike, resolve_device
from gstk_torch.data.raytraced import (
    build_scene,
    camera_dirs,
    render_view,
    view_images,
    view_pose,
)
from gstk_torch.utils.io import write_ply, write_png

SEEDS_PER_VIEW = 4000  # the most seed points one view contributes


def view_seeds(i: int, c2w: np.ndarray, d: torch.Tensor, t: np.ndarray,
               rgb_c: np.ndarray, hit_c: np.ndarray):
    """View ``i``'s seed points and colours (float32): centre-ray hits
    drawn by ``default_rng(1000 + i)``, backprojected along the centre
    directions ``d`` (on the device) and jittered by N(0, 0.004)."""
    rng = np.random.default_rng(1000 + i)
    hit_idx = np.flatnonzero(hit_c)
    if not hit_idx.size:
        return None
    take = rng.choice(hit_idx, min(SEEDS_PER_VIEW, hit_idx.size),
                      replace=False)
    dt = d[torch.from_numpy(take).to(d.device)].cpu().numpy()
    p = c2w[:3, 3] + dt * t[take, None]
    p = p + rng.normal(0, 0.004, p.shape)
    return p.astype(np.float32), (rgb_c[take] * 255).astype(np.float32)


def generate_sharded_dataset(
    out_dir: Path,
    n_views: int = 240,
    img_wh: Tuple[int, int] = (800, 800),
    seed_points: int = 160_000,
    supersample: int = 3,
    workers: int = 3,
    fov_deg: float = 40.0,
    device: DeviceLike = None,
) -> Path:
    """Write the sharded tool's dataset to ``out_dir``; returns it."""
    device = resolve_device(device)
    out_dir = Path(out_dir)
    (out_dir / "images").mkdir(parents=True, exist_ok=True)
    (out_dir / "depths").mkdir(exist_ok=True)
    w, h = img_wh
    fx = 0.5 * w / np.tan(np.radians(fov_deg) / 2)
    cx, cy = w / 2.0, h / 2.0
    objs = build_scene()
    dirs = camera_dirs(w, h, fx, cx, cy, supersample)

    frames, seeds = {}, {}
    for i in range(n_views):
        c2w = view_pose(i, n_views)
        rgb, t, hit, d, rgb_c, hit_c = render_view(objs, c2w, dirs, device,
                                                   centre=True)
        rgb, t, hit, rgb_c, hit_c = (
            x.cpu().numpy() for x in (rgb, t, hit, rgb_c, hit_c))
        img, _ = view_images(rgb, t, hit, h, w)
        _, depth_mm = view_images(rgb_c, t, hit_c, h, w)
        name, dname = f"frame_{i:05d}.png", f"depth_{i:05d}.png"
        write_png(out_dir / "images" / name, img)
        write_png(out_dir / "depths" / dname, depth_mm)
        frames[i] = {
            "file_path": f"images/{name}",
            "depth_path": f"depths/{dname}",
            "transform_matrix": c2w.tolist(),
        }
        seeds[i] = view_seeds(i, c2w, d, t, rgb_c, hit_c)

    # the merge: shard s held views s, s + workers, ...
    order = [i for s in range(workers) for i in range(s, n_views, workers)]
    kept = [seeds[i] for i in order if seeds[i] is not None]
    pts = np.concatenate([p for p, _ in kept])
    cols = np.concatenate([c for _, c in kept])
    rng = np.random.default_rng(0)
    if pts.shape[0] > seed_points:
        sel = rng.choice(pts.shape[0], seed_points, replace=False)
        pts, cols = pts[sel], cols[sel]
    write_ply(out_dir / "sparse.ply", {"vertex": {
        "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
        "red": cols[:, 0].astype(np.uint8),
        "green": cols[:, 1].astype(np.uint8),
        "blue": cols[:, 2].astype(np.uint8),
    }})
    meta = {
        "fl_x": fx, "fl_y": fx, "cx": cx, "cy": cy, "w": w, "h": h,
        "camera_model": "OPENCV",
        "ply_file_path": "sparse.ply",
        "frames": [frames[i] for i in range(n_views)],
    }
    (out_dir / "transforms.json").write_text(json.dumps(meta, indent=2))
    return out_dir


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser("gs-raytraced-sharded")
    ap.add_argument("--output-dir", type=Path, required=True)
    ap.add_argument("--n-views", type=int, default=240)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--seed-points", type=int, default=160_000)
    ap.add_argument("--supersample", type=int, default=3)
    ap.add_argument("--workers", type=int, default=3,
                    help="shards of the original tool: fixes the seed "
                         "cloud's merge order")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    out = generate_sharded_dataset(
        args.output_dir, args.n_views, (args.width, args.height),
        args.seed_points, args.supersample, args.workers,
        device=args.device,
    )
    print(f"sharded raytraced dataset written to {out}")
    return out


if __name__ == "__main__":
    main()
