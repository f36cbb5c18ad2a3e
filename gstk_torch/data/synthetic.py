"""Synthetic dataset generation: write a complete on-disk training dataset
(port of ``gstk_tpu/data/synthetic.py``).

Procedurally build a colored-Gaussian object, render posed views with the
port's own renderer (``render_scene``, so the CUDA kernels on a card), and
write a standard dataset directory (images/, depths/, sparse.ply seed
cloud, transforms.json) that ``gstk_torch.scripts.train`` and gstk_tpu's
CLIs consume. PNGs are written by the port's codec (:mod:`gstk_torch.utils.io`).

The object's points and colors come from the same numpy generator as in
gstk_tpu, so both packages place the same seed cloud; the Gaussians'
random rotations come from a ``torch.Generator``, so the images differ
from gstk_tpu's for the same seed. A view whose intersections exceed the
fixed buffer would lose its last tiles; the generator raises instead.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from gstk_torch import DeviceLike, resolve_device
from gstk_torch.core.cameras import Camera
from gstk_torch.core.gaussians import init_scene
from gstk_torch.models.vanilla import render_scene
from gstk_torch.ops.rasterize import RasterizeConfig
from gstk_torch.utils.io import write_ply, write_png

ISECT_CAPACITY = 1 << 17  # intersections the generator renders a view with


def generate_synthetic_dataset(
    out_dir: Path,
    n_points: int = 1500,
    n_views: int = 12,
    img_wh: Tuple[int, int] = (96, 72),
    seed: int = 0,
    object_kind: str = "blobs",  # blobs | sphere | cube
    write_depth: bool = True,
    device: DeviceLike = None,
) -> Path:
    """Create the dataset under ``out_dir``, rendering on ``device`` (cuda
    unless given); returns the directory."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    w, h = img_wh
    out_dir = Path(out_dir)
    (out_dir / "images").mkdir(parents=True, exist_ok=True)
    if write_depth:
        (out_dir / "depths").mkdir(exist_ok=True)

    if object_kind == "sphere":
        d = rng.normal(size=(n_points, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        pts = (d * rng.uniform(0.9, 1.1, (n_points, 1))).astype(np.float32)
    elif object_kind == "cube":
        pts = rng.uniform(-1, 1, (n_points, 3)).astype(np.float32)
        axis = rng.integers(0, 3, n_points)
        sign = rng.choice([-1.0, 1.0], n_points)
        pts[np.arange(n_points), axis] = sign
    else:
        centers = rng.uniform(-1, 1, (6, 3))
        which = rng.integers(0, 6, n_points)
        pts = (
            centers[which] + rng.normal(0, 0.25, (n_points, 3))
        ).astype(np.float32)
    rgb = rng.uniform(30, 225, (n_points, 3)).astype(np.float32)

    scene = init_scene(
        torch.Generator().manual_seed(seed),
        1 << int(np.ceil(np.log2(n_points + 1))),
        (pts, rgb), sh_degree=0, device=device,
    )
    with torch.no_grad():
        scene.opacities.fill_(1.5)
        scene.scales.add_(0.3)
    raster = RasterizeConfig(chunk_size=32, isect_capacity=ISECT_CAPACITY,
                             forward_only=True)
    fx = 0.9 * w
    frames = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        c, s = np.cos(ang), np.sin(ang)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        c2w = np.zeros((4, 4), np.float32)
        c2w[:3, :3] = rot
        c2w[:3, 3] = rot @ np.array([0, 0.3, 5.0], np.float32)
        c2w[3, 3] = 1.0
        camera = Camera.create(fx, fx, w / 2, h / 2, c2w, device=device)
        with torch.no_grad():
            outp = render_scene(
                scene, camera, h, w, sh_degree=0,
                background=torch.zeros(3, device=device),
                raster_config=raster,
            )
        n_isect = int(outp["num_intersects"])
        if n_isect > ISECT_CAPACITY:
            raise ValueError(
                f"view {i} has {n_isect} intersections, more than the "
                f"{ISECT_CAPACITY} the generator renders with: use fewer "
                "points or a smaller image"
            )
        rgba = np.concatenate(
            [
                np.clip(outp["rgb"].cpu().numpy(), 0, 1),
                np.clip(outp["alpha"].cpu().numpy(), 0, 1)[..., None],
            ],
            axis=-1,
        )
        name = f"frame_{i:05d}.png"
        write_png(out_dir / "images" / name, (rgba * 255).astype(np.uint8))
        frame = {
            "file_path": f"images/{name}",
            "transform_matrix": c2w.tolist(),
        }
        if write_depth:
            depth_mm = (outp["depth"].cpu().numpy() * 1000).astype(np.uint16)
            dname = f"depth_{i:05d}.png"
            write_png(out_dir / "depths" / dname, depth_mm)
            frame["depth_path"] = f"depths/{dname}"
        frames.append(frame)

    write_ply(
        out_dir / "sparse.ply",
        {
            "vertex": {
                "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
                "red": rgb[:, 0].astype(np.uint8),
                "green": rgb[:, 1].astype(np.uint8),
                "blue": rgb[:, 2].astype(np.uint8),
            }
        },
    )
    meta = {
        "fl_x": fx, "fl_y": fx, "cx": w / 2, "cy": h / 2, "w": w, "h": h,
        "camera_model": "OPENCV",
        "ply_file_path": "sparse.ply",
        "frames": frames,
    }
    with open(out_dir / "transforms.json", "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser("gs-synthetic-data")
    parser.add_argument("--output-dir", type=Path, required=True)
    parser.add_argument("--n-points", type=int, default=1500)
    parser.add_argument("--n-views", type=int, default=12)
    parser.add_argument("--width", type=int, default=96)
    parser.add_argument("--height", type=int, default=72)
    parser.add_argument("--object", type=str, default="blobs",
                        choices=["blobs", "sphere", "cube"])
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to render on (default: cuda)")
    args = parser.parse_args(argv)
    out = generate_synthetic_dataset(
        args.output_dir, args.n_points, args.n_views,
        (args.width, args.height), object_kind=args.object,
        device=args.device,
    )
    print(f"Synthetic dataset written to {out}")


if __name__ == "__main__":
    main()
