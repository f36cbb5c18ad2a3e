"""End-to-end demo on a synthetic scene: train, eval, export (port of
``examples/train_synthetic.py``).

Run: python -m gstk_torch.examples.train_synthetic [--steps 300] \\
         [--out <dir>] [--device cpu]

Builds a random colored-point scene, renders ground-truth views with a
"teacher" scene, trains a fresh model on them, reports PSNR, and exports a
splat PLY — the whole framework exercised without any dataset on disk.
Runs on ``cuda`` unless ``--device`` says otherwise; ``--out`` defaults to
``gstk_demo`` in the system's temporary directory.
"""

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


def main(argv=None) -> dict:
    """Train and export; returns the last step's metrics (floats) and the
    number of Gaussians exported."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--out", type=Path,
                        default=Path(tempfile.gettempdir()) / "gstk_demo")
    parser.add_argument("--n-gaussians", type=int, default=2000)
    parser.add_argument("--res", type=int, default=128)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)

    from gstk_torch import resolve_device
    from gstk_torch.core.cameras import Camera
    from gstk_torch.core.gaussians import init_scene, scene_from_numpy, scene_to_numpy
    from gstk_torch.exporter.gaussian_ply import export_gaussian_ply
    from gstk_torch.models.vanilla import VanillaConfig, render_scene
    from gstk_torch.ops.rasterize import RasterizeConfig
    from gstk_torch.train.optim import OptimizerConfig
    from gstk_torch.train.step import init_train_state, make_train_step

    device = resolve_device(args.device)
    H = W = args.res
    rng = np.random.default_rng(0)
    raster = RasterizeConfig(chunk_size=32, isect_capacity=1 << 17)

    # teacher scene
    pts = rng.uniform(-1.5, 1.5, (args.n_gaussians, 3)).astype(np.float32)
    rgb = rng.uniform(30, 225, (args.n_gaussians, 3)).astype(np.float32)
    arrays = scene_to_numpy(init_scene(
        torch.Generator().manual_seed(7), 1 << 12, (pts, rgb), sh_degree=0,
        device="cpu"))
    arrays["opacities"] = np.full_like(arrays["opacities"], 1.5)
    arrays["scales"] = arrays["scales"] + np.float32(0.3)
    teacher = scene_from_numpy(arrays, device)

    def camera(angle):
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        c2w = np.zeros((3, 4), np.float32)
        c2w[:3, :3] = rot
        c2w[:3, 3] = rot @ np.array([0, 0, 5.0], np.float32)
        return Camera.create(W * 0.9, W * 0.9, W / 2, H / 2, c2w,
                             device=device)

    cams = [camera(a) for a in np.linspace(-0.5, 0.5, 8)]
    print("Rendering ground truth views...")
    with torch.no_grad():
        gts = [
            render_scene(
                teacher, c, H, W, sh_degree=0,
                background=torch.zeros(3, device=device),
                raster_config=raster,
            )["rgb"]
            for c in cams
        ]

    # student: same geometry, perturbed appearance
    arrays["features_dc"] = arrays["features_dc"] + rng.normal(
        0, 1.5, arrays["features_dc"].shape).astype(np.float32)
    arrays["opacities"] = np.zeros_like(arrays["opacities"])
    student = scene_from_numpy(arrays, device)
    cfg = VanillaConfig(background_color="black", sh_degree=0)
    step_fn = make_train_step(cfg, raster, OptimizerConfig(), H, W,
                              sh_degree=0)
    state = init_train_state(student)
    generator = torch.Generator(device=device).manual_seed(0)
    t0 = time.time()
    metrics = {}
    for i in range(args.steps):
        j = i % len(cams)
        state, metrics = step_fn(state, cams[j], gts[j], generator)
        if i % 50 == 0 or i == args.steps - 1:
            print(
                f"step {i:4d}  loss {float(metrics['loss']):.4f}  "
                f"psnr {float(metrics['psnr']):.2f}"
            )
    dt = time.time() - t0
    print(f"{args.steps} steps in {dt:.1f}s "
          f"({args.steps * H * W / dt / 1e6:.2f} Mrays/s)")

    args.out.mkdir(parents=True, exist_ok=True)
    n = export_gaussian_ply(args.out / "trained.ply", state.scene)
    print(f"Exported {n} gaussians to {args.out / 'trained.ply'}")
    return {**{k: float(v) for k, v in metrics.items()}, "exported": n}


if __name__ == "__main__":
    main()
