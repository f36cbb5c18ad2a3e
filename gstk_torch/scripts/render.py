"""gs-render for gstk_torch: offline rendering from trajectories or training
poses (port of ``gstk_tpu/scripts/render.py``).

    python -m gstk_torch.scripts.render trajectory --trajectory-path <json> --load-config <run>/config.yml [--device cpu]
    python -m gstk_torch.scripts.render pose --load-config <run>/config.yml --output-dir <dir> [--device cpu]

  * ``trajectory`` renders a nerfstudio camera_path JSON to ``render/rgb``
    and ``render/depth`` beside the config;
  * ``pose`` renders every training camera, copies the GT rgb (and depth)
    alongside, and writes ``poses.json`` with the poses mapped back to the
    original dataset space: the input layout of offline TSDF.

The flags are gstk_tpu's, plus ``--device`` on each subcommand (default
``cuda``; without a card and without ``--device`` it raises). PNGs are
written by :func:`gstk_torch.utils.io.write_png`: rgb as 8-bit RGB, the
pixels OpenCV writes; depth in millimeters as a 16-bit grey PNG clamped at
65535, the file Pillow writes for gstk_tpu's uint32 array.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from gstk_torch.utils.io import write_png


def _save_rgb(path, rgb) -> None:
    write_png(path, (np.clip(rgb, 0, 1) * 255).astype(np.uint8))


def _save_depth_mm(path, depth_m) -> None:
    mm = (1000.0 * depth_m).astype(np.uint32)
    write_png(path, np.minimum(mm, 65535).astype(np.uint16))


def _renderer(args):
    from gstk_torch.configs.serialize import load_config
    from gstk_torch.render.renderer import Renderer

    config = load_config(args.load_config)
    run_dir = Path(args.load_config).parent
    # --precision is gstk_tpu's TPU render precision: the Renderer accepts
    # and ignores it
    renderer = Renderer(run_dir / "ckpts", model_config=config.model,
                        precision=args.precision, device=args.device)
    return config, run_dir, renderer


def render_trajectory(args) -> None:
    _, run_dir, renderer = _renderer(args)
    out_dir = run_dir / "render"
    (out_dir / "rgb").mkdir(parents=True, exist_ok=True)
    (out_dir / "depth").mkdir(parents=True, exist_ok=True)

    with open(args.trajectory_path) as f:
        meta = json.load(f)
    path = meta["camera_path"]
    h = int(meta.get("render_height", 1080))
    w = int(meta.get("render_width", 1920))
    interval = max(len(path) // args.num_frames_target, 1)
    idx = 0
    for i in range(0, len(path), interval):
        node = path[i]
        c2w = np.asarray(node["camera_to_world"], np.float32).reshape(4, 4)
        fov_deg = float(node.get("fov", 70.0))
        fy = 0.5 * h / np.tan(0.5 * np.deg2rad(fov_deg))
        out = renderer.get_output_from_pose(c2w, fy, fy, w / 2, h / 2, h, w)
        _save_rgb(out_dir / "rgb" / f"frame_{idx:05d}.png", out["rgb"])
        _save_depth_mm(out_dir / "depth" / f"depth_{idx:05d}.png", out["depth"])
        idx += 1
    print(f"Rendered {idx} frames to {out_dir}")


def render_poses(args) -> None:
    from gstk_torch.data.datamanager import FullImageDatamanager
    from gstk_torch.utils.poses import transform_poses_to_original_space

    config, _, renderer = _renderer(args)
    dm = FullImageDatamanager(config.dataparser, seed=config.seed)
    out_dir = Path(args.output_dir)
    for sub in ("rgb", "depth", "gt/rgb", "gt/depth"):
        (out_dir / sub).mkdir(parents=True, exist_ok=True)

    traj, poses = [], []
    outs = dm.train_outputs
    for i, frame in enumerate(dm.train_frames):
        h, w = frame.image.shape[:2]
        out = renderer.get_output_from_pose(
            frame.c2w, frame.fx, frame.fy, frame.cx, frame.cy, h, w
        )
        _save_rgb(out_dir / "rgb" / f"frame_{i:05d}.png", out["rgb"])
        _save_depth_mm(out_dir / "depth" / f"depth_{i:05d}.png", out["depth"])
        _save_rgb(out_dir / "gt" / "rgb" / f"frame_{i:05d}.png",
                  frame.image[..., :3])
        if frame.depth is not None:
            _save_depth_mm(
                out_dir / "gt" / "depth" / f"depth_{i:05d}.png",
                frame.depth / outs.dataparser_scale,
            )
        traj.append(
            {
                "camera": {
                    "width": w, "height": h,
                    "fx": frame.fx, "fy": frame.fy,
                    "cx": frame.cx, "cy": frame.cy,
                }
            }
        )
        poses.append(frame.c2w)

    poses = np.stack(poses)
    if args.transform_to_original_space:
        poses = transform_poses_to_original_space(
            poses, outs.dataparser_transform, outs.dataparser_scale
        )
    for idx, node in enumerate(traj):
        pose = np.vstack([poses[idx], np.array([0, 0, 0, 1], np.float32)])
        node["pose"] = pose.tolist()
    with open(out_dir / "poses.json", "w") as f:
        json.dump(traj, f)
    print(f"Rendered {len(traj)} training views to {out_dir}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("gs-render")
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p):
        p.add_argument("--load-config", type=Path, required=True)
        p.add_argument("--precision", default="exact",
                       choices=["exact", "high", "fast"])
        p.add_argument("--device", default=None,
                       help="torch device (default cuda; cpu runs the plain "
                            "twins)")

    p = sub.add_parser("trajectory")
    p.add_argument("--trajectory-path", type=Path, required=True)
    p.add_argument("--num-frames-target", type=int, default=100)
    common(p)
    p.set_defaults(fn=render_trajectory)
    p = sub.add_parser("pose")
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--transform-to-original-space", type=bool, default=True)
    common(p)
    p.set_defaults(fn=render_poses)
    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
