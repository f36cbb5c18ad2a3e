"""gs-export for gstk_torch: export trained scenes (splat PLY, camera poses,
point cloud, offline TSDF mesh) (port of ``gstk_tpu/scripts/export.py``).

    python -m gstk_torch.scripts.export <command> --load-config <run>/config.yml --output-dir <dir> [--device cpu] [...]

  * ``gaussian-splat``: splat PLY in the standard attribute layout;
  * ``camera-poses``: train and eval poses as JSON;
  * ``point-cloud``: render-backprojected colored point cloud;
  * ``offline-tsdf``: fuse rendered depth into a TSDF volume on the device
    and extract a colored mesh (marching tetrahedra, or the
    screened-Poisson indicator with ``--meshing poisson``), optionally
    masked before fusion and cleaned after.

The flags are gstk_tpu's, plus ``--device`` on each subcommand (default
``cuda``; without a card and without ``--device`` it raises). Only
``--propagate-masks`` needs OpenCV and only ``--mask-method grounded_sam``
transformers.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def _load(args):
    from gstk_torch.configs.serialize import load_config
    from gstk_torch.render.renderer import Renderer

    config = load_config(args.load_config)
    run_dir = Path(args.load_config).parent
    renderer = Renderer(run_dir / "ckpts", model_config=config.model,
                        device=args.device)
    return config, run_dir, renderer


def export_gaussian_splat(args) -> None:
    from gstk_torch.exporter.gaussian_ply import export_gaussian_ply

    _, _, renderer = _load(args)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = export_gaussian_ply(out / "gaussians.ply", renderer.scene)
    print(f"Exported {n} gaussians to {out / 'gaussians.ply'}")


def export_camera_poses(args) -> None:
    from gstk_torch.configs.serialize import load_config
    from gstk_torch.data.datamanager import FullImageDatamanager

    config = load_config(args.load_config)
    dm = FullImageDatamanager(config.dataparser, seed=config.seed)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    for split, frames in (("train", dm.train_frames), ("eval", dm.eval_frames)):
        data = [
            {
                "c2w": f.c2w.tolist(),
                "fx": f.fx, "fy": f.fy, "cx": f.cx, "cy": f.cy,
            }
            for f in frames
        ]
        with open(out / f"{split}_poses.json", "w") as fh:
            json.dump(data, fh)
    print(f"Wrote poses to {out}")


def export_point_cloud(args) -> None:
    """Backproject rendered depth into a colored point cloud PLY."""
    from gstk_torch.data.datamanager import FullImageDatamanager
    from gstk_torch.utils.io import write_ply

    config, _, renderer = _load(args)
    dm = FullImageDatamanager(config.dataparser, seed=config.seed)
    pts, cols = [], []
    per_frame = max(args.num_points // max(len(dm.train_frames), 1), 1)
    rng = np.random.default_rng(0)
    for frame in dm.train_frames:
        h, w = frame.image.shape[:2]
        out = renderer.get_output_from_pose(
            frame.c2w, frame.fx, frame.fy, frame.cx, frame.cy, h, w
        )
        depth = out["depth"]
        acc = out["accumulation"]
        valid = (acc > 0.5) & (depth > 0)
        ys, xs = np.nonzero(valid)
        if len(ys) == 0:
            continue
        sel = rng.choice(len(ys), size=min(per_frame, len(ys)), replace=False)
        ys, xs = ys[sel], xs[sel]
        d = depth[ys, xs]
        # OpenCV cam coords (+z forward) -> world via OpenGL c2w
        x_c = (xs - frame.cx) / frame.fx * d
        y_c = (ys - frame.cy) / frame.fy * d
        cam_pts = np.stack([x_c, -y_c, -d], axis=-1)  # to OpenGL axes
        world = cam_pts @ frame.c2w[:3, :3].T + frame.c2w[:3, 3]
        pts.append(world)
        cols.append(out["rgb"][ys, xs])
    xyz = np.concatenate(pts).astype(np.float32)
    rgb = (np.clip(np.concatenate(cols), 0, 1) * 255).astype(np.uint8)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    write_ply(
        out_dir / "point_cloud.ply",
        {
            "vertex": {
                "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
                "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2],
            }
        },
    )
    print(f"Wrote {len(xyz)} points to {out_dir / 'point_cloud.ply'}")


def fusion_inputs(renderer, frames):
    """What TSDF fusion integrates, one entry a frame: the rendered depth
    where the accumulation passes 0.5 (0 elsewhere), the rendered rgb, the
    intrinsics (fx, fy, cx, cy) and the OpenCV world-to-camera matrix."""
    depths, colors, intr, w2cs = [], [], [], []
    for frame in frames:
        h, w = frame.image.shape[:2]
        out = renderer.get_output_from_pose(
            frame.c2w, frame.fx, frame.fy, frame.cx, frame.cy, h, w
        )
        depths.append(out["depth"] * (out["accumulation"] > 0.5))
        colors.append(out["rgb"])
        intr.append([frame.fx, frame.fy, frame.cx, frame.cy])
        # OpenGL c2w -> OpenCV w2c
        r = frame.c2w[:3, :3] * np.array([1.0, -1.0, -1.0])[None, :]
        t = frame.c2w[:3, 3:4]
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = r.T
        w2c[:3, 3:4] = -r.T @ t
        w2cs.append(w2c)
    return depths, colors, intr, w2cs


def export_offline_tsdf(args) -> None:
    from gstk_torch.data.datamanager import FullImageDatamanager
    from gstk_torch.exporter.tsdf import (
        integrate_frames,
        make_volume,
        marching_tetrahedra,
        write_mesh_ply,
    )

    config, _, renderer = _load(args)
    dm = FullImageDatamanager(config.dataparser, seed=config.seed)
    depths, colors, intr, w2cs = fusion_inputs(renderer, dm.train_frames)

    # optional object isolation before fusion (reference
    # mask_generater.py:24 GroundingDINO+SAM chain / fallbacks): masked-out
    # pixels get zero depth and never integrate
    mask_method = args.mask_method
    if mask_method != "none":
        from gstk_torch.exporter.mask_generation import generate_masks

        imgs_u8 = [
            (np.clip(c, 0, 1) * 255).astype(np.uint8) for c in colors
        ]
        accs = [(d > 0).astype(np.float32) for d in depths]
        masks = generate_masks(
            imgs_u8, prompt=args.prompt,
            method=mask_method, accumulations=accs,
            box=args.mask_box,
        )
        if args.propagate_masks:
            # DEVA-role temporal consolidation (reference
            # mask_generater.py:24 video propagation): flow-carried
            # forward/backward chains + per-pixel majority vote.
            from gstk_torch.exporter.mask_propagation import propagate_masks

            masks = propagate_masks(imgs_u8, masks)
        depths = [d * m for d, m in zip(depths, masks)]

    depths = np.stack(depths)
    center = np.zeros(3)
    half = args.volume_size / 2
    vol = make_volume(
        origin=center - half,
        size_xyz=(args.volume_size,) * 3,
        voxel_size=args.voxel_size,
        device=renderer.device,
    )
    vol = integrate_frames(
        vol, depths, np.stack(colors), np.asarray(intr, np.float32),
        np.stack(w2cs), sdf_trunc=args.sdf_trunc,
    )
    tsdf, weights, vcolors = (x.cpu().numpy()
                              for x in (vol.tsdf, vol.weights, vol.colors))
    origin = vol.origin.cpu().numpy()
    if args.meshing == "poisson":
        # screened-Poisson indicator backend (reference exporter.py:216-325
        # open3d Poisson option, re-formulated on the TSDF grid)
        from gstk_torch.exporter.poisson import poisson_mesh

        verts, faces, vcols = poisson_mesh(
            tsdf, weights, vcolors, origin=origin, voxel_size=vol.voxel_size,
            iters=args.poisson_iters, device=renderer.device,
        )
    else:
        verts, faces, vcols = marching_tetrahedra(
            tsdf, weights, vcolors, origin=origin, voxel_size=vol.voxel_size,
        )
    if args.clean:
        # pymeshlab-analog cleanup (small components + smoothing)
        from gstk_torch.exporter.poisson import clean_mesh

        verts, faces, vcols = clean_mesh(
            verts, faces, vcols, smooth_iters=args.smooth_iters
        )
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    write_mesh_ply(out_dir / "tsdf_mesh.ply", verts, faces, vcols)
    print(
        f"TSDF mesh ({args.meshing}): {len(verts)} "
        f"vertices, {len(faces)} faces -> {out_dir / 'tsdf_mesh.ply'}"
    )


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("gs-export")
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p):
        p.add_argument("--load-config", type=Path, required=True)
        p.add_argument("--output-dir", type=Path, required=True)
        p.add_argument("--device", default=None,
                       help="torch device (default cuda; cpu runs the plain "
                            "twins)")

    p = sub.add_parser("gaussian-splat")
    common(p)
    p.set_defaults(fn=export_gaussian_splat)
    p = sub.add_parser("camera-poses")
    common(p)
    p.set_defaults(fn=export_camera_poses)
    p = sub.add_parser("point-cloud")
    common(p)
    p.add_argument("--num-points", type=int, default=1_000_000)
    p.set_defaults(fn=export_point_cloud)
    p = sub.add_parser("offline-tsdf")
    p.add_argument(
        "--meshing", choices=["tetra", "poisson"], default="tetra",
        help="isosurface backend: marching tetrahedra on the raw TSDF, or "
        "the screened-Poisson indicator (exporter/poisson.py)",
    )
    p.add_argument("--poisson-iters", type=int, default=200)
    p.add_argument(
        "--clean", action="store_true",
        help="drop small components + smooth (pymeshlab-analog cleanup)",
    )
    p.add_argument("--smooth-iters", type=int, default=0)
    p.add_argument(
        "--mask-method", default="none",
        choices=["none", "threshold", "box", "grounded_sam"],
        help="object isolation before fusion; grounded_sam needs local "
        "GroundingDINO+SAM checkpoints (docs/WEIGHTS.md)",
    )
    p.add_argument("--prompt", type=str, default=None,
                   help="text prompt for grounded_sam masking")
    p.add_argument("--mask-box", type=float, nargs=4, default=None,
                   help="normalized x0 y0 x1 y1 for --mask-method box")
    p.add_argument("--propagate-masks", action="store_true",
                   help="temporally consolidate per-frame masks along the "
                        "trajectory (optical-flow forward/backward chains "
                        "+ majority vote — the DEVA role in the reference's "
                        "DINO+SAM+DEVA chain)")
    common(p)
    p.add_argument("--voxel-size", type=float, default=0.01)
    p.add_argument("--volume-size", type=float, default=2.0)
    p.add_argument("--sdf-trunc", type=float, default=0.04)
    p.set_defaults(fn=export_offline_tsdf)
    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
