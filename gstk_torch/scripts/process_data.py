"""gs-process-data for gstk_torch: raw images -> training dataset (port of
``gstk_tpu/scripts/process_data.py``).

    python -m gstk_torch.scripts.process_data images --data <img_dir> \
        --output-dir <out> [--skip-colmap] [--mono-depth-data <dir>] ...

The flags are gstk_tpu's, plus ``--device`` for the depth model of
``--using-est-depth`` (``cuda`` unless given). PNG inputs need neither
Pillow nor OpenCV.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> None:
    from gstk_torch.process_data.pipeline import ProcessConfig, process_images

    parser = argparse.ArgumentParser("gs-process-data")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("images")
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--num-downscales", type=int, default=3)
    p.add_argument("--camera-model", type=str, default="OPENCV")
    p.add_argument("--depth-data", type=Path, default=None)
    p.add_argument("--mono-depth-data", type=Path, default=None)
    p.add_argument("--skip-colmap", action="store_true")
    p.add_argument(
        "--matching-method", type=str, default="sequential",
        choices=["sequential", "exhaustive"],
    )
    p.add_argument("--gpu", action="store_true")
    p.add_argument(
        "--using-est-depth", action="store_true",
        help="run monocular depth estimation (needs a real depth model; "
        "see docs/WEIGHTS.md)",
    )
    p.add_argument("--depth-method", type=str, default="auto")
    p.add_argument(
        "--sfm-backend", type=str, default="auto",
        choices=["auto", "hloc", "colmap"],
    )
    p.add_argument("--feature-type", type=str, default="superpoint_aachen")
    p.add_argument("--matcher-type", type=str, default="superglue")
    p.add_argument("--sift-max-features", type=int, default=8192)
    p.add_argument(
        "--allow-toy-depth", action="store_true",
        help="knowingly use the placeholder gradient depth (tests only)",
    )
    p.add_argument(
        "--device", type=str, default=None,
        help="device of a local depth checkpoint (default: cuda)",
    )
    args = parser.parse_args(argv)

    process_images(
        ProcessConfig(
            data=args.data,
            output_dir=args.output_dir,
            num_downscales=args.num_downscales,
            camera_model=args.camera_model,
            depth_data=args.depth_data,
            mono_depth_data=args.mono_depth_data,
            using_est_depth=args.using_est_depth,
            depth_method=args.depth_method,
            allow_toy_depth=args.allow_toy_depth,
            skip_colmap=args.skip_colmap,
            colmap_matcher=args.matching_method,
            gpu=args.gpu,
            sfm_backend=args.sfm_backend,
            feature_type=args.feature_type,
            matcher_type=args.matcher_type,
            sift_max_features=args.sift_max_features,
            device=args.device,
        )
    )


if __name__ == "__main__":
    main()
