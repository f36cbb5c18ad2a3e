"""Per-view achievable-PSNR ceiling of the raytraced dataset's own GT (port
of ``tools/analyze_gt_aliasing.py``).

The serial generator at its default traces ONE ray per pixel (pixel
centres, no supersampling) over hard-edged procedural textures (checker
ground plane). At grazing incidence the texture frequency crosses Nyquist
and the 1-spp GT contains view-incoherent speckle that NO smooth scene
representation can reproduce. A supersampled render of the same analytic
scene is the band-limited image a perfect smooth model would converge to,
so

    ceiling(view) ~= PSNR(gt_1spp, gt_supersampled)

upper-bounds any splat model's achievable PSNR against the 1-spp GT. This
tool computes that ceiling for every eval view and prints it next to the
model's achieved per-view PSNR (a gs-eval JSON) — separating "method
limitation" from "dataset aliasing" in the quality roofline
(docs/RESULTS_240_30K.md). ``--save`` writes the supersampled eval GTs
that :mod:`gstk_torch.tools.eval_vs_supersampled` scores against.

The views are shaded by :mod:`gstk_torch.data.raytraced` on ``--device``
(``cuda`` unless given); the scores are numpy on the host.

Usage: python -m gstk_torch.tools.analyze_gt_aliasing [SS] [--save] \\
           [--eval-json runs/eval_240_30k.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from gstk_torch import resolve_device
from gstk_torch.data.raytraced import build_scene, camera_dirs, shade, view_pose


def render(objs, c2w, w, h, fx, cx, cy, ss, device):
    """ss x ss stratified supersampled render, box-filtered to (h, w):
    (rgb (h, w, 3), hit fraction (h, w)), float64 numpy."""
    dirs = camera_dirs(w, h, fx, cx, cy, ss)
    subs = dirs[1:] if ss > 1 else dirs  # the pixel centres at ss 1
    n = h * w
    d = torch.from_numpy(
        np.concatenate([sd @ c2w[:3, :3].T for sd in subs])).to(device)
    o = torch.as_tensor(c2w[:3, 3], dtype=torch.float64,
                        device=device).expand(d.shape)
    rgb_all, _, hit_all = shade(objs, o, d)
    acc = torch.zeros((n, 3), dtype=torch.float64, device=device)
    alpha = torch.zeros(n, dtype=torch.float64, device=device)
    for k in range(len(subs)):
        acc += rgb_all[k * n:(k + 1) * n]
        alpha += hit_all[k * n:(k + 1) * n].to(torch.float64)
    m = len(subs)
    return ((acc / m).reshape(h, w, 3).cpu().numpy(),
            (alpha / m).reshape(h, w).cpu().numpy())


def ceiling(img1, a1, imgS, aS):
    """PSNR of the quantized 1-spp GT against the supersampled one, both
    composited over black as the eval composites alpha GT; and the
    supersampled GT."""
    gt1 = np.rint(img1 * 255) / 255.0 * (a1 >= 0.5)[..., None]
    gtS = imgS * aS[..., None]
    mse = np.mean((gt1 - gtS) ** 2)
    return -10 * np.log10(max(mse, 1e-10)), gtS


def main(argv=None) -> list:
    """Print the table; returns its rows (eval index, frame, ring,
    ceiling PSNR, achieved PSNR)."""
    ap = argparse.ArgumentParser("analyze_gt_aliasing")
    ap.add_argument("ss", nargs="?", type=int, default=3)
    ap.add_argument("--save", action="store_true")
    ap.add_argument("--eval-json", type=Path,
                    default=Path("runs/eval_240_30k.json"))
    ap.add_argument("--save-path", type=Path,
                    default=Path("runs/gtS_eval.npz"))
    ap.add_argument("--n-views", type=int, default=240)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--eval-views", type=int, default=30)
    ap.add_argument("--eval-interval", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n_views, w, h, ss = args.n_views, args.width, args.height, args.ss
    fov_deg = 40.0
    fx = 0.5 * w / np.tan(np.radians(fov_deg) / 2)
    cx, cy = w / 2.0, h / 2.0
    objs = build_scene()

    achieved = None
    if args.eval_json.exists():
        achieved = json.loads(args.eval_json.read_text())["per_image"]["psnr"]

    # quantized 1-spp render == the 1-spp GT (uint8 PNG); compare the
    # supersampled reference against the same uint8 quantization the
    # model trains on. Composite both over black like the eval path with
    # a black background and alpha GT.
    rows, saved = [], []
    print(f"{'eval':>4s} {'frame':>5s} {'ring':>4s} {'ceilPSNR':>8s} "
          f"{'achieved':>8s}")
    for ei in range(args.eval_views):
        i = ei * args.eval_interval
        ring = i % 3
        c2w = view_pose(i, n_views)
        img1, a1 = render(objs, c2w, w, h, fx, cx, cy, 1, device)
        imgS, aS = render(objs, c2w, w, h, fx, cx, cy, ss, device)
        ceil, gtS = ceiling(img1, a1, imgS, aS)
        if args.save:
            saved.append(gtS.astype(np.float32))
        ach = achieved[ei] if achieved else float("nan")
        rows.append((ei, i, ring, float(ceil), float(ach)))
        print(f"{ei:4d} {i:5d} {ring:4d} {ceil:8.2f} {ach:8.2f}")

    arr = np.array([[r[2], r[3], r[4]] for r in rows])
    for ring in (0, 1, 2):
        m = arr[:, 0] == ring
        if m.any():
            print(f"ring {ring}: ceiling mean {arr[m, 1].mean():.2f}  "
                  f"achieved mean {arr[m, 2].mean():.2f}")
    print(f"all: ceiling mean {arr[:, 1].mean():.2f}  "
          f"achieved mean {arr[:, 2].mean():.2f}")
    if args.save:
        args.save_path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(args.save_path, gts=np.stack(saved), ss=ss)
        print(f"saved supersampled eval GTs -> {args.save_path}")
    return rows


if __name__ == "__main__":
    main()
