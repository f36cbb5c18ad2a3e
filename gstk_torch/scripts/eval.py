"""gs-eval for gstk_torch: PSNR / SSIM / (LPIPS) over the eval split -> JSON
(port of ``gstk_tpu/scripts/eval.py``).

    python -m gstk_torch.scripts.eval --load-config <run>/config.yml [--device cpu] [...]

The flags are gstk_tpu's, plus ``--device`` (default ``cuda``; without a
card and without ``--device`` it raises). Loads the saved config and the
latest checkpoint, renders every view of the split on the eval background
and writes a JSON with the mean metrics, fps, rays/s and the per-view PSNR
and SSIM. By default the views are scored on the device
(:func:`batched_eval`, the trainer's own scoring function);
``--force-host-loop`` renders each view to numpy and scores it there.
LPIPS needs VGG16 + LPIPS weights (``--lpips-weights`` or
``$GSTK_LPIPS_WEIGHTS``); without them a torchvision proxy is tried and,
where torchvision or its weights are absent, LPIPS is reported as null.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch


def compute_lpips(pairs, weights_path=None, device=None):
    """Optional LPIPS over (gt, pred) numpy pairs. With ``weights_path`` (or
    $GSTK_LPIPS_WEIGHTS) the VGG + learned-heads LPIPS of
    :mod:`gstk_torch.utils.lpips` runs on ``device``; otherwise a
    torchvision-feature proxy, or None when torchvision or its weights are
    absent."""
    weights_path = weights_path or os.environ.get("GSTK_LPIPS_WEIGHTS")
    if weights_path:
        from gstk_torch.utils.lpips import load_lpips_params, lpips

        params = load_lpips_params(weights_path, device)
        dev = next(iter(params.values())).device
        with torch.no_grad():
            return float(np.mean([
                float(lpips(params, torch.from_numpy(np.asarray(gt)).to(dev),
                            torch.from_numpy(np.asarray(pred)).to(dev)))
                for gt, pred in pairs
            ]))
    try:
        from torchvision.models import vgg16

        net = vgg16(weights="IMAGENET1K_V1").features.eval()
    except Exception:
        return None

    vals = []
    with torch.no_grad():
        for gt, pred in pairs:
            a = torch.from_numpy(gt).permute(2, 0, 1)[None] * 2 - 1
            b = torch.from_numpy(pred).permute(2, 0, 1)[None] * 2 - 1
            fa, fb, loss = a, b, 0.0
            for layer in net:
                fa, fb = layer(fa), layer(fb)
                if isinstance(layer, torch.nn.ReLU):
                    na = fa / (fa.norm(dim=1, keepdim=True) + 1e-10)
                    nb = fb / (fb.norm(dim=1, keepdim=True) + 1e-10)
                    loss = loss + ((na - nb) ** 2).mean().item()
            vals.append(loss)
    return float(np.mean(vals))


def batched_eval(renderer, frames, lpips_params=None, return_preds=False):
    """The split scored on the renderer's device, one view after another,
    with one fetch of the stacked scalars at the end
    (:func:`gstk_torch.train.trainer.score_views`): render, PSNR, SSIM and,
    with ``lpips_params``, LPIPS. ``return_preds`` also returns the stacked
    (n, H, W, 3) predictions in one transfer, for the host-side LPIPS
    proxy. Returns numpy ``(psnrs, ssims, lpips or None, preds or
    None)``."""
    from gstk_torch.train.trainer import score_views

    def render(frame):
        h, w = frame.image.shape[:2]
        return renderer.render(frame.c2w, frame.fx, frame.fy, frame.cx,
                               frame.cy, h, w)["rgb"]

    with torch.no_grad():
        return score_views(render, frames, renderer.background, lpips_params,
                           return_preds)


def main(argv=None) -> dict:
    """Evaluate; returns the results written to ``--output-path``."""
    from gstk_torch.configs.serialize import load_config
    from gstk_torch.data.datamanager import FullImageDatamanager
    from gstk_torch.models.vanilla import composite_gt_with_background
    from gstk_torch.render.renderer import Renderer
    from gstk_torch.utils import losses
    from gstk_torch.utils.colors import EVAL_BACKGROUND

    parser = argparse.ArgumentParser("gs-eval")
    parser.add_argument("--load-config", type=Path, required=True)
    parser.add_argument("--output-path", type=Path, default=Path("eval.json"))
    parser.add_argument("--skip-lpips", action="store_true")
    parser.add_argument("--lpips-weights", type=Path, default=None,
                        help="npz with VGG16+LPIPS weights (utils/lpips.py)")
    parser.add_argument("--force-host-loop", action="store_true",
                        help="render each view to numpy and score it there "
                             "instead of on the device (parity debugging)")
    parser.add_argument("--split", choices=("eval", "train"), default="eval",
                        help="which split to evaluate. 'train' is a "
                             "diagnostic: train-split PSNR ~= the trainer's "
                             "logged train PSNR rules out eval-path bugs "
                             "when analyzing train-eval gaps")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; cpu runs the "
                             "plain twins)")
    args = parser.parse_args(argv)

    config = load_config(args.load_config)
    run_dir = args.load_config.parent
    # the trainer's fixed eval background and compositing chunk (which the
    # plain twins walk), so gs-eval reproduces the trainer's eval numbers
    renderer = Renderer(run_dir / "ckpts", model_config=config.model,
                        background=EVAL_BACKGROUND, device=args.device)
    renderer.raster_config = dataclasses.replace(
        renderer.raster_config, chunk_size=config.raster_chunk)
    dm = FullImageDatamanager(
        config.dataparser, seed=config.seed,
        splits=("train", "eval") if args.split == "train" else ("eval",),
    )

    frames = dm.eval_frames if args.split == "eval" else dm.train_frames
    weights_path = args.lpips_weights or os.environ.get("GSTK_LPIPS_WEIGHTS")
    bg = np.asarray(EVAL_BACKGROUND, np.float32)
    same_shape = frames and all(
        f.image.shape == frames[0].image.shape for f in frames
    )
    # the device loop for a split of one image shape (the proxy's stacked
    # predictions need one); the host loop for mixed shapes or on request
    device_ok = same_shape and not args.force_host_loop
    t0 = time.perf_counter()
    lpips = None
    if device_ok:
        lpips_params = None
        if weights_path is not None and not args.skip_lpips:
            from gstk_torch.utils.lpips import load_lpips_params

            lpips_params = load_lpips_params(weights_path, renderer.device)
        want_proxy = not args.skip_lpips and lpips_params is None
        psnr_a, ssim_a, lpips_a, preds = batched_eval(
            renderer, frames, lpips_params, return_preds=want_proxy
        )
        psnrs, ssims = list(psnr_a), list(ssim_a)
        if lpips_a is not None:
            lpips = float(np.mean(lpips_a))
        h, w = frames[0].image.shape[:2]
        n_rays = len(frames) * h * w
        dt = time.perf_counter() - t0
        if want_proxy:
            # the host-side proxy, outside the timed render window
            pairs = [(np.asarray(composite_gt_with_background(f.image, bg),
                                 np.float32), pred)
                     for f, pred in zip(frames, preds)]
            lpips = compute_lpips(pairs)
    else:
        psnrs, ssims, pairs = [], [], []
        n_rays = 0
        for frame in frames:
            gt = composite_gt_with_background(frame.image, bg)
            h, w = gt.shape[:2]
            out = renderer.get_output_from_pose(
                frame.c2w, frame.fx, frame.fy, frame.cx, frame.cy, h, w
            )
            mse = float(np.mean((out["rgb"] - gt) ** 2))
            psnrs.append(-10 * np.log10(max(mse, 1e-10)))
            dev = renderer.device
            ssims.append(float(losses.ssim(torch.from_numpy(gt).to(dev),
                                           torch.from_numpy(out["rgb"]).to(dev))))
            pairs.append((gt, out["rgb"]))
            n_rays += h * w
        dt = time.perf_counter() - t0
        lpips = (
            None if args.skip_lpips
            else compute_lpips(pairs, weights_path=args.lpips_weights,
                               device=renderer.device)
        )
    if lpips is None and not args.skip_lpips:
        print(
            "WARNING: LPIPS skipped — no VGG16/LPIPS weights available. "
            "Supply --lpips-weights <npz> or set $GSTK_LPIPS_WEIGHTS "
            "(see docs/WEIGHTS.md).",
            file=sys.stderr,
        )
    results = {
        "experiment_name": config.experiment_name,
        "method_name": config.method_name,
        "checkpoint": str(renderer.step),
        "split": args.split,
        "results": {
            "psnr": float(np.mean(psnrs)) if psnrs else None,
            "ssim": float(np.mean(ssims)) if ssims else None,
            "lpips": lpips,
            "num_images": len(psnrs),
            "fps": len(psnrs) / dt if psnrs else 0.0,
            "num_rays_per_sec": n_rays / dt,
        },
        "per_image": {
            "psnr": [float(v) for v in psnrs],
            "ssim": [float(v) for v in ssims],
        },
    }
    args.output_path.parent.mkdir(parents=True, exist_ok=True)
    args.output_path.write_text(json.dumps(results, indent=2))
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
