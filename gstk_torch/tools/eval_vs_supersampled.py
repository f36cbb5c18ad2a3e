"""Score a checkpoint's eval renders against the BAND-LIMITED ground
truth (supersampled analytic re-render,
``python -m gstk_torch.tools.analyze_gt_aliasing --save``) alongside the
1-spp GT it trained on (port of ``tools/eval_vs_supersampled.py``).

The 1-spp GT carries view-incoherent speckle above Nyquist (ceiling
analysis in docs/RESULTS_240_30K.md); a smooth reconstruction that is
CORRECT scores higher against the supersampled reference than against
the aliased GT it trained on. The pair of numbers separates model error
from dataset aliasing:

    PSNR(pred, gt_1spp)  — the conventional (aliasing-polluted) metric
    PSNR(pred, gt_ss)    — fidelity to the actual scene

The renders and the 1-spp scores are gs-eval's
(:class:`gstk_torch.render.Renderer` and ``scripts/eval.py::batched_eval``)
on ``--device`` (``cuda`` unless given).

Usage: python -m gstk_torch.tools.eval_vs_supersampled [CONFIG] \\
           [--gts runs/gtS_eval.npz] [--out runs/eval_vs_ss.json]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

DEFAULT_CONFIG = Path("runs/r4_quality/raytraced240/gaussian-splatting/"
                      "config.yml")


def main(argv=None) -> dict:
    """Print the table and write ``--out``; returns what it wrote."""
    from gstk_torch.configs.serialize import load_config
    from gstk_torch.data.datamanager import FullImageDatamanager
    from gstk_torch.render.renderer import Renderer
    from gstk_torch.scripts.eval import batched_eval
    from gstk_torch.utils import losses
    from gstk_torch.utils.colors import EVAL_BACKGROUND

    ap = argparse.ArgumentParser("eval_vs_supersampled")
    ap.add_argument("config", nargs="?", type=Path, default=DEFAULT_CONFIG)
    ap.add_argument("--gts", type=Path, default=Path("runs/gtS_eval.npz"))
    ap.add_argument("--out", type=Path, default=Path("runs/eval_vs_ss.json"))
    ap.add_argument("--eval-interval", type=int, default=8,
                    help="the split's interval: eval view i is frame "
                         "i * interval, whose ring is the frame mod 3")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    config = load_config(args.config)
    renderer = Renderer(args.config.parent / "ckpts",
                        model_config=config.model,
                        background=EVAL_BACKGROUND, device=args.device)
    dm = FullImageDatamanager(config.dataparser, seed=config.seed,
                              splits=("eval",))
    frames = dm.eval_frames
    psnr1, ssim1, _, preds = batched_eval(renderer, frames, None,
                                          return_preds=True)
    gtS = np.load(args.gts)["gts"]
    assert gtS.shape[0] == len(frames), (gtS.shape, len(frames))

    dev = renderer.device
    print(f"{'eval':>4s} {'ring':>4s} {'vs1spp':>7s} {'vsSS':>7s} "
          f"{'ssimSS':>7s}")
    rows = []
    for i, (p1, pred) in enumerate(zip(psnr1, preds)):
        ring = (i * args.eval_interval) % 3
        mse = float(np.mean((pred - gtS[i]) ** 2))
        pS = -10 * np.log10(max(mse, 1e-10))
        sS = float(losses.ssim(torch.from_numpy(gtS[i]).to(dev),
                               torch.from_numpy(pred).to(dev)))
        rows.append((ring, float(p1), pS, sS))
        print(f"{i:4d} {ring:4d} {float(p1):7.2f} {pS:7.2f} {sS:7.4f}")
    arr = np.array(rows)
    for ring in (0, 1, 2):
        m = arr[:, 0] == ring
        if m.any():
            print(f"ring {ring}: vs1spp {arr[m, 1].mean():6.2f}  "
                  f"vsSS {arr[m, 2].mean():6.2f}  "
                  f"ssimSS {arr[m, 3].mean():.4f}")
    print(f"all: vs1spp {arr[:, 1].mean():6.2f}  vsSS {arr[:, 2].mean():6.2f}  "
          f"ssimSS {arr[:, 3].mean():.4f}")
    out = {
        "per_image": {"psnr_vs_1spp": arr[:, 1].tolist(),
                      "psnr_vs_ss": arr[:, 2].tolist(),
                      "ssim_vs_ss": arr[:, 3].tolist()},
        "mean_psnr_vs_1spp": float(arr[:, 1].mean()),
        "mean_psnr_vs_ss": float(arr[:, 2].mean()),
        "mean_ssim_vs_ss": float(arr[:, 3].mean()),
    }
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
