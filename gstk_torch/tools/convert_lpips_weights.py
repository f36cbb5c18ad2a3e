"""Convert locally-supplied torch VGG16 + LPIPS checkpoints to the npz
format the port's LPIPS consumes (:mod:`gstk_torch.utils.lpips`; the same
npz as gstk_tpu's). The port of ``tools/convert_lpips_weights.py``, with
no jax: it converts through :func:`gstk_torch.utils.lpips.params_from_torch`
and runs its self-test on ``--device`` (``cuda`` unless given).

Accepted inputs (any combination):
  --vgg:   torchvision ``vgg16().features`` state dict (``.pth``), OR omit
           to pull it from an installed torchvision with cached weights.
  --lpips: the official LPIPS repo's ``lin`` head checkpoint (vgg.pth from
           richzhang/PerceptualSimilarity, keys ``lin{j}.model.1.weight``),
           OR a full lpips-package state dict whose keys are prefixed
           (``lins.{j}.model.1.weight`` / ``net.slice...``) — prefixes are
           normalized.

Every tensor is shape-checked against the VGG16 plan before writing; a
mismatched checkpoint fails loudly instead of producing a silently-wrong
metric. See docs/WEIGHTS.md.

Usage:
  python -m gstk_torch.tools.convert_lpips_weights --lpips lpips_vgg.pth \\
      [--vgg vgg16_features.pth] --out lpips_vgg16.npz [--device cpu]
  python -m gstk_torch.scripts.eval ... --lpips-weights lpips_vgg16.npz
"""

import argparse

import numpy as np
import torch

# (out_channels, in_channels) of the 13 VGG16 convs; taps after ReLU 1_2,
# 2_2, 3_3, 4_3, 5_3 with head widths below (lpips.py contract)
VGG_CONVS = [
    (64, 3), (64, 64),
    (128, 64), (128, 128),
    (256, 128), (256, 256), (256, 256),
    (512, 256), (512, 512), (512, 512),
    (512, 512), (512, 512), (512, 512),
]
HEAD_WIDTHS = [64, 128, 256, 512, 512]


def _load_state(path):
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: v for k, v in obj.items()}


def _normalize_lpips_keys(state):
    """Map lins.{j}... / lin{j}... variants onto lin{j}.model.1.weight."""
    out = {}
    for k, v in state.items():
        k2 = k
        if k2.startswith("lins."):
            j = k2.split(".")[1]
            k2 = f"lin{j}." + ".".join(k2.split(".")[2:])
        if k2.startswith("lin") and k2.endswith("weight"):
            j = k2[3]
            out[f"lin{j}.model.1.weight"] = v
    return out


def _extract_vgg_from_lpips(state):
    """Pull net.slice{n}.{idx}.weight tensors (lpips package layout) into a
    torchvision-features-style dict keyed by layer index."""
    out = {}
    for k, v in state.items():
        if ".slice" in k and (k.endswith("weight") or k.endswith("bias")):
            idx = k.split(".")[-2]
            out[f"{idx}.{k.split('.')[-1]}"] = v
    return out


def main(argv=None) -> float:
    """Convert and self-test; returns lpips(black, white)."""
    from gstk_torch import resolve_device
    from gstk_torch.utils.lpips import load_lpips_params, lpips, params_from_torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--vgg", default=None, help="vgg16 features .pth")
    ap.add_argument("--lpips", required=True, help="lpips lin-heads .pth")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None,
                    help="torch device of the self-test (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    raw = _load_state(args.lpips)
    lpips_state = _normalize_lpips_keys(raw)
    if len(lpips_state) != len(HEAD_WIDTHS):
        raise SystemExit(
            f"expected {len(HEAD_WIDTHS)} lin heads, found "
            f"{sorted(lpips_state)} in {args.lpips}"
        )

    if args.vgg:
        vgg_state = _load_state(args.vgg)
    else:
        vgg_state = _extract_vgg_from_lpips(raw)
        if not vgg_state:
            try:
                from torchvision.models import vgg16

                vgg_state = vgg16(weights="IMAGENET1K_V1").features.state_dict()
            except Exception as e:
                raise SystemExit(
                    "no VGG features in the lpips checkpoint and torchvision "
                    f"weights unavailable ({e}); pass --vgg explicitly"
                )

    # shape validation against the plan
    conv_keys = sorted(
        {k.split(".")[0] for k in vgg_state if k.endswith(".weight")},
        key=int,
    )
    if len(conv_keys) != len(VGG_CONVS):
        raise SystemExit(
            f"expected {len(VGG_CONVS)} convs, found {len(conv_keys)}"
        )
    for i, k in enumerate(conv_keys):
        w = np.asarray(vgg_state[f"{k}.weight"])
        want = (VGG_CONVS[i][0], VGG_CONVS[i][1], 3, 3)
        if w.shape != want:
            raise SystemExit(f"conv{i} weight shape {w.shape} != {want}")
    for j, c in enumerate(HEAD_WIDTHS):
        w = np.asarray(lpips_state[f"lin{j}.model.1.weight"])
        if int(np.prod(w.shape)) != c:
            raise SystemExit(f"lin{j} head has {w.size} weights, expected {c}")

    out = params_from_torch(vgg_state, lpips_state)
    np.savez(args.out, **out)
    print(f"wrote {args.out} ({len(out)} arrays)")

    # round-trip sanity: loads and runs on a tiny image on the device
    params = load_lpips_params(args.out, device)
    v = float(lpips(params, torch.zeros((64, 64, 3), device=device),
                    torch.ones((64, 64, 3), device=device)))
    print(f"self-test lpips(black, white) = {v:.4f} on {device}")
    return v


if __name__ == "__main__":
    main()
