"""LPIPS perceptual metric (VGG16 backbone, learned linear heads; port of
``gstk_tpu/utils/lpips.py``).

A function over a parameter dict of tensors, so it runs on the card inside
the eval loop. The pretrained weights are not bundled: load them with
:func:`load_lpips_params` from an ``.npz`` with keys ``conv{i}_w`` /
``conv{i}_b`` (13 VGG16 convolutions, OIHW) and ``lin{j}_w`` (5 LPIPS 1x1
heads, (C,)), or convert torchvision + lpips state dicts with
:func:`params_from_torch`.

Architecture (LPIPS v0.1, VGG variant): images in [0, 1] are scaled and
shifted by the ImageNet normalization, run through VGG16's features, tapped
after relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3; each tap is
normalized over its channels, squared-differenced, weighted by a
non-negative 1x1 head, averaged over space and summed over the taps.

The convolutions run in f32 whatever the global TF32 flags say
(:func:`gstk_torch.utils.losses.f32_convolutions`).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from gstk_torch import DeviceLike, resolve_device
from gstk_torch.utils.losses import f32_convolutions

# VGG16 conv plan: (out_channels, pool_before) per conv layer
_VGG_PLAN = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
# conv indices (0-based) after which LPIPS taps features (relu1_2, relu2_2,
# relu3_3, relu4_3, relu5_3)
_TAPS = [1, 3, 6, 9, 12]

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def random_lpips_params(seed: int = 0, in_ch: int = 3,
                        device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random parameters in the npz layout, drawn with numpy from ``seed``
    (testing and shape checks only: not a perceptual metric)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    params = {}
    c_in = in_ch
    for i, (c_out, _) in enumerate(_VGG_PLAN):
        params[f"conv{i}_w"] = (
            rng.standard_normal((c_out, c_in, 3, 3)) * 0.05
        ).astype(np.float32)
        params[f"conv{i}_b"] = np.zeros((c_out,), np.float32)
        c_in = c_out
    for j, conv_i in enumerate(_TAPS):
        c = _VGG_PLAN[conv_i][0]
        params[f"lin{j}_w"] = (np.abs(rng.standard_normal(c)) / c).astype(
            np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in params.items()}


def load_lpips_params(path, device: DeviceLike = None
                      ) -> Dict[str, torch.Tensor]:
    """The parameter dict from an .npz (see the module docstring), as f32
    tensors on ``device``."""
    device = resolve_device(device)
    with np.load(path) as data:
        return {k: torch.tensor(np.asarray(data[k], np.float32), device=device)
                for k in data.files}


def params_from_torch(vgg_state, lpips_state) -> Dict[str, np.ndarray]:
    """Convert torchvision ``vgg16().features.state_dict()`` and an lpips
    ``lin`` state dict ({'lin{j}.model.1.weight': (1,C,1,1)}) to the npz
    layout (numpy copies)."""
    host = lambda x: (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else np.array(x))
    out = {}
    conv_keys = sorted(
        {k.split(".")[0] for k in vgg_state if k.endswith(".weight")},
        key=int,
    )
    for i, k in enumerate(conv_keys):
        out[f"conv{i}_w"] = host(vgg_state[f"{k}.weight"])
        out[f"conv{i}_b"] = host(vgg_state[f"{k}.bias"])
    for j in range(len(_TAPS)):
        w = host(lpips_state[f"lin{j}.model.1.weight"])
        out[f"lin{j}_w"] = w.reshape(-1)
    return out


def _vgg_features(params, x: torch.Tensor) -> List[torch.Tensor]:
    """x: (H, W, 3) normalized; the tapped feature maps, each (C, H', W')."""
    feats = []
    h = x.permute(2, 0, 1)[None]  # NCHW
    for i, (_, pool) in enumerate(_VGG_PLAN):
        if pool:  # 2x2 stride 2, VALID: odd sizes are floored
            h = F.max_pool2d(h, 2, 2)
        h = F.conv2d(h, params[f"conv{i}_w"], padding=1) + params[
            f"conv{i}_b"][:, None, None]
        h = F.relu(h)
        if i in _TAPS:
            feats.append(h[0])
    return feats


def lpips(params, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """LPIPS distance between two (H, W, 3) images in [0, 1] on one
    device."""
    dev = img0.device
    shift = torch.from_numpy(_SHIFT).to(dev)
    scale = torch.from_numpy(_SCALE).to(dev)

    def norm_in(x):
        # divided by a device tensor: on the card a division by a host
        # value runs as a multiplication by its reciprocal
        return (x * 2.0 - 1.0 - shift) / scale

    with f32_convolutions():
        f0 = _vgg_features(params, norm_in(img0))
        f1 = _vgg_features(params, norm_in(img1))
    total = img0.new_zeros(())
    for j, (a, b) in enumerate(zip(f0, f1)):
        na = a / (torch.linalg.norm(a, dim=0, keepdim=True) + 1e-10)
        nb = b / (torch.linalg.norm(b, dim=0, keepdim=True) + 1e-10)
        d = (na - nb) ** 2  # (C, H', W')
        total = total + torch.mean(
            torch.sum(d * params[f"lin{j}_w"][:, None, None], dim=0)
        )
    return total
