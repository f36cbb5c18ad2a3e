"""Colormaps for visualization: depth maps and scalar images (port of
``gstk_tpu/utils/colormaps.py``).

Equivalent of ``gs_toolkit/utils/colormaps.py``: the turbo / grey colormap,
depth normalization and boolean overlays, as torch ops on the input's
device. The turbo table is gstk_tpu's 32 control points, linearly
interpolated.
"""

from __future__ import annotations

import numpy as np
import torch

# 32-entry turbo colormap control points (Google turbo, downsampled); lerped.
_TURBO = np.array(
    [
        [0.19, 0.072, 0.232], [0.217, 0.174, 0.525], [0.225, 0.267, 0.754],
        [0.216, 0.356, 0.920], [0.184, 0.444, 0.998], [0.133, 0.534, 0.993],
        [0.080, 0.624, 0.912], [0.040, 0.708, 0.798], [0.030, 0.783, 0.670],
        [0.083, 0.849, 0.530], [0.205, 0.905, 0.385], [0.364, 0.947, 0.255],
        [0.527, 0.976, 0.158], [0.667, 0.990, 0.098], [0.784, 0.987, 0.074],
        [0.879, 0.961, 0.090], [0.948, 0.913, 0.130], [0.989, 0.845, 0.172],
        [0.999, 0.756, 0.198], [0.988, 0.653, 0.198], [0.957, 0.542, 0.175],
        [0.908, 0.429, 0.135], [0.843, 0.323, 0.092], [0.762, 0.229, 0.056],
        [0.670, 0.152, 0.029], [0.570, 0.092, 0.012], [0.468, 0.051, 0.005],
        [0.372, 0.027, 0.005], [0.288, 0.015, 0.010], [0.219, 0.010, 0.018],
        [0.169, 0.008, 0.026], [0.122, 0.004, 0.028],
    ],
    np.float32,
)


def apply_colormap(x: torch.Tensor, cmap: str = "turbo") -> torch.Tensor:
    """Scalar (H, W) in [0,1] -> (H, W, 3) RGB."""
    if cmap not in ("turbo", "gray"):
        raise ValueError(f"colormap {cmap!r}: turbo or gray")
    if cmap == "gray":
        return x.clamp(0, 1)[..., None].expand(*x.shape, 3).clone()
    table = torch.from_numpy(_TURBO).to(x.device)
    n = table.shape[0]
    t = x.clamp(0.0, 1.0) * (n - 1)
    lo = torch.floor(t).long()
    hi = torch.clamp(lo + 1, max=n - 1)
    frac = (t - lo)[..., None]
    return table[lo] * (1 - frac) + table[hi] * frac


def apply_depth_colormap(
    depth: torch.Tensor,
    accumulation: torch.Tensor = None,
    near: float = None,
    far: float = None,
    cmap: str = "turbo",
) -> torch.Tensor:
    """Depth (H, W) -> colored visualization, normalized to [near, far]
    (defaults: 2nd/98th percentile), faded by accumulation."""
    if near is None:
        near = torch.quantile(depth.reshape(-1), 0.02)
    if far is None:
        far = torch.quantile(depth.reshape(-1), 0.98)
    far_minus_near = torch.as_tensor(far - near, dtype=depth.dtype,
                                     device=depth.device)
    x = (depth - near) / torch.clamp(far_minus_near, min=1e-10)
    img = apply_colormap(x, cmap)
    if accumulation is not None:
        img = img * accumulation[..., None]
    return img


def apply_boolean_colormap(mask: torch.Tensor, true_color=(1.0, 1.0, 1.0),
                           false_color=(0.0, 0.0, 0.0)) -> torch.Tensor:
    t = torch.tensor(true_color, dtype=torch.float32, device=mask.device)
    f = torch.tensor(false_color, dtype=torch.float32, device=mask.device)
    return torch.where(mask[..., None], t, f)
