"""The main-path image losses: L1 and SSIM (port of the first half of
``gstk_tpu/utils/losses.py``).

SSIM has pytorch_msssim's semantics, as the reference models use it
(``SSIM(data_range=1.0, size_average=True, channel=3)``): an 11-tap
Gaussian window with sigma 1.5, K1 = 0.01, K2 = 0.03, valid mode. The window
is applied separably as a depthwise ``F.conv2d`` pair over the five stacked
statistics (x, y, x², y², xy), so the five filters are one pass. gstk_tpu's
matmul / taps toggle (``GSTK_SSIM_FILTER``) chooses between two TPU
lowerings of the same filter and is not ported. The depth-loss zoo comes
with the depth method.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def l1(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean absolute error. Written as a select so that at pred == gt the
    gradient is +1, as ``jnp.abs``'s (``torch.abs`` gives 0 there)."""
    d = pred - gt
    return torch.where(d >= 0, d, -d).mean()


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _filter2d_separable(img: torch.Tensor, win: np.ndarray) -> torch.Tensor:
    """Depthwise separable valid-mode filtering of an (H, W, C) image:
    along W, then along H. Returns (H - size + 1, W - size + 1, C)."""
    c = img.shape[-1]
    size = win.shape[0]
    w = torch.as_tensor(win, dtype=img.dtype, device=img.device)
    x = img.permute(2, 0, 1)[None]  # (1, C, H, W)
    x = F.conv2d(x, w.view(1, 1, 1, size).repeat(c, 1, 1, 1), groups=c)
    x = F.conv2d(x, w.view(1, 1, size, 1).repeat(c, 1, 1, 1), groups=c)
    return x[0].permute(1, 2, 0)


def ssim(
    pred: torch.Tensor,
    gt: torch.Tensor,
    data_range: float = 1.0,
    win_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) image pair (pytorch_msssim semantics)."""
    win = _gaussian_window(win_size, sigma)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    c = pred.shape[-1]
    stacked = torch.cat([pred, gt, pred * pred, gt * gt, pred * gt], dim=-1)
    f = _filter2d_separable(stacked, win)
    mu_x, mu_y = f[..., 0:c], f[..., c:2 * c]
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_xx = f[..., 2 * c:3 * c] - mu_xx
    sigma_yy = f[..., 3 * c:4 * c] - mu_yy
    sigma_xy = f[..., 4 * c:5 * c] - mu_xy
    cs = (2 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ssim_map = ((2 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs
    return ssim_map.mean()
