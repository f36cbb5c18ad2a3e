"""The image losses, L1 and SSIM, and the depth-supervision loss zoo (port
of ``gstk_tpu/utils/losses.py``).

SSIM has pytorch_msssim's semantics, as the reference models use it
(``SSIM(data_range=1.0, size_average=True, channel=3)``): an 11-tap
Gaussian window with sigma 1.5, K1 = 0.01, K2 = 0.03, valid mode. The window
is applied separably as a depthwise ``F.conv2d`` pair over the five stacked
statistics (x, y, x², y², xy), so the five filters are one pass. gstk_tpu's
matmul / taps toggle (``GSTK_SSIM_FILTER``) chooses between two TPU
lowerings of the same filter and is not ported.

The zoo (:func:`total_variation` to :func:`edge_aware_smooth_loss`) takes
every differentiated ``|x|`` as :func:`_abs`, whose gradient at 0 is +1 as
``jnp.abs``'s: ties occur there (masked depths are both 0, the background
fill is one constant). The Pearson and planar patch origins are drawn from
a ``torch.Generator`` (x first, then y), or given as ``origins=(x0, y0)``;
a patch that would cross the map's edge is moved inside it, as
``lax.dynamic_slice`` moves it.

The convolutions run in f32 whatever the global flags say
(:func:`f32_convolutions`): cuDNN's default ``allow_tf32=True`` would round
their inputs to TF32 on the card, where gstk_tpu computes them in f32.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` as a select, so that its gradient at 0 is +1, as
    ``jnp.abs``'s (``torch.abs`` gives 0 there)."""
    return torch.where(x >= 0, x, -x)


def l1(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean absolute error (gradient +1 where pred == gt)."""
    return _abs(pred - gt).mean()


@contextlib.contextmanager
def f32_convolutions():
    """cuDNN convolutions in f32 (no TF32) inside the block; the global
    flag is restored on exit."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


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
    with f32_convolutions():
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


def total_variation(x: torch.Tensor) -> torch.Tensor:
    """TV loss on an (H, W) or (H, W, C) map."""
    dh = _abs(x[1:, ...] - x[:-1, ...]).mean()
    dw = _abs(x[:, 1:, ...] - x[:, :-1, ...]).mean()
    return dh + dw


def depth_l1(pred: torch.Tensor, gt: torch.Tensor,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean L1 over the valid pixels (nonzero GT depth by default)."""
    if valid is None:
        valid = gt > 0
    valid = valid.to(pred.dtype)
    denom = torch.clamp(valid.sum(), min=1.0)
    return (_abs(pred - gt) * valid).sum() / denom


def _pearson_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1 - Pearson correlation of each row of (n, k) ``a`` and ``b``."""
    a = a - a.mean(-1, keepdim=True)
    b = b - b.mean(-1, keepdim=True)
    denom = torch.sqrt((a * a).sum(-1) * (b * b).sum(-1)) + 1e-8
    return 1.0 - (a * b).sum(-1) / denom


def pearson_corr_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """1 - Pearson correlation between the flattened maps."""
    return _pearson_rows(pred.reshape(1, -1), gt.reshape(1, -1))[0]


Origins = Tuple[torch.Tensor, torch.Tensor]


def patch_origins(n: int, size: int, shape, generator: torch.Generator,
                  device) -> Origins:
    """``n`` random (x0, y0) patch origins for ``size`` x ``size`` patches
    of an (H, W) map, as ``jax.random.randint`` bounds them: x0 in [0,
    max(W - size, 1)), then y0 in [0, max(H - size, 1)), int64 on
    ``device``."""
    if generator is None:
        raise ValueError("random patch origins need a generator")
    h, w = shape[:2]
    x0 = torch.randint(0, max(w - size, 1), (n,), generator=generator,
                       device=device)
    y0 = torch.randint(0, max(h - size, 1), (n,), generator=generator,
                       device=device)
    return x0, y0


def _inside(origins: Origins, x: torch.Tensor, size: int) -> Origins:
    """``origins`` moved so that their patches lie inside the (H, W) map
    ``x``, as ``lax.dynamic_slice`` moves a slice."""
    h, w = x.shape[:2]
    return (torch.clamp(origins[0].to(x.device).long(), 0, max(w - size, 0)),
            torch.clamp(origins[1].to(x.device).long(), 0, max(h - size, 0)))


def _patches(x: torch.Tensor, origins: Origins, size: int) -> torch.Tensor:
    """(n, size, size) patches of the (H, W) map ``x`` at ``origins``."""
    x0, y0 = _inside(origins, x, size)
    r = torch.arange(size, device=x.device)
    return x[(y0[:, None] + r)[:, :, None], (x0[:, None] + r)[:, None, :]]


def local_pearson_loss(
    pred: torch.Tensor, gt: torch.Tensor, box_size: int = 64,
    n_boxes: int = 8, generator: Optional[torch.Generator] = None,
    origins: Optional[Origins] = None,
) -> torch.Tensor:
    """Mean Pearson loss over ``n_boxes`` square boxes at ``origins``, or
    at origins drawn from ``generator``."""
    if origins is None:
        origins = patch_origins(n_boxes, box_size, pred.shape, generator,
                                pred.device)
    p = _patches(pred, origins, box_size).reshape(len(origins[0]), -1)
    g = _patches(gt, origins, box_size).reshape(len(origins[0]), -1)
    return _pearson_rows(p, g).mean()


def log_depth_gradient_loss(
    pred_depth: torch.Tensor, gt_depth: torch.Tensor, gt_img: torch.Tensor,
    mono_scale, mono_shift,
) -> torch.Tensor:
    """Scale/shift-corrected log-L1, ``log(1 + |gt - (s pred + c)|)``,
    weighted by ``exp(-|dI|)`` of the image along x and y."""
    scaled = mono_scale * pred_depth + mono_shift
    logl1 = torch.log1p(_abs(gt_depth - scaled))
    gx = torch.exp(-_abs(gt_img[:, :-1, :] - gt_img[:, 1:, :]).mean(-1))
    gy = torch.exp(-_abs(gt_img[:-1, :, :] - gt_img[1:, :, :]).mean(-1))
    return (gx * logl1[:, :-1]).mean() + (gy * logl1[:-1, :]).mean()


def local_planar_loss(
    depth: torch.Tensor, fx, fy, cx, cy,
    generator: Optional[torch.Generator] = None, patch_size: int = 32,
    n_patches: int = 16, origins: Optional[Origins] = None,
) -> torch.Tensor:
    """Planarity prior: each patch's points (``u d``, ``v d``, ``d``) get a
    least-squares plane (the eigenvector of the smallest eigenvalue of their
    centred covariance, plus 1e-12 I), and the loss is the mean
    point-to-plane distance over the patches (gstk_tpu's closed-form
    stand-in for the reference's RANSAC fit)."""
    if origins is None:
        origins = patch_origins(n_patches, patch_size, depth.shape, generator,
                                depth.device)
    d = _patches(depth, origins, patch_size)  # (n, p, p)
    r = torch.arange(patch_size, device=depth.device)
    x0, y0 = _inside(origins, depth, patch_size)
    u = ((x0[:, None, None] + r[None, None, :]).to(depth.dtype) - cx) / fx
    v = ((y0[:, None, None] + r[None, :, None]).to(depth.dtype) - cy) / fy
    pts = torch.stack([u * d, v * d, d], dim=-1).reshape(d.shape[0], -1, 3)
    centered = pts - pts.mean(dim=1, keepdim=True)
    cov = centered.transpose(1, 2) @ centered / pts.shape[1]
    eye = torch.eye(3, dtype=depth.dtype, device=depth.device)
    _, vecs = torch.linalg.eigh(cov + 1e-12 * eye)
    normal = vecs[:, :, 0]
    dist = _abs((centered * normal[:, None, :]).sum(-1))
    return dist.mean(-1).mean()


def sparse_opacity_loss(opacities_sigmoid: torch.Tensor,
                        alive: torch.Tensor) -> torch.Tensor:
    """Entropy-style sparsity on sigmoid opacities over the alive lanes,
    ``log(op) + log(1 - op)`` with op clipped to [1e-6, 1 - 1e-6] (in
    sigmoid space: the reference's logit-space form is NaN outside (0,
    1))."""
    lo = torch.full_like(opacities_sigmoid, 1e-6)
    hi = torch.full_like(opacities_sigmoid, 1.0 - 1e-6)
    op = torch.minimum(torch.maximum(lo, opacities_sigmoid), hi)
    term = torch.where(alive, torch.log(op) + torch.log(1.0 - op), 0.0)
    return term.sum() / torch.clamp(alive.sum(), min=1)


def edge_aware_smooth_loss(depth: torch.Tensor,
                           image: torch.Tensor) -> torch.Tensor:
    """Depth gradients weighted by ``exp(-|dI|)``, so they cost less across
    image edges."""
    dd_x = _abs(depth[:, 1:] - depth[:, :-1])
    dd_y = _abs(depth[1:, :] - depth[:-1, :])
    di_x = _abs(image[:, 1:, :] - image[:, :-1, :]).mean(-1)
    di_y = _abs(image[1:, :, :] - image[:-1, :, :]).mean(-1)
    return (dd_x * torch.exp(-di_x)).mean() + (dd_y * torch.exp(-di_y)).mean()
