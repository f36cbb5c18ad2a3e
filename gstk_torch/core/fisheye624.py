"""Fisheye624 (FisheyeRadTanThinPrism) camera model in torch, f32 (port of
``gstk_tpu/core/fisheye624.py``).

Parity target: the reference's batched torch implementation
(``gs_toolkit/cameras/camera_utils.py:664-960``), which implements the
Project Aria "fisheye62/624" model — equidistant fisheye with a 6-term
odd-polynomial radial series in theta, tangential (p0, p1) and thin-prism
(s0..s3) terms:

    a = x/z, b = y/z, r = sqrt(a^2 + b^2), th = atan(r)
    th_d = th + k0 th^3 + k1 th^5 + ... + k5 th^13
    (x_r, y_r) = th_d * (a, b) / r
    rd^2 = x_r^2 + y_r^2
    u = x_r + (2 x_r^2 + rd^2) p0 + 2 x_r y_r p1 + s0 rd^2 + s1 rd^4
    v = y_r + (2 y_r^2 + rd^2) p1 + 2 x_r y_r p0 + s2 rd^2 + s3 rd^4
    (pix_u, pix_v) = (fx u + cx, fy v + cy)

``params`` is a 16-vector ``[fx fy cx cy k0..k5 p0 p1 s0..s3]`` (a
15-vector with shared focal ``[f cx cy ...]`` is also accepted, as in the
reference). Unprojection has no closed form; it inverts the distortion with
two Newton solves of fixed iteration counts (uv -> (x_r, y_r), then
th_d -> th), mirroring the reference's.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def _split_params(params: torch.Tensor):
    if params.shape[-1] == 15:
        fx = fy = params[..., 0]
        cx, cy = params[..., 1], params[..., 2]
    else:
        fx, fy = params[..., 0], params[..., 1]
        cx, cy = params[..., 2], params[..., 3]
    k = params[..., -12:-6]
    p = params[..., -6:-4]
    s = params[..., -4:]
    return fx, fy, cx, cy, k, p, s


def _radial(th: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """th_d = th + sum_i k_i th^(3+2i)  (Horner in th^2)."""
    th2 = th * th
    acc = torch.zeros_like(th)
    for i in range(5, -1, -1):
        acc = (acc + k[..., i]) * th2
    return th + acc * th


def _distort(xr: torch.Tensor, yr: torch.Tensor, p: torch.Tensor,
             s: torch.Tensor):
    """Tangential + thin-prism terms applied to the radially-corrected
    point; returns (u, v) in normalized image coordinates."""
    xr2, yr2 = xr * xr, yr * yr
    rd2 = xr2 + yr2
    rd4 = rd2 * rd2
    u = xr + (2.0 * xr2 + rd2) * p[..., 0] + 2.0 * xr * yr * p[..., 1] \
        + s[..., 0] * rd2 + s[..., 1] * rd4
    v = yr + (2.0 * yr2 + rd2) * p[..., 1] + 2.0 * xr * yr * p[..., 0] \
        + s[..., 2] * rd2 + s[..., 3] * rd4
    return u, v


def fisheye624_project(xyz: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Project (..., 3) camera-space points to (..., 2) pixels.

    ``params`` broadcasts against the leading dims of ``xyz``.
    """
    z = xyz[..., 2]
    eps = torch.where(z < 0, torch.full_like(z, -_EPS), torch.full_like(z, _EPS))
    z = torch.where(z.abs() < _EPS, eps, z)
    a = xyz[..., 0] / z
    b = xyz[..., 1] / z
    r = torch.sqrt(a * a + b * b)
    th = torch.atan(r)
    fx, fy, cx, cy, k, p, s = _split_params(params)
    th_d = _radial(th, k)
    inv_r = torch.where(r < _EPS, torch.ones_like(r),
                        1.0 / torch.clamp(r, min=_EPS))
    xr = th_d * a * inv_r
    yr = th_d * b * inv_r
    u, v = _distort(xr, yr, p, s)
    return torch.stack([fx * u + cx, fy * v + cy], dim=-1)


def fisheye624_unproject(
    uv: torch.Tensor, params: torch.Tensor, max_iters: int = 5
) -> torch.Tensor:
    """Pixel (..., 2) -> unit direction (..., 3) in camera space (z > 0).

    Two fixed-count Newton solves (reference
    camera_utils.py:fisheye624_unproject_helper): first invert the
    tangential/thin-prism map for (x_r, y_r) with a 2x2 Jacobian, then
    invert the scalar radial polynomial for theta.
    """
    fx, fy, cx, cy, k, p, s = _split_params(params)
    tu = (uv[..., 0] - cx) / fx
    tv = (uv[..., 1] - cy) / fy

    xr, yr = tu, tv
    for _ in range(max_iters):
        u, v = _distort(xr, yr, p, s)
        fu, fv = u - tu, v - tv
        # Jacobian of (u, v) wrt (xr, yr)
        rd2 = xr * xr + yr * yr
        duu = 1.0 + 6.0 * xr * p[..., 0] + 2.0 * yr * p[..., 1] \
            + xr * (2.0 * s[..., 0] + 4.0 * s[..., 1] * rd2)
        duv = 2.0 * yr * p[..., 0] + 2.0 * xr * p[..., 1] \
            + yr * (2.0 * s[..., 0] + 4.0 * s[..., 1] * rd2)
        dvu = 2.0 * yr * p[..., 0] + 2.0 * xr * p[..., 1] \
            + xr * (2.0 * s[..., 2] + 4.0 * s[..., 3] * rd2)
        dvv = 1.0 + 6.0 * yr * p[..., 1] + 2.0 * xr * p[..., 0] \
            + yr * (2.0 * s[..., 2] + 4.0 * s[..., 3] * rd2)
        det = duu * dvv - duv * dvu
        det = torch.where(det.abs() < _EPS, torch.full_like(det, _EPS), det)
        xr = xr - (dvv * fu - duv * fv) / det
        yr = yr - (-dvu * fu + duu * fv) / det

    th_d = torch.sqrt(xr * xr + yr * yr)
    th = th_d
    for _ in range(max_iters):
        th2 = th * th
        f = _radial(th, k) - th_d
        # d th_d / d th = 1 + sum (3+2i) k_i th^(2+2i)
        dacc = torch.zeros_like(th)
        for i in range(5, -1, -1):
            dacc = dacc * th2 + (3.0 + 2.0 * i) * k[..., i]
        df = 1.0 + dacc * th2
        th = th - f / torch.where(df.abs() < _EPS, torch.full_like(df, _EPS), df)

    sin_th = torch.sin(th)
    cos_th = torch.cos(th)
    on_axis = th_d < _EPS
    inv = torch.where(on_axis, torch.ones_like(th_d),
                      1.0 / torch.clamp(th_d, min=_EPS))
    # on-axis: direction (0, 0, 1)
    dx = torch.where(on_axis, torch.zeros_like(th), sin_th * xr * inv)
    dy = torch.where(on_axis, torch.zeros_like(th), sin_th * yr * inv)
    d = torch.stack([dx, dy, cos_th], dim=-1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)
