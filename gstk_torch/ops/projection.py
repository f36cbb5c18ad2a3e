"""EWA projection of 3D Gaussians to screen space (port of
``gstk_tpu/ops/projection.py``).

Elementwise over N Gaussians, so plain tensor code with component-wise
(N,) arithmetic. Semantics, as in gstk_tpu:
  * view-space clamping of means to 1.3*tan(fov) before the EWA Jacobian,
  * +0.3 px isotropic screen-space blur with antialiasing compensation
    ``sqrt(det_orig / det_blur)``,
  * conic = inverse of 2D covariance; radius = ceil(3*sqrt(max eigenvalue))
    with the ``b^2 - det`` term clamped to >= 0.1,
  * pixel projection through the full (proj @ view) matrix with +1e-6
    homogeneous epsilon and the -0.5 pixel-center offset,
  * near-plane cull at z < clip_thresh (0.01) and det != 0 validity,
  * ``num_tiles_hit`` = clamped tile-bbox area.
Divisions are guarded so masked-out lanes carry no NaNs. Gradients flow
through autograd; clipping on the differentiated path uses
``torch.minimum``/``torch.maximum``, whose gradient splits at a tie as
gstk_tpu's ``jnp.clip``/``jnp.maximum`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class ProjectedGaussians(NamedTuple):
    """Screen-space Gaussians. All tensors are length-N, masked lanes zeroed."""

    cov3d: torch.Tensor  # (N, 6) upper-triangular 3D covariance
    xys: torch.Tensor  # (N, 2) pixel-space centers
    depths: torch.Tensor  # (N,) view-space z
    radii: torch.Tensor  # (N,) int32 pixel radius (0 => culled)
    conics: torch.Tensor  # (N, 3) inverse 2D covariance (a, b, c)
    compensation: torch.Tensor  # (N,) antialiasing opacity compensation
    num_tiles_hit: torch.Tensor  # (N,) int32 tile-bbox area
    mask: torch.Tensor  # (N,) bool visibility


def _cov3d_components(scales, glob_scale, quats):
    """Upper-triangular components of R diag(s^2) R^T as six (N,) tensors."""
    w, x, y, z = quats.unbind(-1)
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    s0, s1, s2 = (glob_scale * scales[..., i] for i in range(3))
    m00, m01, m02 = r00 * s0, r01 * s1, r02 * s2
    m10, m11, m12 = r10 * s0, r11 * s1, r12 * s2
    m20, m21, m22 = r20 * s0, r21 * s1, r22 * s2
    c00 = m00 * m00 + m01 * m01 + m02 * m02
    c01 = m00 * m10 + m01 * m11 + m02 * m12
    c02 = m00 * m20 + m01 * m21 + m02 * m22
    c11 = m10 * m10 + m11 * m11 + m12 * m12
    c12 = m10 * m20 + m11 * m21 + m12 * m22
    c22 = m20 * m20 + m21 * m21 + m22 * m22
    return c00, c01, c02, c11, c12, c22


def _project_cov3d_ewa(means3d, cov, viewmat, fx, fy, tan_fovx, tan_fovy):
    """EWA perspective projection of the 3D covariance (6-tuple of
    upper-tri components). Returns (cov2d (N,3) [a, b, c], compensation
    (N,), t (N,3) view-space position)."""
    c00, c01, c02, c11, c12, c22 = cov
    W = viewmat[:3, :3]
    p = viewmat[:3, 3]
    mx, my, mz = means3d.unbind(-1)
    t0 = W[0, 0] * mx + W[0, 1] * my + W[0, 2] * mz + p[0]
    t1 = W[1, 0] * mx + W[1, 1] * my + W[1, 2] * mz + p[1]
    tz = W[2, 0] * mx + W[2, 1] * my + W[2, 2] * mz + p[2]
    t = torch.stack([t0, t1, tz], dim=-1)

    tz_safe = torch.where(torch.abs(tz) < 1e-6, 1e-6, tz)
    rz = 1.0 / tz_safe
    lim_x = torch.as_tensor(1.3 * tan_fovx, dtype=tz.dtype, device=tz.device)
    lim_y = torch.as_tensor(1.3 * tan_fovy, dtype=tz.dtype, device=tz.device)
    # minimum/maximum, not clamp: at a tie they split the gradient in half,
    # as gstk_tpu's jnp.clip does (clamp passes all of it)
    tx = tz * torch.minimum(torch.maximum(t0 * rz, -lim_x), lim_x)
    ty = tz * torch.minimum(torch.maximum(t1 * rz, -lim_y), lim_y)

    rz2 = rz * rz
    # J = [[fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]]; T = J @ W (N, 2, 3)
    fxr = fx * rz
    fyr = fy * rz
    gx = fx * tx * rz2
    gy = fy * ty * rz2
    T00 = fxr * W[0, 0] - gx * W[2, 0]
    T01 = fxr * W[0, 1] - gx * W[2, 1]
    T02 = fxr * W[0, 2] - gx * W[2, 2]
    T10 = fyr * W[1, 0] - gy * W[2, 0]
    T11 = fyr * W[1, 1] - gy * W[2, 1]
    T12 = fyr * W[1, 2] - gy * W[2, 2]

    def quad(u0, u1, u2, v0, v1, v2):  # u^T cov3d v
        return (
            c00 * u0 * v0 + c11 * u1 * v1 + c22 * u2 * v2
            + c01 * (u0 * v1 + u1 * v0)
            + c02 * (u0 * v2 + u2 * v0)
            + c12 * (u1 * v2 + u2 * v1)
        )

    a = quad(T00, T01, T02, T00, T01, T02)
    b = quad(T00, T01, T02, T10, T11, T12)
    c = quad(T10, T11, T12, T10, T11, T12)

    det_orig = a * c - b * b
    a = a + 0.3
    c = c + 0.3
    det_blur = a * c - b * b
    det_blur_safe = torch.where(torch.abs(det_blur) < 1e-12, 1e-12, det_blur)
    ratio = det_orig / det_blur_safe
    compensation = torch.sqrt(torch.maximum(ratio, torch.zeros_like(ratio)))
    return torch.stack([a, b, c], dim=-1), compensation, t


def _cov2d_bounds(cov2d):
    """Conic (inverse cov), 3-sigma pixel radius, validity from (N,3) cov2d."""
    a, b, c = cov2d.unbind(-1)
    det = a * c - b * b
    valid = det != 0.0
    inv_det = 1.0 / torch.where(valid, det, 1.0)
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    half_tr = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(half_tr * half_tr - det, min=0.1))
    v_max = half_tr + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(v_max, min=0.0)))
    return conic, radius, valid


def project_pix(fullmat, means3d, img_wh, center) -> torch.Tensor:
    """Project world points through proj@view to pixel coords (N, 2):
    u = 0.5*W*ndc_x - 0.5 + cx with homogeneous eps 1e-6."""
    mx, my, mz = means3d.unbind(-1)
    F = fullmat
    ph0 = F[0, 0] * mx + F[0, 1] * my + F[0, 2] * mz + F[0, 3]
    ph1 = F[1, 0] * mx + F[1, 1] * my + F[1, 2] * mz + F[1, 3]
    pw = F[3, 0] * mx + F[3, 1] * my + F[3, 2] * mz + F[3, 3]
    rw = 1.0 / (pw + 1e-6)
    u = 0.5 * img_wh[0] * ph0 * rw - 0.5 + center[0]
    v = 0.5 * img_wh[1] * ph1 * rw - 0.5 + center[1]
    return torch.stack([u, v], dim=-1)


def tile_bbox(xys, radius, tile_bounds, block_width):
    """Per-Gaussian tile bounding box with truncation semantics.

    radius is float, (N,) (square bbox) or (N, 2) per-axis half-extents (the
    tight footprint of :func:`tight_extents`); returns int32 (tile_min,
    tile_max), each (N, 2), clamped to [0, tiles_x] x [0, tiles_y]."""
    tile_center = xys / block_width
    tile_radius = radius[..., None] if radius.ndim == xys.ndim - 1 else radius
    tile_radius = tile_radius / block_width
    top_left = torch.trunc(tile_center - tile_radius).to(torch.int32)
    bottom_right = torch.trunc(tile_center + tile_radius).to(torch.int32) + 1
    hi = torch.tensor(tile_bounds, dtype=torch.int32, device=xys.device)
    zero = torch.zeros_like(hi)
    tile_min = torch.minimum(torch.maximum(top_left, zero), hi)
    tile_max = torch.minimum(torch.maximum(bottom_right, zero), hi)
    return tile_min, tile_max


def tight_extents(conics, opacities, radii) -> torch.Tensor:
    """Axis-aligned half-extents (pixels, (N, 2)) of each Gaussian's visible
    support {sigma <= ln(255*op)} intersected with the 3-sigma square.

    Tiles outside it contribute exactly nothing (alpha < 1/255 there), so
    binning into this footprint changes no output and shrinks the
    intersection list. opacities (N,) in [0, 1]; radii (N,) (0 = culled)."""
    op = torch.clamp(opacities.reshape(-1), min=0.0)
    sig_cut = torch.log(torch.clamp(255.0 * op, min=1e-12))
    ca, cb, cc = conics.unbind(-1)
    det = torch.clamp(ca * cc - cb * cb, min=1e-24)
    s2 = torch.clamp(2.0 * sig_cut, min=0.0) / det
    # conservative f32 margin: rounding must never drop a live tile
    margin = 1.0 + 1e-4
    wx = torch.sqrt(torch.clamp(s2 * cc, min=0.0)) * margin + 1e-3
    wy = torch.sqrt(torch.clamp(s2 * ca, min=0.0)) * margin + 1e-3
    r = radii.to(torch.float32)
    # inclusive alpha cutoff: op == 1/255 exactly still contributes at sigma 0
    visible = (r > 0) & (sig_cut >= 0.0)
    ext = torch.stack([torch.minimum(wx, r), torch.minimum(wy, r)], dim=-1)
    return torch.where(visible[:, None], ext, 0.0)


def project_gaussians(
    means3d, scales, glob_scale, quats, viewmat, fullmat, fx, fy, cx, cy,
    img_height: int, img_width: int, block_width: int = 16,
    clip_thresh: float = 0.01,
) -> ProjectedGaussians:
    """Project N Gaussians to screen space.

    scales are linear (already exp'ed), quats normalized wxyz, viewmat (4,4)
    world->camera (OpenCV convention), fullmat = projmat @ viewmat; fx..cy
    are 0-d float32 tensors or floats."""
    tile_bounds = (
        (img_width + block_width - 1) // block_width,
        (img_height + block_width - 1) // block_width,
    )
    tan_fovx = 0.5 * img_width / fx
    tan_fovy = 0.5 * img_height / fy

    cov = _cov3d_components(scales, glob_scale, quats)
    cov2d, compensation, t = _project_cov3d_ewa(
        means3d, cov, viewmat, fx, fy, tan_fovx, tan_fovy
    )
    conic, radius_f, det_valid = _cov2d_bounds(cov2d)
    xys = project_pix(fullmat, means3d, (img_width, img_height), (cx, cy))
    tile_min, tile_max = tile_bbox(xys, radius_f, tile_bounds, block_width)
    tile_area = (tile_max[..., 0] - tile_min[..., 0]) * (
        tile_max[..., 1] - tile_min[..., 1]
    )
    depths = t[..., 2]
    mask = (tile_area > 0) & ~(depths < clip_thresh) & det_valid

    def zero_if_masked(x):
        m = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))
        return torch.where(m, x, 0.0)

    return ProjectedGaussians(
        cov3d=zero_if_masked(torch.stack(cov, dim=-1)),
        xys=zero_if_masked(xys),
        depths=zero_if_masked(depths),
        radii=torch.where(mask, radius_f, 0.0).to(torch.int32),
        conics=zero_if_masked(conic),
        compensation=zero_if_masked(compensation),
        num_tiles_hit=torch.where(mask, tile_area, 0).to(torch.int32),
        mask=mask,
    )
