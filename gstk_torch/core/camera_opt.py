"""Learned camera-pose refinement, SE(3) or SO(3) x R3 deltas (port of
``gstk_tpu/core/camera_opt.py``).

A (num_cameras, 6) tangent-space adjustment per train camera, exp-mapped
and right-multiplied onto the camera's c2w (the delta acts in the camera's
own frame). The train step differentiates the loss by the adjustments and
steps them with their own exp-decayed Adam group; the reference registers
that group (lr 1e-3, decayed to 5e-5) but its splat models never apply it.

Both exp maps select between the full formula and a small-angle one with
``torch.where``, which back-propagates through both branches: the full
branch divides by ``theta_safe``, clamped at 1e-8, so that at the zero
initial adjustment its gradient stays finite and the select's 0 keeps it 0.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from gstk_torch.core.cameras import Camera


@dataclasses.dataclass(frozen=True)
class CameraOptConfig:
    """Reference CameraOptimizerConfig (camera_optimizers.py:22-40) + its
    Adam group (method_configs.py:75-80)."""

    mode: Literal["off", "SO3xR3", "SE3"] = "off"
    trans_l2_penalty: float = 1e-2
    rot_l2_penalty: float = 1e-3
    lr: float = 1e-3
    lr_final: float = 5e-5
    max_steps: int = 30_000


def _safe_norm(x: torch.Tensor, dim: int = -1,
               keepdim: bool = False) -> torch.Tensor:
    """Norm with a finite gradient at 0, where the adjustments start."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + 1e-24)


def init_camera_opt(num_cameras: int, device=None) -> torch.Tensor:
    """Zero pose adjustments: (num_cameras, 6) [translation, so3 tangent]."""
    return torch.zeros((num_cameras, 6), dtype=torch.float32, device=device)


def pose_regularizer(adjustments: torch.Tensor,
                     cfg: CameraOptConfig) -> torch.Tensor:
    """L2 pose penalty over all cameras (camera_optimizers.py:125-133)."""
    return (
        torch.mean(_safe_norm(adjustments[:, :3])) * cfg.trans_l2_penalty
        + torch.mean(_safe_norm(adjustments[:, 3:])) * cfg.rot_l2_penalty
    )


def _skew(v: torch.Tensor) -> torch.Tensor:
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def _rotation_parts(omega: torch.Tensor):
    """theta (.., 1), theta_safe, skew(axis), sin and cos (.., 1, 1) and
    the identity broadcast to (.., 3, 3)."""
    theta = _safe_norm(omega, keepdim=True)
    theta_safe = torch.maximum(theta, torch.full_like(theta, 1e-8))
    k = _skew(omega / theta_safe)
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(k.shape)
    return theta, theta_safe, k, s, c, eye


def exp_map_so3xr3(tangent: torch.Tensor) -> torch.Tensor:
    """(.., 6) [t, omega] -> (.., 3, 4) with R = exp(omega), independent t."""
    t = tangent[..., :3]
    omega = tangent[..., 3:]
    theta, _, k, s, c, eye = _rotation_parts(omega)
    big = eye + s * k + (1.0 - c) * (k @ k)
    # small-angle fallback: I + skew(omega)
    small = eye + _skew(omega)
    R = torch.where((theta > 1e-6)[..., None], big, small)
    return torch.cat([R, t[..., None]], dim=-1)


def exp_map_se3(tangent: torch.Tensor) -> torch.Tensor:
    """(.., 6) [rho, omega] -> (.., 3, 4) full SE(3) exponential."""
    rho = tangent[..., :3]
    omega = tangent[..., 3:]
    theta, theta_safe, k, s, c, eye = _rotation_parts(omega)
    R_big = eye + s * k + (1.0 - c) * (k @ k)
    V_big = (
        eye
        + ((1.0 - c) / theta_safe[..., None]) * k
        + ((theta[..., None] - s) / theta_safe[..., None]) * (k @ k)
    )
    R_small = eye + _skew(omega)
    V_small = eye + 0.5 * _skew(omega)
    use_big = (theta > 1e-6)[..., None]
    R = torch.where(use_big, R_big, R_small)
    V = torch.where(use_big, V_big, V_small)
    t = (V @ rho[..., None])[..., 0]
    return torch.cat([R, t[..., None]], dim=-1)


def apply_to_camera(
    camera: Camera,
    adjustment: torch.Tensor,
    mode: Literal["SO3xR3", "SE3", "off"] = "SO3xR3",
) -> Camera:
    """Compose a learned (6,) delta onto a camera's c2w, right-multiplied
    (``c2w @ adj``) as the reference's ``apply_to_camera``
    (camera_optimizers.py:110-123)."""
    if mode == "off":
        return camera
    delta = (
        exp_map_so3xr3(adjustment) if mode == "SO3xR3"
        else exp_map_se3(adjustment)
    )
    R0 = camera.c2w[:3, :3]
    R = R0 @ delta[:3, :3]
    t = R0 @ delta[:3, 3] + camera.c2w[:3, 3]
    return dataclasses.replace(camera, c2w=torch.cat([R, t[:, None]], dim=1))
