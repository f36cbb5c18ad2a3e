"""Pinhole camera for the splat render path (port of
``gstk_tpu/core/cameras.py``).

Conventions:
  * ``c2w`` is camera-to-world in the OpenGL convention (+x right, +y up,
    -z forward), as nerfstudio-style ``transforms.json`` gives it.
  * The world-to-camera view matrix flips y/z (diag(1,-1,-1)) into the
    OpenCV convention before inverting.
  * The projection is an OpenGL frustum with near 0.001 and far 1000.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from gstk_torch.utils.math import projection_matrix


@dataclasses.dataclass(frozen=True)
class Camera:
    """One pinhole camera: 0-d float32 intrinsics, (3, 4) c2w, one device."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    c2w: torch.Tensor  # (3, 4) OpenGL camera-to-world

    @classmethod
    def create(cls, fx, fy, cx, cy, c2w, device=None) -> "Camera":
        """Camera from Python or numpy values; ``c2w`` may be (3,4) or (4,4)."""
        c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)[:3, :4]
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=c2w.device)
        return cls(fx=f32(fx), fy=f32(fy), cx=f32(cx), cy=f32(cy), c2w=c2w)

    @property
    def position(self) -> torch.Tensor:
        return self.c2w[:3, 3]


def view_matrix(c2w: torch.Tensor) -> torch.Tensor:
    """OpenGL c2w (3,4) -> OpenCV world-to-camera (4,4): analytic inverse
    with the y/z flip."""
    flip = torch.tensor([1.0, -1.0, -1.0], dtype=c2w.dtype, device=c2w.device)
    R = c2w[:3, :3] * flip[None, :]
    t = c2w[:3, 3:4]
    R_inv = R.T
    t_inv = -R_inv @ t
    top = torch.cat([R_inv, t_inv], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=top.dtype, device=top.device)
    return torch.cat([top, bottom], dim=0)


def camera_matrices(
    camera: Camera, img_height: int, img_width: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(viewmat (4,4), fullmat = projmat @ viewmat (4,4))."""
    viewmat = view_matrix(camera.c2w)
    fovx = 2.0 * torch.atan(0.5 * img_width / camera.fx)
    fovy = 2.0 * torch.atan(0.5 * img_height / camera.fy)
    projmat = projection_matrix(0.001, 1000.0, fovx, fovy)
    return viewmat, projmat @ viewmat
