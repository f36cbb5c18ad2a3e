"""Scene bounds: axis-aligned and oriented boxes (port of
``gstk_tpu/core/scene_box.py``).

Used for crop-box filtered rendering (``render_scene(crop_box=)``) and
export cropping. ``within`` returns a mask, not indices, so the render path
can AND it with the alive mask. A box's tensors may live on any device:
``within`` moves them to the points' device.
"""

from __future__ import annotations

import dataclasses

import torch


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class SceneBox:
    """Axis-aligned box: aabb (2, 3) [min; max]."""

    aabb: torch.Tensor

    def within(self, points: torch.Tensor) -> torch.Tensor:
        aabb = self.aabb.to(points.device)
        return ((points >= aabb[0]) & (points <= aabb[1])).all(dim=-1)

    def get_center(self) -> torch.Tensor:
        return 0.5 * (self.aabb[0] + self.aabb[1])

    def get_diagonal_length(self) -> torch.Tensor:
        return torch.linalg.norm(self.aabb[1] - self.aabb[0])


@dataclasses.dataclass(frozen=True)
class OrientedBox:
    """Oriented box: rotation R (3, 3), translation T (3,), scale S (3,)."""

    R: torch.Tensor
    T: torch.Tensor
    S: torch.Tensor

    def within(self, points: torch.Tensor) -> torch.Tensor:
        """Mask of points inside the box."""
        dev = points.device
        local = (points - self.T.to(dev)) @ self.R.to(dev)  # R columns are box axes
        half = 0.5 * self.S.to(dev)
        return (local.abs() <= half).all(dim=-1)

    @staticmethod
    def from_params(rpy, position, scale, device=None) -> "OrientedBox":
        """Build from roll/pitch/yaw (radians), center and extents, in f32
        (R = rz @ ry @ rx)."""
        rpy = _f32(rpy, device)
        cr, sr = torch.cos(rpy[0]), torch.sin(rpy[0])
        cp, sp = torch.cos(rpy[1]), torch.sin(rpy[1])
        cy, sy = torch.cos(rpy[2]), torch.sin(rpy[2])
        one, zero = torch.ones_like(cr), torch.zeros_like(cr)
        mat = lambda rows: torch.stack([torch.stack(r) for r in rows])
        rx = mat([[one, zero, zero], [zero, cr, -sr], [zero, sr, cr]])
        ry = mat([[cp, zero, sp], [zero, one, zero], [-sp, zero, cp]])
        rz = mat([[cy, -sy, zero], [sy, cy, zero], [zero, zero, one]])
        return OrientedBox(R=rz @ ry @ rx, T=_f32(position, rpy.device),
                           S=_f32(scale, rpy.device))
