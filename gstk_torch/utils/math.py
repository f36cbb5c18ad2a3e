"""Small math utilities (port of ``gstk_tpu/utils/math.py``).

Random quats, RGB<->SH DC conversion, the OpenGL projection matrix, and the
quaternion math used by projection. All functions are plain tensor code.
"""

from __future__ import annotations

import math

import torch

# DC spherical-harmonic basis constant (Y_0^0 = 1/(2*sqrt(pi))).
SH_C0 = 0.28209479177387814


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """RGB in [0,1] -> 0th SH coefficient."""
    return (rgb - 0.5) / SH_C0


def sh_to_rgb(sh: torch.Tensor) -> torch.Tensor:
    """0th SH coefficient -> RGB in [0,1]."""
    return sh * SH_C0 + 0.5


def random_quats(generator: torch.Generator, n: int) -> torch.Tensor:
    """Uniformly random unit quaternions, (n, 4) wxyz, on the generator's
    device: Shoemake's subgroup algorithm from three uniforms."""
    u, v, w = torch.rand(
        (n, 3), generator=generator, device=generator.device
    ).unbind(-1)
    two_pi = 2.0 * math.pi
    return torch.stack(
        [
            torch.sqrt(1.0 - u) * torch.sin(two_pi * v),
            torch.sqrt(1.0 - u) * torch.cos(two_pi * v),
            torch.sqrt(u) * torch.sin(two_pi * w),
            torch.sqrt(u) * torch.cos(two_pi * w),
        ],
        dim=-1,
    )


def normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    norm = torch.linalg.norm(x, dim=dim, keepdim=True)
    return x / torch.maximum(norm, torch.full_like(norm, eps))


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) in wxyz order -> rotation matrix (..., 3, 3);
    quats must already be normalized."""
    w, x, y, z = quat.unbind(-1)
    rows = [
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y)],
        [2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x)],
        [2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def projection_matrix(znear: float, zfar: float, fovx, fovy) -> torch.Tensor:
    """OpenGL-style perspective projection matrix (4, 4), float32.

    The rasterizer uses ``projmat @ viewmat`` only to project means to
    pixels; with :func:`gstk_torch.ops.projection.project_pix` this gives
    u = fx*x/z + cx - 0.5."""
    fovx = torch.as_tensor(fovx, dtype=torch.float32)
    fovy = torch.as_tensor(fovy, dtype=torch.float32, device=fovx.device)
    t = znear * torch.tan(0.5 * fovy)
    r = znear * torch.tan(0.5 * fovx)
    n, f = znear, zfar
    zero = torch.zeros_like(fovx)
    one = torch.ones_like(fovx)
    rows = [
        torch.stack([n / r, zero, zero, zero]),
        torch.stack([zero, n / t, zero, zero]),
        torch.stack(
            [zero, zero, (f + n) / (f - n) * one, -f * n / (f - n) * one]
        ),
        torch.stack([zero, zero, one, zero]),
    ]
    return torch.stack(rows, dim=0)
