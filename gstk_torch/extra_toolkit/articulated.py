"""Articulated-object pose composition utilities (port of
``gstk_tpu/extra_toolkit/articulated.py``).

Equivalent of the reference ``extra_toolkit/articulated_utils.py``: compose a
joint transform (revolute rotation about an axis through a pivot, or
prismatic translation along an axis) onto subsets of Gaussians — used for
robotics perception scenes with articulated objects. The joints are torch
on the scene's device and return a new scene, leaving their input as it
was, as gstk_tpu's do; the RGB-D back-projection and the normals are numpy
copies.
"""

from __future__ import annotations

import numpy as np
import torch

from gstk_torch import DeviceLike, resolve_device
from gstk_torch.core.gaussians import FIELD_NAMES, GaussianScene
from gstk_torch.core.trajectories import rotmat_to_quat


def axis_angle_rotation(axis, angle, device: DeviceLike = None
                        ) -> torch.Tensor:
    """Rodrigues rotation matrix (3, 3) f32 for an (3,) axis and scalar
    angle, on ``device`` (cuda unless given)."""
    axis = torch.as_tensor(axis, dtype=torch.float32,
                           device=resolve_device(device))
    axis = axis / torch.linalg.norm(axis)
    kx, ky, kz = axis
    zero = torch.zeros((), dtype=torch.float32, device=axis.device)
    K = torch.stack([
        torch.stack([zero, -kz, ky]),
        torch.stack([kz, zero, -kx]),
        torch.stack([-ky, kx, zero]),
    ])
    angle = torch.as_tensor(angle, dtype=torch.float32, device=axis.device)
    eye = torch.eye(3, dtype=torch.float32, device=axis.device)
    return eye + torch.sin(angle) * K + (1 - torch.cos(angle)) * (K @ K)


def _quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, wxyz."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def transform_gaussians(
    scene: GaussianScene,
    mask: torch.Tensor,
    rotation: torch.Tensor,
    translation: torch.Tensor,
) -> GaussianScene:
    """A new scene with (R, t) applied to the masked Gaussians (means and
    orientations); ``scene`` is left as it was."""
    dev = scene.means.device
    rotation = torch.as_tensor(rotation, dtype=torch.float32, device=dev)
    translation = torch.as_tensor(translation, dtype=torch.float32, device=dev)
    rot_q = torch.as_tensor(
        rotmat_to_quat(rotation.detach().cpu().numpy()),
        dtype=torch.float32, device=dev)
    with torch.no_grad():
        means = scene.means.detach()
        quats = scene.quats.detach()
        new_means = means @ rotation.T + translation
        new_quats = _quat_multiply(rot_q.expand(quats.shape), quats)
        m = torch.as_tensor(mask, device=dev)[:, None]
        fields = {k: getattr(scene, k).detach().clone() for k in FIELD_NAMES}
        fields["means"] = torch.where(m, new_means, means)
        fields["quats"] = torch.where(m, new_quats, quats)
    return GaussianScene(**fields)


def revolute_joint(
    scene: GaussianScene, mask: torch.Tensor, pivot, axis, angle
) -> GaussianScene:
    """Rotate masked Gaussians by ``angle`` about ``axis`` through ``pivot``."""
    dev = scene.means.device
    R = axis_angle_rotation(axis, angle, device=dev)
    pivot = torch.as_tensor(pivot, dtype=torch.float32, device=dev)
    t = pivot - R @ pivot
    return transform_gaussians(scene, mask, R, t)


def prismatic_joint(
    scene: GaussianScene, mask: torch.Tensor, axis, displacement
) -> GaussianScene:
    """Translate masked Gaussians along ``axis`` by ``displacement``."""
    dev = scene.means.device
    axis = torch.as_tensor(axis, dtype=torch.float32, device=dev)
    axis = axis / torch.linalg.norm(axis)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    return transform_gaussians(scene, mask, eye, axis * displacement)


def rgbd_to_pointcloud(
    depth: np.ndarray,
    rgb: np.ndarray,
    fx: float, fy: float, cx: float, cy: float,
    c2w_opengl: np.ndarray = None,
    max_depth: float = 10.0,
    mask: np.ndarray = None,
):
    """Backproject an RGB-D frame to a world-space point cloud
    (reference extra_toolkit/pcd_utils.py:5-31, incl. its mask-gated
    depth; ``max_depth`` is its depth_trunc)."""
    h, w = depth.shape
    if mask is not None:
        depth = np.where(mask > 0, depth, 0.0)
    ys, xs = np.nonzero((depth > 0) & (depth < max_depth))
    d = depth[ys, xs]
    x_c = (xs - cx) / fx * d
    y_c = (ys - cy) / fy * d
    pts = np.stack([x_c, y_c, d], axis=-1)  # OpenCV camera frame
    if c2w_opengl is not None:
        pts_gl = np.stack([x_c, -y_c, -d], axis=-1)
        pts = pts_gl @ c2w_opengl[:3, :3].T + c2w_opengl[:3, 3]
    cols = rgb[ys, xs]
    return pts.astype(np.float32), cols


def estimate_normals(points: np.ndarray, k: int = 30) -> np.ndarray:
    """kNN-PCA surface normals (reference pcd_utils.py:28-30 uses open3d's
    KDTreeSearchParamHybrid; here scipy cKDTree + local covariance
    eigenvectors). Normals are unit length with arbitrary sign."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float64)
    k = min(k, len(pts))
    _, idx = cKDTree(pts).query(pts, k=k)
    nbrs = pts[idx]  # (N, k, 3)
    centered = nbrs - nbrs.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered) / max(k - 1, 1)
    # smallest-eigenvalue eigenvector of each 3x3 covariance
    _, vecs = np.linalg.eigh(cov)
    normals = vecs[:, :, 0]
    norms = np.linalg.norm(normals, axis=-1, keepdims=True)
    return (normals / np.maximum(norms, 1e-12)).astype(np.float32)
