"""Pose orientation/centering utilities (host-side numpy; a copy of
``gstk_tpu/utils/poses.py``).

Re-implementation of the pose normalization in
``gs_toolkit/cameras/camera_utils.py:462-646`` (auto_orient_and_center_poses,
focus_of_attention, rotation_matrix): datasets are auto-oriented so the mean
camera "up" maps to +z (or PCA/vertical variants) and centered on the mean
camera origin or the focus of attention.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation matrix taking unit vector a to unit vector b (Rodrigues)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-10:
        if c > 0:
            return np.eye(3)
        # 180 degrees: rotate around any orthogonal axis
        axis = np.eye(3)[np.argmin(np.abs(a))]
        v = np.cross(a, axis)
        v /= np.linalg.norm(v)
        return 2.0 * np.outer(v, v) - np.eye(3)
    skew = np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], np.float64
    )
    return np.eye(3) + skew + skew @ skew * (1.0 / (1.0 + c))


def focus_of_attention(poses: np.ndarray, initial: np.ndarray) -> np.ndarray:
    """Closest point to all camera optical axes
    (camera_utils.py:500-550)."""
    active = np.ones(len(poses), bool)
    pt = initial
    for _ in range(10):
        dirs = poses[active, :3, 2:3]  # (-z is forward; sign cancels in m)
        origins = poses[active, :3, 3:4]
        m = np.eye(3) - dirs * np.transpose(dirs, (0, 2, 1))
        mt_m = np.transpose(m, (0, 2, 1)) @ m
        pt = (np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0))[:, 0]
        new_active = (
            np.sum(-poses[:, :3, 2] * (pt - poses[:, :3, 3]), axis=-1) > 0
        )
        if new_active.sum() == 0:
            break
        if np.array_equal(new_active, active):
            break
        active = new_active
    return pt.astype(np.float32)


def auto_orient_and_center_poses(
    poses: np.ndarray,
    method: str = "up",
    center_method: str = "poses",
) -> Tuple[np.ndarray, np.ndarray]:
    """Orient + center (N, 4, 4) OpenGL c2w poses.

    Returns (oriented (N, 3, 4) poses, transform (3, 4)) such that
    oriented = transform @ poses (same contract as the reference).
    """
    poses = np.asarray(poses, np.float32)
    origins = poses[:, :3, 3]
    mean_origin = origins.mean(axis=0)

    if center_method == "poses":
        translation = mean_origin
    elif center_method == "focus":
        translation = focus_of_attention(poses, mean_origin)
    elif center_method == "none":
        translation = np.zeros(3, np.float32)
    else:
        raise ValueError(center_method)

    if method == "pca":
        diff = origins - mean_origin
        _, eigvec = np.linalg.eigh(diff.T @ diff)
        eigvec = eigvec[:, ::-1]
        if np.linalg.det(eigvec) < 0:
            eigvec = eigvec.copy()
            eigvec[:, 2] = -eigvec[:, 2]
        transform = np.concatenate(
            [eigvec, eigvec @ -translation[:, None]], axis=-1
        ).astype(np.float32)
        oriented = transform @ poses
        if oriented.mean(axis=0)[2, 1] < 0:
            oriented[:, 1:3] = -oriented[:, 1:3]
            flip = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
            transform = np.concatenate(
                [flip @ transform[:, :3], flip @ transform[:, 3:]], axis=-1
            )
    elif method in ("up", "vertical"):
        up = poses[:, :3, 1].mean(axis=0)
        up = up / np.linalg.norm(up)
        if method == "vertical":
            x_axes = poses[:, :3, 0]
            _, s, vh = np.linalg.svd(x_axes, full_matrices=False)
            if s[1] > 0.17 * np.sqrt(len(poses)):
                up_v = vh[2, :]
                up = up_v if float(np.dot(up_v, up)) > 0 else -up_v
            else:
                up = up - vh[0, :] * float(np.dot(vh[0, :], up))
                up = up / np.linalg.norm(up)
        rot = rotation_between(up, np.array([0.0, 0.0, 1.0]))
        transform = np.concatenate(
            [rot, rot @ -translation[:, None]], axis=-1
        ).astype(np.float32)
        oriented = transform @ poses
    elif method == "none":
        transform = np.eye(4, dtype=np.float32)[:3]
        transform[:, 3] = -translation
        oriented = transform @ poses
    else:
        raise ValueError(method)

    return oriented.astype(np.float32), transform.astype(np.float32)


def transform_poses_to_original_space(
    poses: np.ndarray,
    applied_transform: np.ndarray,
    applied_scale: float,
) -> np.ndarray:
    """Invert the dataparser transform+scale for (N, 3, 4) poses
    (reference base_dataparser.py transform_poses_to_original_space)."""
    out = poses.copy()
    out[:, :3, 3] /= applied_scale
    full = np.concatenate(
        [applied_transform, np.array([[0, 0, 0, 1]], np.float32)], axis=0
    )
    inv = np.linalg.inv(full)
    hom = np.concatenate(
        [out, np.tile(np.array([[[0, 0, 0, 1]]], np.float32), (len(out), 1, 1))],
        axis=1,
    )
    return (inv @ hom)[:, :3, :].astype(np.float32)
