"""Camera trajectory generation: pose interpolation for rendering paths
(port of ``gstk_tpu/core/trajectories.py``, a numpy copy).

Equivalent of the reference trajectory tooling
(``gs_toolkit/cameras/camera_paths.py`` + the slerp/interpolation math in
``camera_utils.py:153-276``): interpolate between keyframe poses with
quaternion slerp + linear translation, generate orbit ("spiral") paths, and
emit nerfstudio-style ``camera_path`` dicts consumable by gs-render.
Host-side numpy.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def rotmat_to_quat(r: np.ndarray) -> np.ndarray:
    """(3,3) rotation -> wxyz quaternion (Shepperd's method)."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
             (r[1, 0] - r[0, 1]) / s]
        )
    i = int(np.argmax([r[0, 0], r[1, 1], r[2, 2]]))
    if i == 0:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
        q = [(r[2, 1] - r[1, 2]) / s, 0.25 * s, (r[0, 1] + r[1, 0]) / s,
             (r[0, 2] + r[2, 0]) / s]
    elif i == 1:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
        q = [(r[0, 2] - r[2, 0]) / s, (r[0, 1] + r[1, 0]) / s, 0.25 * s,
             (r[1, 2] + r[2, 1]) / s]
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
        q = [(r[1, 0] - r[0, 1]) / s, (r[0, 2] + r[2, 0]) / s,
             (r[1, 2] + r[2, 1]) / s, 0.25 * s]
    return np.asarray(q)


def quat_to_rotmat_np(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Spherical linear interpolation of wxyz quats
    (camera_utils.py:153-200)."""
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    theta = np.arccos(np.clip(d, -1, 1))
    return (
        np.sin((1 - t) * theta) * q0 + np.sin(t * theta) * q1
    ) / np.sin(theta)


def interpolate_poses(
    keyframes: Sequence[np.ndarray], steps_per_segment: int = 30
) -> List[np.ndarray]:
    """Interpolate (3,4)|(4,4) c2w keyframes -> list of (3,4) poses."""
    out = []
    for a, b in zip(keyframes[:-1], keyframes[1:]):
        qa, qb = rotmat_to_quat(np.asarray(a)[:3, :3]), rotmat_to_quat(
            np.asarray(b)[:3, :3]
        )
        ta, tb = np.asarray(a)[:3, 3], np.asarray(b)[:3, 3]
        for i in range(steps_per_segment):
            t = i / steps_per_segment
            pose = np.zeros((3, 4), np.float32)
            pose[:3, :3] = quat_to_rotmat_np(slerp(qa, qb, t))
            pose[:3, 3] = (1 - t) * ta + t * tb
            out.append(pose)
    out.append(np.asarray(keyframes[-1], np.float32)[:3, :4])
    return out


def orbit_path(
    center=(0.0, 0.0, 0.0),
    radius: float = 3.0,
    elevation: float = 0.3,
    n_frames: int = 120,
) -> List[np.ndarray]:
    """Circular orbit looking at ``center`` (OpenGL c2w poses)."""
    from gstk_torch.viewer.http_viewer import orbit_pose

    return [
        orbit_pose(2 * np.pi * i / n_frames, elevation, radius, center)
        for i in range(n_frames)
    ]


def poses_to_camera_path(
    poses: Sequence[np.ndarray],
    fov_deg: float = 70.0,
    render_height: int = 1080,
    render_width: int = 1920,
    fps: float = 30.0,
) -> dict:
    """Emit a nerfstudio-style camera_path JSON dict (what the reference's
    render panel writes and gs-render trajectory consumes)."""
    path = []
    for p in poses:
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :4] = np.asarray(p)[:3, :4]
        path.append(
            {"camera_to_world": c2w.reshape(-1).tolist(), "fov": fov_deg}
        )
    return {
        "camera_path": path,
        "render_height": render_height,
        "render_width": render_width,
        "fps": fps,
        "seconds": len(poses) / fps,
    }
