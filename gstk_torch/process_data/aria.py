"""Project Aria capture -> gstk dataset conversion (port of
``gstk_tpu/process_data/aria.py``, a numpy copy).

Equivalent of the reference ``process_project_aria``
(``gs_toolkit/scripts/datasets/process_project_aria.py:1-233``): extract RGB
frames from a VRS recording, look up the MPS closed-loop trajectory pose
nearest each frame timestamp, compose the device->camera extrinsic, convert
from Aria's +Z-forward/+Y-down convention to the OpenGL-style +Z-back/+Y-up
convention, and emit a ``transforms.json`` with fisheye624 intrinsics.

The pose math is dependency-free (plain numpy, tested); only
:func:`process_aria_capture` needs ``projectaria_tools`` and degrades with a
clear message when the package is absent. Frames are written as PNG by
:func:`gstk_torch.utils.io.write_png`, where gstk_tpu writes JPEG through
Pillow.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from gstk_torch.utils.io import write_png

ARIA_CAMERA_MODEL = "FISHEYE624"

# Aria device frame: +Z forward, +Y down. GSTK/Blender frame: +Z back,
# +Y up (reference process_project_aria.py:27-39).
T_ARIA_GSTK = np.array(
    [
        [1.0, 0.0, 0.0, 0.0],
        [0.0, -1.0, 0.0, 0.0],
        [0.0, 0.0, -1.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ]
)


@dataclass
class AriaCalibration:
    """Factory calibration of the RGB camera (fisheye624 projection)."""

    fx: float
    fy: float
    cx: float
    cy: float
    distortion_params: np.ndarray  # (15,) fisheye624 coefficients
    width: int
    height: int
    t_device_camera: np.ndarray  # (4, 4) SE3


def nearest_pose_index(timestamps_ns: np.ndarray, query_ns: float) -> int:
    """Index of the trajectory sample closest in time to ``query_ns``
    (reference ``get_nearest_pose``, process_project_aria.py:120-127)."""
    return int(np.argmin(np.abs(np.asarray(timestamps_ns) - query_ns)))


def camera_to_world(
    t_world_device: np.ndarray, t_device_camera: np.ndarray
) -> np.ndarray:
    """World<-camera in GSTK convention: flip the Aria camera axes then
    compose onto the device pose (process_project_aria.py:129-147)."""
    t_world_camera = t_world_device @ t_device_camera @ T_ARIA_GSTK
    return t_world_camera


def frames_to_transforms(
    calib: AriaCalibration, frames: Sequence[Dict]
) -> Dict:
    """Assemble the transforms.json dict (process_project_aria.py:150-186)."""
    return {
        "camera_model": ARIA_CAMERA_MODEL,
        "fl_x": calib.fx,
        "fl_y": calib.fy,
        "cx": calib.cx,
        "cy": calib.cy,
        "w": calib.width,
        "h": calib.height,
        "distortion_params": np.asarray(calib.distortion_params)
        .ravel()
        .tolist(),
        "frames": [
            {
                "file_path": f["file_path"],
                "transform_matrix": np.asarray(f["t_world_camera"]).tolist(),
                "timestamp": f["timestamp_ns"],
            }
            for f in frames
        ],
    }


def process_aria_capture(
    vrs_file: Path,
    mps_data_dir: Path,
    output_dir: Path,
    max_frames: int = 0,
) -> Path:
    """Full conversion. Requires ``projectaria_tools``; raises ImportError
    with install guidance otherwise (mirrors the reference's hard exit,
    process_project_aria.py:12-23)."""
    try:
        from projectaria_tools.core import mps
        from projectaria_tools.core.data_provider import (
            create_vrs_data_provider,
        )
    except ImportError as e:
        raise ImportError(
            "projectaria_tools is required for Aria conversion: "
            "pip install 'projectaria-tools[all]'"
        ) from e

    output_dir = Path(output_dir)
    images_dir = output_dir / "images"
    images_dir.mkdir(parents=True, exist_ok=True)

    provider = create_vrs_data_provider(str(vrs_file))
    device_calib = provider.get_device_calibration()
    sensor_calib = device_calib.get_camera_calib("camera-rgb")
    width = int(sensor_calib.get_image_size()[0])
    height = int(sensor_calib.get_image_size()[1])
    intr = sensor_calib.projection_params()
    calib = AriaCalibration(
        fx=float(intr[0]),
        fy=float(intr[0]),
        cx=float(intr[1]),
        cy=float(intr[2]),
        distortion_params=np.asarray(intr[3:15]),
        width=width,
        height=height,
        t_device_camera=sensor_calib.get_transform_device_camera()
        .to_matrix(),
    )

    traj = mps.read_closed_loop_trajectory(
        str(Path(mps_data_dir) / "closed_loop_trajectory.csv")
    )
    timestamps_ns = np.array(
        [
            p.tracking_timestamp.total_seconds() * 1e9
            for p in traj
        ]
    )
    t_world_devices = [
        p.transform_world_device.to_matrix() for p in traj
    ]

    stream_id = provider.get_stream_id_from_label("camera-rgb")
    n = provider.get_num_data(stream_id)
    if max_frames:
        n = min(n, max_frames)
    frames: List[Dict] = []
    for i in range(n):
        image_data = provider.get_image_data_by_index(stream_id, i)
        ts_ns = image_data[1].capture_timestamp_ns
        j = nearest_pose_index(timestamps_ns, ts_ns)
        t_wc = camera_to_world(t_world_devices[j], calib.t_device_camera)
        name = f"frame_{i:05d}.png"
        write_png(images_dir / name, image_data[0].to_numpy_array())
        frames.append(
            {
                "file_path": f"images/{name}",
                "t_world_camera": t_wc,
                "timestamp_ns": float(ts_ns),
            }
        )

    out = frames_to_transforms(calib, frames)
    path = output_dir / "transforms.json"
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    return path
