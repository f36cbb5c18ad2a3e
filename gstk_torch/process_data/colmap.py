"""COLMAP reconstruction IO + conversion to transforms.json (port of
``gstk_tpu/process_data/colmap.py``, a numpy copy).

Self-contained readers for COLMAP's binary/text model files (format:
https://colmap.github.io/format.html), replacing the reference's vendored
``gs_toolkit/data/utils/colmap_parsing_utils.py`` (511 LoC) and the
conversion half of ``gs_toolkit/process_data/colmap_utils.py``:

  * :func:`read_cameras` / :func:`read_images` / :func:`read_points3d` —
    binary and text variants;
  * :func:`colmap_to_json` — COLMAP model -> nerfstudio-style transforms.json
    with the OpenCV->OpenGL flip and the axis-swap ``applied_transform``
    (colmap_utils.py:155-248);
  * :func:`export_point_cloud_ply` — sparse points -> PLY seed cloud.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from pathlib import Path
from typing import Dict, Optional

import numpy as np

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # (4,) wxyz
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray  # (M, 2)
    point3d_ids: np.ndarray  # (M,) int64, -1 = none


@dataclasses.dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2d_idxs: np.ndarray


def qvec_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _read(f, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            out[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return out


def read_images_binary(path) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            im_id, qw, qx, qy, qz, tx, ty, tz, cam_id = _read(f, "<idddddddi")
            chars = bytearray()
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                chars += c
            (m,) = _read(f, "<Q")
            data = np.frombuffer(
                f.read(24 * m), dtype=[("x", "<f8"), ("y", "<f8"), ("id", "<i8")]
            )
            out[im_id] = ColmapImage(
                im_id,
                np.array([qw, qx, qy, qz]),
                np.array([tx, ty, tz]),
                cam_id,
                chars.decode("utf-8"),
                np.stack([data["x"], data["y"]], axis=-1),
                data["id"].copy(),
            )
    return out


def read_points3d_binary(path) -> Dict[int, ColmapPoint3D]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pid, x, y, z, r, g, b, err, tl = _read(f, "<QdddBBBdQ")
            track = np.frombuffer(
                f.read(8 * tl), dtype=[("im", "<i4"), ("pt", "<i4")]
            )
            out[pid] = ColmapPoint3D(
                int(pid), np.array([x, y, z]), np.array([r, g, b], np.uint8),
                float(err), track["im"].copy(), track["pt"].copy(),
            )
    return out


def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    out = {}
    for line in Path(path).read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cam_id, model = int(parts[0]), parts[1]
        out[cam_id] = ColmapCamera(
            cam_id, model, int(parts[2]), int(parts[3]),
            np.array([float(p) for p in parts[4:]]),
        )
    return out


def read_images_text(path) -> Dict[int, ColmapImage]:
    out = {}
    lines = [
        ln for ln in Path(path).read_text().splitlines()
        if ln and not ln.startswith("#")
    ]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        im_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array(
            [[float(pts[j]), float(pts[j + 1])] for j in range(0, len(pts), 3)]
        ).reshape(-1, 2)
        ids = np.array([int(pts[j + 2]) for j in range(0, len(pts), 3)], np.int64)
        out[im_id] = ColmapImage(im_id, qvec, tvec, cam_id, name, xys, ids)
    return out


def read_points3d_text(path) -> Dict[int, ColmapPoint3D]:
    out = {}
    for line in Path(path).read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        p = line.split()
        pid = int(p[0])
        track = np.array([int(x) for x in p[8:]], np.int64).reshape(-1, 2)
        out[pid] = ColmapPoint3D(
            pid, np.array([float(x) for x in p[1:4]]),
            np.array([int(x) for x in p[4:7]], np.uint8), float(p[7]),
            track[:, 0].astype(np.int32), track[:, 1].astype(np.int32),
        )
    return out


def read_model(recon_dir):
    """Read cameras/images/points3D, binary preferred, text fallback."""
    recon_dir = Path(recon_dir)
    if (recon_dir / "cameras.bin").exists():
        return (
            read_cameras_binary(recon_dir / "cameras.bin"),
            read_images_binary(recon_dir / "images.bin"),
            read_points3d_binary(recon_dir / "points3D.bin"),
        )
    return (
        read_cameras_text(recon_dir / "cameras.txt"),
        read_images_text(recon_dir / "images.txt"),
        read_points3d_text(recon_dir / "points3D.txt"),
    )


def camera_params_to_json(cam: ColmapCamera) -> dict:
    """COLMAP camera -> transforms.json intrinsics block (reference
    colmap_utils.py parse_colmap_camera_params)."""
    p = cam.params
    out = {"w": cam.width, "h": cam.height}
    if cam.model == "SIMPLE_PINHOLE":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2])
        out["camera_model"] = "OPENCV"
    elif cam.model == "PINHOLE":
        out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3])
        out["camera_model"] = "OPENCV"
    elif cam.model == "SIMPLE_RADIAL":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2], k1=p[3], k2=0.0,
                   p1=0.0, p2=0.0)
        out["camera_model"] = "OPENCV"
    elif cam.model == "RADIAL":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2], k1=p[3], k2=p[4],
                   p1=0.0, p2=0.0)
        out["camera_model"] = "OPENCV"
    elif cam.model == "OPENCV":
        out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3], k1=p[4], k2=p[5],
                   p1=p[6], p2=p[7])
        out["camera_model"] = "OPENCV"
    elif cam.model == "OPENCV_FISHEYE":
        out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3], k1=p[4], k2=p[5],
                   k3=p[6], k4=p[7])
        out["camera_model"] = "OPENCV_FISHEYE"
    else:
        raise NotImplementedError(f"camera model {cam.model}")
    return out


def colmap_to_json(
    recon_dir,
    output_dir,
    scale_factor: float = 1.0,
    image_id_to_depth_path: Optional[Dict[int, Path]] = None,
    image_id_to_mask_path: Optional[Dict[int, Path]] = None,
    image_rename_map: Optional[Dict[str, str]] = None,
    scales: Optional[Dict[int, float]] = None,
    shifts: Optional[Dict[int, float]] = None,
) -> int:
    """COLMAP model -> transforms.json (reference colmap_utils.py:155-248)."""
    cameras, images, points = read_model(recon_dir)
    output_dir = Path(output_dir)

    frames = []
    for im_id, im in images.items():
        rot = qvec_to_rotmat(im.qvec)
        w2c = np.eye(4)
        w2c[:3, :3] = rot
        w2c[:3, 3] = im.tvec
        c2w = np.linalg.inv(w2c)
        # OpenCV -> OpenGL camera axes
        c2w[0:3, 1:3] *= -1
        # world axis swap (x<->y, z negated) to nerfstudio convention
        c2w = c2w[np.array([1, 0, 2, 3]), :]
        c2w[2, :] *= -1

        name = im.name
        if image_rename_map is not None:
            name = image_rename_map[name]
        frame = {
            "file_path": (Path("./images") / name).as_posix(),
            "transform_matrix": c2w.tolist(),
            "colmap_im_id": im_id,
        }
        if scales is not None and im_id in scales:
            frame["scale"] = float(scales[im_id])
        if shifts is not None and im_id in shifts:
            frame["shift"] = float(shifts[im_id])
        if image_id_to_depth_path is not None:
            dp = Path(image_id_to_depth_path[im_id])
            frame["depth_path"] = str(dp.relative_to(dp.parent.parent))
        if image_id_to_mask_path is not None:
            mp = Path(image_id_to_mask_path[im_id])
            frame["mask_path"] = str(mp.relative_to(mp.parent.parent))
        frames.append(frame)

    if set(cameras.keys()) != {1}:
        raise RuntimeError("Only a single shared camera is supported.")
    out = camera_params_to_json(cameras[1])
    out["applied_scale"] = scale_factor
    if (output_dir / "colmap" / "point_cloud.ply").exists():
        out["ply_file_path"] = "colmap/point_cloud.ply"
    out["frames"] = frames
    applied = np.eye(4)[:3][np.array([1, 0, 2]), :]
    applied[2, :] *= -1
    out["applied_transform"] = applied.tolist()
    with open(output_dir / "transforms.json", "w") as f:
        json.dump(out, f, indent=4)
    return len(frames)


def export_point_cloud_ply(recon_dir, out_path) -> int:
    """Sparse COLMAP points -> seed point cloud PLY."""
    from gstk_torch.utils.io import write_ply

    _, _, points = read_model(recon_dir)
    xyz = np.array([p.xyz for p in points.values()], np.float32)
    rgb = np.array([p.rgb for p in points.values()], np.uint8)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    write_ply(
        out_path,
        {
            "vertex": {
                "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
                "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2],
            }
        },
    )
    return len(xyz)
