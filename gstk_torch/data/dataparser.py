"""transforms.json dataparser (host-side numpy; a copy of
``gstk_tpu/data/dataparser.py`` that reads image sizes with the port's PNG
codec).

Like the reference's ``GSToolkitDataParser``
(``gs_toolkit/data/dataparsers/gs_toolkit_dataparser.py:77-498``): parses the
nerfstudio-style ``transforms.json`` with per-frame or global intrinsics,
distortion, depth/mask paths and mono-depth scale/shift, applies train/eval
splits, auto-orients/centers and scales poses, loads the seed point cloud
(own PLY reader instead of open3d) and resolves downscaled image folders.
Everything here is plain numpy — it runs once at startup; only the
datamanager's cached tensors touch the device.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from gstk_torch.data.splits import get_split
from gstk_torch.utils.io import image_size, read_ply_points
from gstk_torch.utils.poses import auto_orient_and_center_poses

MAX_AUTO_RESOLUTION = 1600


@dataclasses.dataclass
class DataparserConfig:
    """Mirrors GSToolkitDataParserConfig (gs_toolkit_dataparser.py:40-76)."""

    data: Path = Path(".")
    scale_factor: float = 1.0
    downscale_factor: Optional[int] = None
    scene_scale: float = 1.0
    orientation_method: str = "up"  # pca | up | vertical | none
    center_method: str = "poses"  # poses | focus | none
    auto_scale_poses: bool = True
    eval_mode: str = "fraction"  # fraction | filename | interval | all
    train_split_fraction: float = 0.9
    eval_interval: int = 8
    depth_unit_scale_factor: float = 1e-3


@dataclasses.dataclass
class DataparserOutputs:
    image_filenames: List[Path]
    poses: np.ndarray  # (N, 3, 4) OpenGL c2w, oriented/centered/scaled
    fx: np.ndarray  # (N,)
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray
    heights: np.ndarray  # (N,) int
    widths: np.ndarray  # (N,) int
    distortion: np.ndarray  # (N, 6) [k1 k2 k3 k4 p1 p2]
    camera_model: str
    mask_filenames: Optional[List[Path]]
    depth_filenames: Optional[List[Path]]
    mono_depth_scales: Optional[np.ndarray]
    mono_depth_shifts: Optional[np.ndarray]
    depth_unit_scale_factor: float
    dataparser_transform: np.ndarray  # (3, 4)
    dataparser_scale: float
    scene_box: np.ndarray  # (2, 3) aabb
    points3d_xyz: Optional[np.ndarray]  # (M, 3) seed points (scene space)
    points3d_rgb: Optional[np.ndarray]  # (M, 3) uint8


def _distortion_vec(src: Dict) -> np.ndarray:
    if "distortion_params" in src:
        d = np.asarray(src["distortion_params"], np.float32)
        out = np.zeros(6, np.float32)
        out[: len(d)] = d
        return out
    return np.asarray(
        [float(src.get(k, 0.0)) for k in ("k1", "k2", "k3", "k4", "p1", "p2")],
        np.float32,
    )


def _resolve_downscale(cfg: DataparserConfig, data_dir: Path, sample: Path) -> int:
    """Auto-downscale resolution discovery (gs_toolkit_dataparser.py:459-498)."""
    if cfg.downscale_factor is not None:
        return cfg.downscale_factor
    max_res = max(image_size(data_dir / sample))
    df = 0
    while max_res / 2**df >= MAX_AUTO_RESOLUTION:
        if not (data_dir / f"images_{2 ** (df + 1)}" / sample.name).exists():
            break
        df += 1
    return 2**df


def _fname(data_dir: Path, filepath: Path, downscale: int, prefix: str) -> Path:
    if downscale > 1:
        return data_dir / f"{prefix}{downscale}" / filepath.name
    return data_dir / filepath


def parse_transforms(
    config: DataparserConfig, split: str = "train"
) -> DataparserOutputs:
    data = Path(config.data)
    if data.suffix == ".json":
        meta_path, data_dir = data, data.parent
    else:
        meta_path, data_dir = data / "transforms.json", data
    with open(meta_path) as f:
        meta = json.load(f)

    if "applied_scale" in meta:
        config.scale_factor = float(meta["applied_scale"])

    frames = meta["frames"]
    # sort by resolved filename, as the reference does
    frames = sorted(frames, key=lambda fr: str(Path(fr["file_path"])))

    downscale = _resolve_downscale(
        config, data_dir, Path(frames[0]["file_path"])
    )

    names, poses = [], []
    fx, fy, cx, cy, hs, ws, dist = [], [], [], [], [], [], []
    masks, depths, mscales, mshifts = [], [], [], []
    for fr in frames:
        fp = Path(fr["file_path"])
        names.append(_fname(data_dir, fp, downscale, "images_"))
        poses.append(np.asarray(fr["transform_matrix"], np.float32))
        fx.append(float(fr.get("fl_x", meta.get("fl_x", 0.0))))
        fy.append(float(fr.get("fl_y", meta.get("fl_y", 0.0))))
        cx.append(float(fr.get("cx", meta.get("cx", 0.0))))
        cy.append(float(fr.get("cy", meta.get("cy", 0.0))))
        hs.append(int(fr.get("h", meta.get("h", 0))))
        ws.append(int(fr.get("w", meta.get("w", 0))))
        dist.append(
            _distortion_vec(fr)
            if any(
                k in fr
                for k in ("distortion_params", "k1", "k2", "k3", "k4", "p1", "p2")
            )
            else _distortion_vec(meta)
        )
        if "mask_path" in fr:
            masks.append(_fname(data_dir, Path(fr["mask_path"]), downscale, "masks_"))
        if "depth_path" in fr:
            depths.append(
                _fname(data_dir, Path(fr["depth_path"]), downscale, "depths_")
            )
        if "scale" in fr:
            mscales.append(float(fr["scale"]))
        if "shift" in fr:
            mshifts.append(float(fr["shift"]))

    n = len(names)
    for lst, what in ((masks, "mask"), (depths, "depth")):
        assert len(lst) in (0, n), f"{what} paths must cover all frames or none"

    # split selection (supports explicit <split>_filenames lists)
    split_key = f"{split}_filenames"
    has_any_split_files = any(
        f"{s}_filenames" in meta for s in ("train", "val", "test")
    )
    if split_key in meta:
        wanted = {str(_fname(data_dir, Path(x), downscale, "images_")) for x in meta[split_key]}
        indices = np.asarray(
            [i for i, p in enumerate(names) if str(p) in wanted], np.int64
        )
    elif has_any_split_files:
        raise RuntimeError(f"missing {split_key} in transforms.json")
    else:
        i_train, i_eval = get_split(
            names, meta.get("eval_mode", config.eval_mode),
            config.train_split_fraction, config.eval_interval,
        )
        indices = i_train if split == "train" else i_eval

    orientation = meta.get("orientation_override", config.orientation_method)
    poses44 = np.stack(
        [np.concatenate([p[:3], [[0, 0, 0, 1]]], axis=0) for p in poses]
    )
    oriented, transform = auto_orient_and_center_poses(
        poses44, method=orientation, center_method=config.center_method
    )
    scale = 1.0
    if config.auto_scale_poses:
        scale /= float(np.max(np.abs(oriented[:, :3, 3])))
    scale *= config.scale_factor
    oriented[:, :3, 3] *= scale

    if "applied_transform" in meta:
        applied = np.asarray(meta["applied_transform"], np.float32)
        transform = transform @ np.concatenate(
            [applied, np.array([[0, 0, 0, 1]], np.float32)], axis=0
        )

    sel = lambda lst: [lst[i] for i in indices] if lst else None
    pick = lambda a: np.asarray(a, np.float32)[indices]
    df_inv = 1.0 / downscale

    pts_xyz = pts_rgb = None
    if "ply_file_path" in meta:
        xyz, rgb = read_ply_points(data_dir / meta["ply_file_path"])
        hom = np.concatenate([xyz, np.ones_like(xyz[:, :1])], axis=-1)
        pts_xyz = (hom @ transform.T).astype(np.float32) * scale
        pts_rgb = rgb if rgb is not None else np.full_like(xyz, 127, np.uint8)

    aabb = config.scene_scale
    return DataparserOutputs(
        image_filenames=sel(names),
        poses=oriented[indices][:, :3, :],
        fx=pick(fx) * df_inv,
        fy=pick(fy) * df_inv,
        cx=pick(cx) * df_inv,
        cy=pick(cy) * df_inv,
        heights=(np.asarray(hs)[indices] * df_inv).astype(int),
        widths=(np.asarray(ws)[indices] * df_inv).astype(int),
        distortion=np.stack(dist)[indices],
        camera_model=meta.get("camera_model", "OPENCV"),
        mask_filenames=sel(masks),
        depth_filenames=sel(depths),
        mono_depth_scales=pick(mscales) if mscales else None,
        mono_depth_shifts=pick(mshifts) if mshifts else None,
        depth_unit_scale_factor=config.depth_unit_scale_factor,
        dataparser_transform=transform,
        dataparser_scale=scale,
        scene_box=np.asarray(
            [[-aabb, -aabb, -aabb], [aabb, aabb, aabb]], np.float32
        ),
        points3d_xyz=pts_xyz,
        points3d_rgb=pts_rgb,
    )
