"""Images -> training dataset pipeline, the gs-process-data backend (port
of ``gstk_tpu/process_data/pipeline.py``).

Equivalent of ``ImagesToGSToolkitDataset``
(``gs_toolkit/process_data/images_to_gstk_dataset.py:24-194``) and its COLMAP
orchestration (``colmap_converter_to_gstk_dataset.py:97-226``):

  1. copy + optionally downscale images (and depth/mask variants);
  2. run SfM — hloc when importable, else the COLMAP CLI when present;
  3. align sensor depth (global scale) or mono depth (per-image scale/shift)
     against the sparse model;
  4. export the seed point cloud and write ``transforms.json``.

Steps degrade gracefully: without a COLMAP binary, an existing
``colmap/sparse/0`` model can be supplied (``skip_colmap=True``) and the rest
of the pipeline runs identically.

gstk_tpu reads, downscales and writes the images with OpenCV. Here PNGs go
through :func:`gstk_torch.utils.io.read_png` / :func:`write_png`, and the
pyramid is OpenCV's INTER_AREA in numpy (:func:`area_downscale_image`): the
integer block mean with OpenCV's rounding where the size divides by the
factor, its area weights otherwise. Other formats (JPEG) are read and
written by Pillow, imported only for them.
"""

from __future__ import annotations

import dataclasses
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from gstk_torch import DeviceLike
from gstk_torch.process_data.colmap import (
    colmap_to_json,
    export_point_cloud_ply,
    read_model,
)
from gstk_torch.process_data.depth_align import align_mono_depth, align_sensor_depth
from gstk_torch.utils.io import _is_png, _pil_image, read_png, write_png
from gstk_torch.utils.math import area_weights


@dataclasses.dataclass
class ProcessConfig:
    data: Path = Path("images")
    output_dir: Path = Path("processed")
    num_downscales: int = 3
    camera_model: str = "OPENCV"
    depth_data: Optional[Path] = None  # sensor depth dir (16-bit mm PNGs)
    mono_depth_data: Optional[Path] = None  # mono-depth estimate dir
    # run monocular depth estimation on the processed images (reference
    # --using-est-depth, process_data_utils.py:453-530); requires a real
    # depth model unless allow_toy_depth opts into the test placeholder
    using_est_depth: bool = False
    depth_method: str = "auto"
    allow_toy_depth: bool = False
    skip_colmap: bool = False
    colmap_matcher: str = "sequential"  # sequential | exhaustive
    gpu: bool = False
    # SfM backend + feature/matcher configuration (reference
    # hloc_utils.py:15 exposes the same knobs)
    sfm_backend: str = "auto"  # auto | hloc | colmap
    feature_type: str = "superpoint_aachen"  # hloc feature conf
    matcher_type: str = "superglue"  # hloc matcher conf
    sift_max_features: int = 8192  # colmap SIFT budget
    # the device of a local depth checkpoint (using_est_depth); None: cuda
    device: DeviceLike = None


def colmap_available() -> bool:
    return shutil.which("colmap") is not None


def _read_image(path: Path) -> np.ndarray:
    """An image file as stored (cv2's IMREAD_UNCHANGED, in RGB order)."""
    if _is_png(path):
        try:
            return read_png(path)
        except NotImplementedError:
            pass
    with _pil_image().open(path) as img:
        return np.asarray(img)


def _write_image(path: Path, image: np.ndarray) -> None:
    """A PNG by ``write_png``; other formats by Pillow (JPEG at OpenCV's
    default quality, 95)."""
    if path.suffix.lower() == ".png":
        write_png(path, image)
    else:
        _pil_image().fromarray(image).save(path, quality=95)


def area_downscale_image(image: np.ndarray, factor: int) -> np.ndarray:
    """``cv2.resize(image, (w // factor, h // factor), INTER_AREA)`` for a
    uint8 or uint16 image, (H, W) or (H, W, C).

    Where ``factor`` divides the size, OpenCV's integer block mean: the
    block sum over ``factor``^2 rounded half up (its 2x2 fast path, for 1, 3
    or 4 channels), else half to even; equal to OpenCV's. Otherwise its
    area weights (:func:`gstk_torch.utils.math.area_weights`) in float64,
    within one level of OpenCV's float sums."""
    h, w = image.shape[:2]
    oh, ow = h // factor, w // factor
    img = image if image.ndim == 3 else image[..., None]
    if h % factor == 0 and w % factor == 0:
        area = factor * factor
        blocks = img.reshape(oh, factor, ow, factor, -1).astype(np.int64)
        total = blocks.sum(axis=(1, 3))
        if factor == 2 and img.shape[-1] in (1, 3, 4):
            out = (total + 2) >> 2
        else:
            q, r = np.divmod(total, area)
            out = q + ((2 * r > area) | ((2 * r == area) & (q % 2 == 1)))
    else:
        wy, wx = area_weights(h, oh), area_weights(w, ow)
        out = np.rint(np.einsum("yh,hwc,xw->yxc", wy, img.astype(np.float64),
                                wx))
    info = np.iinfo(image.dtype)
    out = np.clip(out, info.min, info.max).astype(image.dtype)
    return out if image.ndim == 3 else out[..., 0]


def copy_and_downscale_images(
    src: Path, out_dir: Path, num_downscales: int, prefix: str = "images"
) -> Dict[str, str]:
    """Copy images to out/<prefix>/ and write <prefix>_{2,4,8}/ pyramids.
    Returns {original_name: frame_XXXXX.ext} rename map
    (reference process_data_utils.py:230-320)."""
    exts = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff"}
    files = sorted(p for p in Path(src).iterdir() if p.suffix.lower() in exts)
    if not files:
        raise FileNotFoundError(f"no images found in {src}")
    (out_dir / prefix).mkdir(parents=True, exist_ok=True)
    rename = {}
    for i, p in enumerate(files):
        new_name = f"frame_{i + 1:05d}{p.suffix.lower()}"
        rename[p.name] = new_name
        shutil.copy(p, out_dir / prefix / new_name)
    for d in range(1, num_downscales + 1):
        factor = 2**d
        sub = out_dir / f"{prefix}_{factor}"
        sub.mkdir(exist_ok=True)
        for p in (out_dir / prefix).iterdir():
            small = area_downscale_image(_read_image(p), factor)
            _write_image(sub / p.name, small)
    return rename


def hloc_available() -> bool:
    try:
        import hloc  # noqa: F401

        return True
    except Exception:
        return False


def run_hloc(
    image_dir: Path,
    colmap_dir: Path,
    feature_type: str = "superpoint_aachen",
    matcher_type: str = "superglue",
    matching_method: str = "sequential",
) -> Path:
    """SfM via hloc (the reference's default backend, hloc_utils.py:15):
    learned features + matcher feeding pycolmap reconstruction. Requires
    the hloc package + its model weights (not bundled offline); gated by
    ``hloc_available``."""
    from hloc import (  # type: ignore
        extract_features,
        match_features,
        pairs_from_exhaustive,
        reconstruction,
    )

    colmap_dir.mkdir(parents=True, exist_ok=True)
    outputs = colmap_dir
    sfm_pairs = outputs / "pairs.txt"
    sfm_dir = outputs / "sparse" / "0"
    feature_conf = extract_features.confs[feature_type]
    matcher_conf = match_features.confs[matcher_type]
    image_list = sorted(
        p.name for p in Path(image_dir).iterdir()
        if p.suffix.lower() in (".jpg", ".jpeg", ".png")
    )
    features = extract_features.main(
        feature_conf, Path(image_dir), image_list=image_list,
        feature_path=outputs / "features.h5",
    )
    pairs_from_exhaustive.main(sfm_pairs, image_list=image_list)
    matches = match_features.main(
        matcher_conf, sfm_pairs, features=features,
        matches=outputs / "matches.h5",
    )
    reconstruction.main(
        sfm_dir, Path(image_dir), sfm_pairs, features, matches,
        image_list=image_list,
    )
    return sfm_dir


def run_sfm(
    image_dir: Path,
    colmap_dir: Path,
    camera_model: str = "OPENCV",
    matcher: str = "sequential",
    gpu: bool = False,
    backend: str = "auto",
    feature_type: str = "superpoint_aachen",
    matcher_type: str = "superglue",
    sift_max_features: int = 8192,
) -> Path:
    """Structure-from-motion with backend resolution: hloc (the
    reference's default) when importable, the COLMAP CLI otherwise, and an
    actionable error when neither exists."""
    if backend == "auto":
        backend = (
            "hloc" if hloc_available()
            else "colmap" if colmap_available()
            else "none"
        )
    if backend == "hloc":
        if not hloc_available():
            raise RuntimeError(
                "--sfm-backend hloc requested but the hloc package is not "
                "importable; install Hierarchical-Localization + weights, "
                "or use --sfm-backend colmap"
            )
        return run_hloc(
            image_dir, colmap_dir, feature_type, matcher_type, matcher
        )
    if backend == "colmap":
        return run_colmap(
            image_dir, colmap_dir, camera_model, matcher, gpu,
            sift_max_features=sift_max_features,
        )
    raise RuntimeError(
        "No SfM backend available: the hloc package is not importable and "
        "no `colmap` binary is on PATH. Options: (a) install COLMAP, "
        "(b) install hloc (Hierarchical-Localization) with its model "
        "weights, or (c) run SfM elsewhere and pass --skip-colmap with the "
        "existing sparse model directory."
    )


def run_colmap(
    image_dir: Path,
    colmap_dir: Path,
    camera_model: str = "OPENCV",
    matcher: str = "sequential",
    gpu: bool = False,
    sift_max_features: int = 8192,
) -> Path:
    """Feature extraction -> matching -> mapper via the COLMAP CLI
    (the reference shells out to hloc/colmap the same way,
    hloc_utils.py:15, colmap_converter_to_gstk_dataset.py:203-226)."""
    if not colmap_available():
        raise RuntimeError(
            "colmap binary not found; run SfM elsewhere and pass "
            "--skip-colmap with an existing sparse model"
        )
    colmap_dir.mkdir(parents=True, exist_ok=True)
    db = colmap_dir / "database.db"
    use_gpu = "1" if gpu else "0"
    subprocess.run(
        [
            "colmap", "feature_extractor",
            "--database_path", str(db),
            "--image_path", str(image_dir),
            "--ImageReader.single_camera", "1",
            "--ImageReader.camera_model", camera_model,
            "--SiftExtraction.use_gpu", use_gpu,
            "--SiftExtraction.max_num_features", str(sift_max_features),
        ],
        check=True,
    )
    matcher_cmd = (
        "sequential_matcher" if matcher == "sequential" else "exhaustive_matcher"
    )
    subprocess.run(
        [
            "colmap", matcher_cmd,
            "--database_path", str(db),
            "--SiftMatching.use_gpu", use_gpu,
        ],
        check=True,
    )
    sparse = colmap_dir / "sparse"
    sparse.mkdir(exist_ok=True)
    subprocess.run(
        [
            "colmap", "mapper",
            "--database_path", str(db),
            "--image_path", str(image_dir),
            "--output_path", str(sparse),
        ],
        check=True,
    )
    return sparse / "0"


def _depth_lookup(depth_dir: Path):
    def lookup(name: str) -> Optional[np.ndarray]:
        depth_name = name.replace(".jpg", ".png").replace("frame_", "depth_")
        path = depth_dir / depth_name
        if not path.exists():
            path = depth_dir / name.replace(".jpg", ".png")
        if not path.exists():
            return None
        return read_png(path)

    return lookup


def process_images(config: ProcessConfig) -> Path:
    """Run the full pipeline; returns the dataset directory."""
    out = Path(config.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    rename = copy_and_downscale_images(config.data, out, config.num_downscales)

    recon_dir = out / "colmap" / "sparse" / "0"
    if not config.skip_colmap:
        recon_dir = run_sfm(
            out / "images", out / "colmap", config.camera_model,
            config.colmap_matcher, config.gpu,
            backend=config.sfm_backend,
            feature_type=config.feature_type,
            matcher_type=config.matcher_type,
            sift_max_features=config.sift_max_features,
        )
    if not (recon_dir / "cameras.bin").exists() and not (
        recon_dir / "cameras.txt"
    ).exists():
        raise FileNotFoundError(f"no COLMAP model at {recon_dir}")

    cameras, images, points = read_model(recon_dir)
    cam = cameras[min(cameras)]
    scale_factor = 1.0
    scales = shifts = None
    image_id_to_depth = None

    if config.depth_data is not None:
        # copy sensor depths alongside and compute the global metric scale
        depth_out = out / "depths"
        depth_out.mkdir(exist_ok=True)
        for p in Path(config.depth_data).iterdir():
            shutil.copy(p, depth_out / p.name)
        lookup = _depth_lookup(depth_out)
        scale_factor = align_sensor_depth(
            images, points, lookup, cam.width, cam.height
        )
        image_id_to_depth = {
            im_id: depth_out
            / im.name.replace(".jpg", ".png").replace("frame_", "depth_")
            for im_id, im in images.items()
        }
    elif config.mono_depth_data is not None or config.using_est_depth:
        depth_out = out / "depths"
        depth_out.mkdir(exist_ok=True)
        if config.mono_depth_data is not None:
            for p in Path(config.mono_depth_data).iterdir():
                shutil.copy(p, depth_out / p.name)
        else:
            from gstk_torch.process_data.mono_depth import estimate_depths

            estimate_depths(
                out / "images", depth_out, method=config.depth_method,
                allow_toy=config.allow_toy_depth, device=config.device,
            )
        lookup = _depth_lookup(depth_out)
        scales, shifts = align_mono_depth(
            images, points, lookup, cam.width, cam.height
        )
        image_id_to_depth = {
            im_id: depth_out
            / im.name.replace(".jpg", ".png").replace("frame_", "depth_")
            for im_id, im in images.items()
        }

    export_point_cloud_ply(recon_dir, out / "colmap" / "point_cloud.ply")
    # COLMAP already saw the renamed frame_XXXXX images, so its recorded
    # names need no further mapping.
    n = colmap_to_json(
        recon_dir, out, scale_factor=scale_factor,
        image_id_to_depth_path=image_id_to_depth,
        scales=scales, shifts=shifts,
    )
    print(f"Wrote transforms.json with {n} frames to {out}")
    return out
