"""Full-image datamanager: eager cache + undistortion + random camera
sampling (a copy of ``gstk_tpu/data/datamanager.py``; OpenCV is imported
only for non-zero distortion).

Like the reference's ``FullImageDatamanager``
(``gs_toolkit/data/datamanagers/full_images_datamanager.py:69-524``): all
train/eval images are loaded once, undistorted with cv2 (perspective:
getOptimalNewCameraMatrix alpha=0 + ROI crop; fisheye:
fisheye.estimateNewCameraMatrixForUndistortRectify), intrinsics updated to
the new K, and ``next_train`` returns a random unseen camera each step
(reshuffling when exhausted). Images are cropped to a common (H, W), so
every train step sees one image shape.

Per-host sharding for multi-host data parallelism: pass (num_shards,
shard_index) to partition the train split by camera index — the analog of the
reference's DDP sampler (each process sees its slice).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from gstk_torch.data.dataparser import DataparserConfig, DataparserOutputs, parse_transforms
from gstk_torch.utils.io import load_depth, load_image, load_mask


@dataclasses.dataclass
class CachedFrame:
    """One undistorted, cached frame (host numpy)."""

    image: np.ndarray  # (H, W, 3) float32 in [0, 1]
    fx: float
    fy: float
    cx: float
    cy: float
    c2w: np.ndarray  # (3, 4)
    depth: Optional[np.ndarray] = None  # (H, W) float32 meters
    mask: Optional[np.ndarray] = None  # (H, W) bool
    mono_scale: Optional[float] = None
    mono_shift: Optional[float] = None


def _undistort_frame(
    image: np.ndarray,
    k: np.ndarray,
    dist: np.ndarray,
    camera_model: str,
    depth: Optional[np.ndarray],
    mask: Optional[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """Undistort an image (+aligned depth/mask); returns (img, newK, depth, mask).

    Mirrors full_images_datamanager.py:136-381. No-op when distortion is zero.
    """
    if not np.any(np.abs(dist) > 0):
        return image, k, depth, mask
    import cv2

    h, w = image.shape[:2]
    if camera_model.lower().startswith("fisheye"):
        d = dist[:4].astype(np.float64)
        newk = cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(
            k.astype(np.float64), d, (w, h), np.eye(3), balance=0
        )
        map1, map2 = cv2.fisheye.initUndistortRectifyMap(
            k.astype(np.float64), d, np.eye(3), newk, (w, h), cv2.CV_32FC1
        )
        und = lambda im, interp: cv2.remap(im, map1, map2, interpolation=interp)
        image = und(image, cv2.INTER_LINEAR)
        depth = und(depth, cv2.INTER_NEAREST) if depth is not None else None
        mask = (
            und(mask.astype(np.uint8), cv2.INTER_NEAREST).astype(bool)
            if mask is not None
            else None
        )
        return image, newk.astype(np.float32), depth, mask
    # perspective: distortion vector layout [k1 k2 k3 k4 p1 p2] -> cv2's
    # 5-coefficient model (k1, k2, p1, p2, k3); k4 unused for perspective.
    d = np.array(
        [dist[0], dist[1], dist[4], dist[5], dist[2]], np.float64
    )
    newk, roi = cv2.getOptimalNewCameraMatrix(
        k.astype(np.float64), d, (w, h), 0
    )
    image = cv2.undistort(image, k.astype(np.float64), d, None, newk)
    if depth is not None:
        depth = cv2.undistort(depth, k.astype(np.float64), d, None, newk)
    if mask is not None:
        mask = cv2.undistort(
            mask.astype(np.uint8) * 255, k.astype(np.float64), d, None, newk
        ) > 127
    x, y, rw, rh = roi
    if rw > 0 and rh > 0:
        image = image[y : y + rh, x : x + rw]
        depth = depth[y : y + rh, x : x + rw] if depth is not None else None
        mask = mask[y : y + rh, x : x + rw] if mask is not None else None
        newk = newk.copy()
        newk[0, 2] -= x
        newk[1, 2] -= y
    return image, newk.astype(np.float32), depth, mask


class FullImageDatamanager:
    """Loads/undistorts all frames once; serves random train cameras."""

    def __init__(
        self,
        config: DataparserConfig,
        seed: int = 42,
        num_shards: int = 1,
        shard_index: int = 0,
        load_depths: bool = True,
        splits=("train", "eval"),
    ):
        """``splits``: which splits to eagerly cache. Offline gs-eval only
        needs the eval frames; skipping the train cache saved 33 s of a
        ~78 s eval on the 240-view capture. The skip is only honored when
        it cannot change the cross-split uniformized crop (all declared
        frame sizes equal and no distortion — undistortion ROI crops are
        image-dependent); otherwise both splits load as before so
        offline metrics stay bit-identical to in-training eval."""
        self.config = config
        self.train_outputs = parse_transforms(config, split="train")
        try:
            self.eval_outputs = parse_transforms(config, split="val")
        except Exception:
            self.eval_outputs = None
        self._rng = np.random.default_rng(seed + shard_index)
        self.num_shards = num_shards
        self.shard_index = shard_index
        skip_train = "train" not in splits and self._skip_safe()
        self.train_frames = (
            [] if skip_train else self._cache(self.train_outputs, load_depths)
        )
        self.eval_frames = (
            self._cache(self.eval_outputs, load_depths)
            if self.eval_outputs is not None and self.eval_outputs.image_filenames
            else []
        )
        # Global (pre-shard) train-image count: refinement gating ("seen
        # every image since opacity reset", vanilla_gs.py:404-409) must use
        # the same value on every host or replicas desync at shard-boundary
        # steps.
        self.num_train_global = len(self.train_frames)
        if num_shards > 1:
            self.train_frames = self.train_frames[shard_index::num_shards]
        self._uniformize()
        self._unseen: List[int] = []

    def _skip_safe(self) -> bool:
        """True iff skipping a split cannot change the uniformized crop:
        every frame (both splits) declares the same size and zero
        distortion (no image-dependent undistortion ROI)."""
        outs = [self.train_outputs]
        if self.eval_outputs is not None:
            outs.append(self.eval_outputs)
        hs = np.concatenate([o.heights for o in outs])
        ws = np.concatenate([o.widths for o in outs])
        dist = np.concatenate([o.distortion for o in outs])
        return bool(
            (hs == hs[0]).all() and (ws == ws[0]).all()
            and not np.any(dist)
        )

    def _uniformize(self) -> None:
        """Crop all frames to the common minimum size (bottom/right edges),
        so every step sees one image shape and the train split stacks into
        one device cache. Undistortion ROI crops differ by a few pixels per
        camera; cropping the far edges keeps (cx, cy) valid. This is
        gstk_tpu's policy, kept so both packages train on the same pixels."""
        frames = self.train_frames + self.eval_frames
        if not frames:
            return
        h = min(f.image.shape[0] for f in frames)
        w = min(f.image.shape[1] for f in frames)
        for f in frames:
            f.image = f.image[:h, :w]
            if f.depth is not None:
                f.depth = f.depth[:h, :w]
            if f.mask is not None:
                f.mask = f.mask[:h, :w]

    # -- caching ----------------------------------------------------------
    def _cache(self, out: DataparserOutputs, load_depths: bool) -> List[CachedFrame]:
        frames = []
        n = len(out.image_filenames)
        for i in range(n):
            img = load_image(out.image_filenames[i]).astype(np.float32) / 255.0
            # RGBA kept as-is: the train/eval paths composite GT over the
            # *active* background (vanilla_gs.py:870-878) — premultiplying
            # here would bake in black and break random/white backgrounds
            depth = None
            if load_depths and out.depth_filenames:
                depth = load_depth(
                    out.depth_filenames[i], out.depth_unit_scale_factor
                )
                depth = depth * out.dataparser_scale
            mask = (
                load_mask(out.mask_filenames[i]) if out.mask_filenames else None
            )
            k = np.array(
                [
                    [out.fx[i], 0, out.cx[i]],
                    [0, out.fy[i], out.cy[i]],
                    [0, 0, 1],
                ],
                np.float32,
            )
            img, newk, depth, mask = _undistort_frame(
                img, k, out.distortion[i], out.camera_model, depth, mask
            )
            frames.append(
                CachedFrame(
                    image=img,
                    fx=float(newk[0, 0]),
                    fy=float(newk[1, 1]),
                    cx=float(newk[0, 2]),
                    cy=float(newk[1, 2]),
                    c2w=out.poses[i],
                    depth=depth,
                    mask=mask,
                    mono_scale=(
                        float(out.mono_depth_scales[i])
                        if out.mono_depth_scales is not None
                        else None
                    ),
                    mono_shift=(
                        float(out.mono_depth_shifts[i])
                        if out.mono_depth_shifts is not None
                        else None
                    ),
                )
            )
        return frames

    # -- sampling ---------------------------------------------------------
    @property
    def num_train(self) -> int:
        return len(self.train_frames)

    @property
    def image_size(self) -> Tuple[int, int]:
        """(H, W) of the common bucket (max over cached train frames)."""
        h = max(f.image.shape[0] for f in self.train_frames)
        w = max(f.image.shape[1] for f in self.train_frames)
        return h, w

    def next_train(self) -> Tuple[int, CachedFrame]:
        """Random unseen camera, reshuffling each epoch
        (full_images_datamanager.py:461-486)."""
        if not self._unseen:
            self._unseen = list(self._rng.permutation(self.num_train))
        idx = int(self._unseen.pop())
        return idx, self.train_frames[idx]

    def seed_points(self):
        out = self.train_outputs
        if out.points3d_xyz is None:
            return None
        return out.points3d_xyz, out.points3d_rgb.astype(np.float32)
