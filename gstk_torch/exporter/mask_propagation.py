"""Temporal mask propagation over a frame sequence, the DEVA role (a copy
of ``gstk_tpu/exporter/mask_propagation.py``).

Per-frame detections are consolidated across time so the object mask does
not flicker along the trajectory: dense optical flow (Farneback) carries
masks between neighbouring frames, a forward and a backward chain fill
detection dropouts and override inconsistent detections, and a per-pixel
majority vote over {detection, forward chain, backward chain} gives the
final sequence.

Host-side numpy and OpenCV, imported only when masks are propagated:
without OpenCV, :func:`propagate_masks` raises an ``ImportError`` that
names ``--propagate-masks`` (it never returns the masks unpropagated).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def _cv2():
    """OpenCV, or an ImportError saying what needs it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "mask propagation (gs-export offline-tsdf --propagate-masks) "
            "needs OpenCV (cv2), which is not installed"
        ) from e
    return cv2


def _to_gray(img: np.ndarray) -> np.ndarray:
    cv2 = _cv2()

    if img.ndim == 3:
        return cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    return img


def _warp_mask(mask: np.ndarray, gray_src: np.ndarray,
               gray_dst: np.ndarray) -> np.ndarray:
    """Warp ``mask`` (living in the src frame) into the dst frame using
    backward dense flow: for every dst pixel, find where it came from in
    src and sample the mask there."""
    cv2 = _cv2()

    flow = cv2.calcOpticalFlowFarneback(
        gray_dst, gray_src, None,
        pyr_scale=0.5, levels=3, winsize=21, iterations=3,
        poly_n=5, poly_sigma=1.1, flags=0,
    )
    h, w = mask.shape
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    map_x = xs + flow[..., 0]
    map_y = ys + flow[..., 1]
    warped = cv2.remap(
        mask.astype(np.float32), map_x, map_y, cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_CONSTANT, borderValue=0.0,
    )
    return warped > 0.5


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    union = np.logical_or(a, b).sum()
    if union == 0:
        return 1.0
    return float(np.logical_and(a, b).sum()) / float(union)


def _consolidate(det: np.ndarray, carried: Optional[np.ndarray],
                 iou_floor: float) -> np.ndarray:
    """Keep the detection when it's consistent with the carried mask
    (IoU >= floor); an empty or inconsistent detection defers to the
    carry (DEVA's in-between-consolidation behavior)."""
    if carried is None or carried.sum() == 0:
        return det
    if det.sum() == 0:
        return carried
    if _iou(det, carried) >= iou_floor:
        return det
    return carried


def _chain(grays: Sequence[np.ndarray], dets: Sequence[np.ndarray],
           order: Sequence[int], iou_floor: float,
           seed: Optional[np.ndarray] = None) -> List[np.ndarray]:
    """One directional propagation pass: walk frames in ``order``, carrying
    the consolidated mask by flow warp. ``seed`` (optional) consolidates
    the FIRST frame of the walk too — without it the chain's first output
    is the raw detection, and endpoint flicker/dropout would survive the
    final vote (out[0] would equal dets[0] identically)."""
    out: List[Optional[np.ndarray]] = [None] * len(dets)
    prev_idx = None
    for t in order:
        det = dets[t]
        if prev_idx is None:
            cur = _consolidate(det, seed, iou_floor)
        else:
            carried = _warp_mask(out[prev_idx], grays[prev_idx], grays[t])
            cur = _consolidate(det, carried, iou_floor)
        out[t] = cur
        prev_idx = t
    return out  # type: ignore[return-value]


def propagate_masks(
    images: Sequence[np.ndarray],
    masks: Sequence[np.ndarray],
    iou_floor: float = 0.4,
) -> List[np.ndarray]:
    """Consolidate per-frame masks into a temporally consistent sequence.

    Args:
        images: per-frame uint8 RGB (or grayscale) images, ordered along
            the trajectory (consecutive frames should overlap).
        masks: per-frame (H, W) bool detections (e.g. GroundingDINO+SAM
            output) — may flicker: empty frames, or off-object detections.
        iou_floor: detections overlapping the flow-carried mask below this
            IoU are treated as detector flicker and overridden by the
            propagated mask.

    Returns:
        Per-frame (H, W) bool masks: majority vote of {detection,
        forward chain, backward chain} at every pixel.
    """
    _cv2()  # raise without OpenCV, even where nothing needs propagating
    n = len(images)
    if n != len(masks):
        raise ValueError(f"{n} images vs {len(masks)} masks")
    if n <= 1:
        return [np.asarray(m, bool) for m in masks]
    grays = [_to_gray(np.asarray(img)) for img in images]
    dets = [np.asarray(m, bool) for m in masks]
    # Endpoint consolidation: a plain forward chain starts from the raw
    # first detection, so frame-0 flicker/dropout would dominate the vote
    # (votes = 2*det + bwd there). Seed each chain with the OTHER
    # direction's verdict at its start frame: bwd_raw informs fwd[0], the
    # finished fwd informs bwd[n-1].
    bwd_raw = _chain(grays, dets, range(n - 1, -1, -1), iou_floor)
    fwd = _chain(grays, dets, range(n), iou_floor, seed=bwd_raw[0])
    bwd = _chain(grays, dets, range(n - 1, -1, -1), iou_floor,
                 seed=fwd[n - 1])
    out = []
    for t in range(n):
        votes = (
            dets[t].astype(np.uint8)
            + fwd[t].astype(np.uint8)
            + bwd[t].astype(np.uint8)
        )
        out.append(votes >= 2)
    return out
