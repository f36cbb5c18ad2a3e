"""Text-prompted object masking for TSDF export (a copy of
``gstk_tpu/exporter/mask_generation.py``).

Pretrained weights are not bundled, so this module offers:

  * ``try_load_grounded_sam``: the GroundingDINO + SAM chain through
    transformers (imported only there), loaded from *local* checkpoint
    directories ($GSTK_GDINO_MODEL_DIR + $GSTK_SAM_MODEL_DIR, see
    docs/WEIGHTS.md); it returns False where transformers or the
    directories are absent;
  * a registry hook (``register_mask_model``) so any other weights-equipped
    pipeline can plug in unchanged;
  * lightweight built-in fallbacks (``threshold`` on rendered accumulation,
    ``box`` crop, ``none``): explicit named choices, never silent
    substitutions.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

_MASK_MODELS: Dict[str, Callable] = {}


def register_mask_model(name: str, fn: Callable) -> None:
    """Register a mask generator: fn(images, prompt) -> list of (H,W) bool."""
    _MASK_MODELS[name] = fn


def try_load_grounded_sam(
    gdino_dir=None, sam_dir=None, box_threshold: float = 0.3
) -> bool:
    """Register the GroundingDINO->SAM chain from local transformers
    checkpoints (reference mask_generater.py:24 behavior: text prompt ->
    boxes -> per-box masks -> union). Returns False when either checkpoint
    directory is missing."""
    gdino_dir = gdino_dir or os.environ.get("GSTK_GDINO_MODEL_DIR")
    sam_dir = sam_dir or os.environ.get("GSTK_SAM_MODEL_DIR")
    if not gdino_dir or not sam_dir:
        return False
    if not Path(gdino_dir).exists() or not Path(sam_dir).exists():
        return False
    try:
        import torch
        from transformers import (
            AutoProcessor,
            GroundingDinoForObjectDetection,
            SamModel,
            SamProcessor,
        )

        gdino = GroundingDinoForObjectDetection.from_pretrained(
            gdino_dir, local_files_only=True
        ).eval()
        gproc = AutoProcessor.from_pretrained(gdino_dir, local_files_only=True)
        sam = SamModel.from_pretrained(sam_dir, local_files_only=True).eval()
        sproc = SamProcessor.from_pretrained(sam_dir, local_files_only=True)

        def run(images, prompt):
            masks = []
            text = (prompt or "object").strip().rstrip(".") + "."
            with torch.no_grad():
                for img in images:
                    h, w = img.shape[:2]
                    gi = gproc(images=img, text=text, return_tensors="pt")
                    gout = gdino(**gi)
                    res = gproc.post_process_grounded_object_detection(
                        gout, gi["input_ids"], threshold=box_threshold,
                        target_sizes=[(h, w)],
                    )[0]
                    boxes = res["boxes"]
                    if boxes.numel() == 0:
                        masks.append(np.zeros((h, w), bool))
                        continue
                    si = sproc(
                        img, input_boxes=[boxes.tolist()],
                        return_tensors="pt",
                    )
                    sout = sam(**si)
                    pm = sproc.image_processor.post_process_masks(
                        sout.pred_masks.cpu(),
                        si["original_sizes"].cpu(),
                        si["reshaped_input_sizes"].cpu(),
                    )[0]
                    union = (
                        pm.flatten(0, 1).any(dim=0).numpy().astype(bool)
                    )
                    masks.append(union)
            return masks

        register_mask_model("grounded_sam", run)
        return True
    except Exception as e:  # pragma: no cover - depends on local weights
        import sys

        print(f"grounded-sam load failed: {e}", file=sys.stderr)
        return False


def generate_masks(
    images: List[np.ndarray],
    prompt: Optional[str] = None,
    method: str = "threshold",
    accumulations: Optional[List[np.ndarray]] = None,
    threshold: float = 0.5,
    box: Optional[tuple] = None,
) -> List[np.ndarray]:
    """Produce per-frame masks.

    method: a registered model name (e.g. "grounded_sam", auto-registered
    from local checkpoints by try_load_grounded_sam), or one of the
    built-ins: "threshold" (accumulation > threshold), "box" (normalized
    (x0, y0, x1, y1) crop), "none".
    """
    if method == "grounded_sam" and method not in _MASK_MODELS:
        try_load_grounded_sam()
    if method in _MASK_MODELS:
        return _MASK_MODELS[method](images, prompt)
    if method == "none":
        return [np.ones(img.shape[:2], bool) for img in images]
    if method == "threshold":
        if accumulations is None:
            raise ValueError("threshold masking needs accumulation maps")
        return [acc > threshold for acc in accumulations]
    if method == "box":
        if box is None:
            raise ValueError("box masking needs a (x0,y0,x1,y1) box")
        out = []
        for img in images:
            h, w = img.shape[:2]
            m = np.zeros((h, w), bool)
            x0, y0, x1, y1 = box
            m[int(y0 * h) : int(y1 * h), int(x0 * w) : int(x1 * w)] = True
            out.append(m)
        return out
    raise ValueError(
        f"unknown mask method '{method}'; text-prompted segmentation "
        "(GroundingDINO+SAM) requires registering a model via "
        "register_mask_model — pretrained weights are not bundled."
    )
