"""Checkpoint reading and scene writing (port of the scene half of
``gstk_tpu/train/checkpoint.py``).

gstk_tpu writes one ``step-{step:09d}.ckpt.npz`` per save: the flattened
train state under path keys (``.scene/.means``, ..., ``.step``) plus scalar
run metadata under ``.meta/`` (``isect_capacity``, ``bands``,
``sh_degree``). This module reads that layout with numpy alone, and
:func:`save_scene` writes a scene-only file in the same layout, which both
packages can load for rendering.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from gstk_torch import DeviceLike
from gstk_torch.core.gaussians import (
    FIELD_NAMES,
    GaussianScene,
    scene_from_numpy,
    scene_to_numpy,
)


def save_scene(ckpt_dir, scene: GaussianScene, step: int = 0,
               extras: Optional[dict] = None) -> Path:
    """Write the scene, the step and ``extras`` (saved as ``.meta/<key>``)
    as a gstk_tpu-layout checkpoint; returns its path."""
    path = Path(ckpt_dir) / f"step-{step:09d}.ckpt.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {f".scene/.{k}": v for k, v in scene_to_numpy(scene).items()}
    flat[".step"] = np.asarray(step, np.int32)
    for k, v in (extras or {}).items():
        flat[f".meta/{k}"] = np.asarray(v)
    np.savez(path, **flat)
    return path


def peek_meta(path) -> dict:
    """Scalar run metadata stored under ``.meta/``."""
    with np.load(path) as data:
        return {
            k[len(".meta/"):]: data[k].item()
            for k in data.files if k.startswith(".meta/")
        }


def latest_checkpoint(ckpt_dir) -> Optional[Path]:
    best, best_step = None, -1
    for p in Path(ckpt_dir).glob("step-*.ckpt.npz"):
        m = re.match(r"step-(\d+)\.ckpt\.npz", p.name)
        if m and int(m.group(1)) > best_step:
            best, best_step = p, int(m.group(1))
    return best


def load_scene(path, device: DeviceLike = None) -> Tuple[GaussianScene, int]:
    """The GaussianScene and step of a checkpoint — enough to render."""
    with np.load(path) as data:
        arrays = {k: data[f".scene/.{k}"] for k in FIELD_NAMES}
        step = int(data[".step"]) if ".step" in data.files else 0
    return scene_from_numpy(arrays, device), step


def peek_capacity(path) -> Optional[int]:
    """Gaussian capacity stored in a checkpoint, without loading it all."""
    with np.load(path) as data:
        if ".scene/.means" in data.files:
            return int(data[".scene/.means"].shape[0])
    return None
