"""Checkpoint save and load (port of ``gstk_tpu/train/checkpoint.py``).

gstk_tpu writes one ``step-{step:09d}.ckpt.npz`` per save: the flattened
train state under path keys (``.scene/.means``, ``.adam/.mu/['means']``,
``.refine/.vis_counts``, ..., ``.step``, and with camera optimisation
``.cam_adjust``, ``.cam_adam/.count``, ``.cam_adam/.mu/['camera_opt']``
and ``.cam_adam/.nu/['camera_opt']``) plus scalar run metadata under
``.meta/`` (``isect_capacity``, ``bands``, ``sh_degree``). This module
reads and writes that layout with numpy alone, so a checkpoint written by
either package loads in the other: :func:`save_checkpoint` /
:func:`load_checkpoint` carry the full train state, :func:`save_scene`
writes a scene-only file for rendering, and :func:`train_state_to_numpy` /
:func:`train_state_from_numpy` give the flat arrays under the same keys.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gstk_torch import DeviceLike, resolve_device
from gstk_torch.core.gaussians import (
    FIELD_NAMES,
    PARAM_NAMES,
    GaussianScene,
    scene_from_numpy,
    scene_to_numpy,
)
from gstk_torch.parallel.mesh import GAUSS_AXIS, axis_of
from gstk_torch.train.optim import AdamState
from gstk_torch.train.step import TrainState
from gstk_torch.train.strategy import RefineState


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


def _moment_key(which: str, group: str, adam: str = ".adam") -> str:
    return f"{adam}/.{which}/['{group}']"


def peek_group(path, group: str = "means") -> Dict[str, np.ndarray]:
    """One parameter group of a checkpoint as numpy, without the rest of
    the state: the alive mask (``alive``), the group's values (``value``),
    its Adam moments (``mu``, ``nu``) and the Adam step count
    (``count``)."""
    with np.load(path) as data:
        return {"alive": data[".scene/.alive"],
                "value": data[f".scene/.{group}"],
                "mu": data[_moment_key("mu", group)],
                "nu": data[_moment_key("nu", group)],
                "count": int(data[".adam/.count"])}


_CAM_GROUP = "camera_opt"


def train_state_to_numpy(state: TrainState, mesh=None
                         ) -> Optional[Dict[str, np.ndarray]]:
    """The train state as numpy arrays under gstk_tpu's checkpoint keys.

    With a Gaussian ``mesh`` (every rank calls it), the capacity-leading
    tensors (scene, moments, statistics) are this rank's lanes: each comes
    back whole on index 0's host, assembled one rank's shard at a time
    (``Axis.gather_to_host``), so no device holds more than its shard and
    one other rank's shard of one tensor. The other ranks get None."""
    host = lambda x: x.detach().cpu().numpy()
    axis = None if mesh is None else axis_of(mesh, GAUSS_AXIS)

    def lanes(x: torch.Tensor) -> Optional[np.ndarray]:
        if axis is None:
            return host(x)
        whole = axis.gather_to_host(x)
        return None if whole is None else whole.numpy()

    flat = {f".scene/.{k}": lanes(getattr(state.scene, k)) for k in FIELD_NAMES}
    flat[".adam/.count"] = host(state.adam.count)
    for which, moments in (("mu", state.adam.mu), ("nu", state.adam.nu)):
        for group, v in moments.items():
            flat[_moment_key(which, group)] = lanes(v)
    for k in RefineState._fields:
        flat[f".refine/.{k}"] = lanes(getattr(state.refine, k))
    flat[".step"] = host(state.step)
    if state.cam_adjust is not None:
        flat[".cam_adjust"] = host(state.cam_adjust)
        flat[".cam_adam/.count"] = host(state.cam_adam.count)
        for which in ("mu", "nu"):
            flat[_moment_key(which, _CAM_GROUP, ".cam_adam")] = host(
                getattr(state.cam_adam, which)[_CAM_GROUP])
    if axis is not None and axis.index != 0:
        return None
    return flat


def train_state_from_numpy(arrays: Dict[str, np.ndarray],
                           device: DeviceLike = None) -> TrainState:
    """A train state (copies, on ``device``) from arrays under gstk_tpu's
    checkpoint keys, e.g. an ``np.load`` of its checkpoint; the camera-opt
    group when the arrays hold ``.cam_adjust``."""
    device = resolve_device(device)
    scene = scene_from_numpy(
        {k: arrays[f".scene/.{k}"] for k in FIELD_NAMES}, device
    )
    t = lambda key, dtype: torch.tensor(np.asarray(arrays[key]), dtype=dtype,
                                        device=device)
    f32 = torch.float32
    adam = AdamState(
        count=t(".adam/.count", torch.int32),
        mu={g: t(_moment_key("mu", g), f32) for g in PARAM_NAMES},
        nu={g: t(_moment_key("nu", g), f32) for g in PARAM_NAMES},
    )
    refine = RefineState(*(t(f".refine/.{k}", f32) for k in RefineState._fields))
    cam_adjust = cam_adam = None
    if ".cam_adjust" in arrays:
        cam_adjust = t(".cam_adjust", f32)
        cam_adam = AdamState(
            count=t(".cam_adam/.count", torch.int32),
            **{which: {_CAM_GROUP: t(_moment_key(which, _CAM_GROUP,
                                                 ".cam_adam"), f32)}
               for which in ("mu", "nu")},
        )
    return TrainState(scene=scene, adam=adam, refine=refine,
                      step=t(".step", torch.int32), cam_adjust=cam_adjust,
                      cam_adam=cam_adam)


def save_checkpoint(ckpt_dir, state: TrainState, keep_only_latest: bool = True,
                    extras: Optional[dict] = None, mesh=None
                    ) -> Optional[Path]:
    """Write the train state and ``extras`` (scalar run metadata, saved as
    ``.meta/<key>``: the grown ``isect_capacity`` and ``bands``, the active
    ``sh_degree``) as ``step-{step:09d}.ckpt.npz``; with
    ``keep_only_latest`` the directory's other checkpoints are deleted.
    With a Gaussian ``mesh`` every rank calls it with its shard and index 0
    writes the whole state (the bytes one process writes), assembled on its
    host by :func:`train_state_to_numpy`; the other ranks return None."""
    flat = train_state_to_numpy(state, mesh)
    if flat is None:
        return None
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"step-{int(flat['.step']):09d}.ckpt.npz"
    for k, v in (extras or {}).items():
        flat[f".meta/{k}"] = np.asarray(v)
    np.savez(path, **flat)
    if keep_only_latest:
        for p in ckpt_dir.glob("step-*.ckpt.npz"):
            if p != path:
                p.unlink()
    return path


def load_checkpoint(path, template: TrainState) -> TrainState:
    """The checkpoint's train state on ``template``'s device. Where the
    template has a larger capacity, arrays are padded with zeros (dead
    lanes); a key the checkpoint lacks keeps the template's value (the
    camera-opt group enabled after the checkpoint was written), and one
    the template lacks is not read."""
    arrays = train_state_to_numpy(template)
    with np.load(path) as data:
        for key, leaf in arrays.items():
            if key not in data.files:
                continue
            arr = data[key]
            if arr.shape != leaf.shape:
                if arr.ndim != leaf.ndim or any(
                        a > b for a, b in zip(arr.shape, leaf.shape)):
                    raise ValueError(
                        f"{key}: checkpoint shape {arr.shape} does not fit "
                        f"template {leaf.shape}"
                    )
                arr = np.pad(arr, [(0, b - a) for a, b in zip(arr.shape, leaf.shape)])
            arrays[key] = arr
    return train_state_from_numpy(arrays, template.scene.means.device)
