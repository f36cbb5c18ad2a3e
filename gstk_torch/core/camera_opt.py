"""Learned camera-pose refinement: the config only (port of the config of
``gstk_tpu/core/camera_opt.py``).

The method registry and the trainer's config need the dataclass; the pose
deltas and their Adam group are the depth and surface methods' slice
(M14), and the trainer raises ``NotImplementedError`` for any mode but
"off".
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class CameraOptConfig:
    """Reference CameraOptimizerConfig (camera_optimizers.py:22-40) + its
    Adam group (method_configs.py:75-80)."""

    mode: Literal["off", "SO3xR3", "SE3"] = "off"
    trans_l2_penalty: float = 1e-2
    rot_l2_penalty: float = 1e-3
    lr: float = 1e-3
    lr_final: float = 5e-5
    max_steps: int = 30_000
