"""Surface-constrained Gaussian Splatting ("surface-gs"): the config (port
of ``gstk_tpu/models/surface.py``).

Vanilla with fixed means and no grad-driven densification: the trainer
passes ``frozen_groups=FROZEN_GROUPS`` to the train step, so the means get
zero gradients and never move, and the infinite densify threshold leaves
split and dup off while alpha and size culling go on.
"""

from __future__ import annotations

import dataclasses

from gstk_torch.models.vanilla import VanillaConfig


@dataclasses.dataclass(frozen=True)
class SurfaceConfig(VanillaConfig):
    freeze_means: bool = True
    # no grad-driven densification: splits/dups never trigger
    densify_grad_thresh: float = float("inf")


FROZEN_GROUPS = ("means",)
