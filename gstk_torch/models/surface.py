"""Surface-constrained Gaussian Splatting ("surface-gs"): the config (port
of ``gstk_tpu/models/surface.py``).

Vanilla with fixed means and no grad-driven densification. Its train path
is a later slice (M14): ``make_train_step`` raises ``NotImplementedError``
for this config until then.
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
