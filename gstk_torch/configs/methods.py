"""Method registry: named TrainerConfigs (port of
``gstk_tpu/configs/methods.py``, the same table).

Equivalent of ``gs_toolkit/configs/method_configs.py:28-229``. Three methods
with the reference's hyperparameters:
  * ``gaussian-splatting`` — vanilla 3DGS, 15k iters;
  * ``co-gs``            — depth/planar-supervised, 30k iters;
  * ``surface-gs``       — frozen-means surface refinement, 15k iters.
Optimizer LRs are the shared reference dict (method_configs.py:47-81) and
live in OptimizerConfig defaults. All three train through the port's
trainer, each with ``camera_opt`` "off", "SO3xR3" or "SE3".
"""

from __future__ import annotations

from typing import Dict

from gstk_torch.models.depth import DepthConfig
from gstk_torch.models.surface import SurfaceConfig
from gstk_torch.models.vanilla import VanillaConfig
from gstk_torch.train.trainer import TrainerConfig

descriptions = {
    "gaussian-splatting": "Vanilla Gaussian Splatting model.",
    "co-gs": "Gaussian Splatting with depth / planar supervision.",
    "surface-gs": "Gaussian Splatting with fixed means on the surface.",
    "sugar-gs": "SuGaR surface-aligned refinement (reserved; the "
                "reference's pipelines/sugar_pipeline.py is an empty "
                "placeholder — this slot mirrors it 1:1 and fails loudly).",
}

# Methods listed in the registry but not runnable: the reference ships
# ``gs_toolkit/pipelines/sugar_pipeline.py`` as a ZERO-BYTE placeholder
# (no config entry, no class); we mirror the slot so the method table is
# 1:1 while refusing to pretend there is an implementation behind it.
experimental_methods = ("sugar-gs",)


def method_configs() -> Dict[str, TrainerConfig]:
    return {
        "gaussian-splatting": TrainerConfig(
            method_name="gaussian-splatting",
            max_num_iterations=15_000,
            model=VanillaConfig(),
        ),
        "co-gs": TrainerConfig(
            method_name="co-gs",
            max_num_iterations=30_000,
            model=DepthConfig(),
        ),
        "surface-gs": TrainerConfig(
            method_name="surface-gs",
            max_num_iterations=15_000,
            model=SurfaceConfig(),
        ),
    }
