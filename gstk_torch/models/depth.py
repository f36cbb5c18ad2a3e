"""Depth-supervised Gaussian Splatting ("co-gs"): the config only (port of
``DepthConfig`` in ``gstk_tpu/models/depth.py``).

The method registry needs the dataclass; the depth-loss zoo and its train
path are a later slice (M14), and ``make_train_step`` raises
``NotImplementedError`` for this config until then.
"""

from __future__ import annotations

import dataclasses

from gstk_torch.models.vanilla import VanillaConfig


@dataclasses.dataclass(frozen=True)
class DepthConfig(VanillaConfig):
    """co-gs hyperparameters (depth_gs.py:39-145)."""

    num_downscales: int = 0
    stop_screen_size_at: int = 8000
    stop_split_at: int = 25_000
    use_sparse_loss: bool = False
    sparse_lambda: float = 0.1
    use_depth_loss: bool = True
    depth_lambda: float = 0.1
    depth_loss_start_iteration: int = 6_000
    depth_loss_stop_iteration: int = 25_000
    use_est_depth: bool = False
    use_pearson_depth: bool = False
    mono_depth_l1_start_iteration: int = 15_000
    use_scaled_est_depth: bool = False
    local_patch_size: int = 128
    use_depth_regularization: bool = False
    using_planar_loss: bool = False
    planar_loss_start_iteration: int = 10_000
    using_tv_loss: bool = False
