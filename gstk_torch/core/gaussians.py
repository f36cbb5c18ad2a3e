"""GaussianScene — padded Gaussian parameters with an alive mask (port of
``gstk_tpu/core/gaussians.py``).

The scene keeps a fixed capacity C with an ``alive`` mask, as gstk_tpu does,
so checkpoints and refinement semantics carry over between the packages.
Parameterization: log scales, logit opacities, wxyz quats (normalized at
use), SH features split into dc + rest.

:func:`scene_from_numpy` / :func:`scene_to_numpy` carry parameters across
packages as numpy arrays keyed by the checkpoint's field names.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gstk_torch import DeviceLike, resolve_device
from gstk_torch.ops.sh import num_sh_bases
from gstk_torch.utils.math import random_quats, rgb_to_sh

PARAM_NAMES = (
    "means", "scales", "quats", "features_dc", "features_rest", "opacities",
)
FIELD_NAMES = PARAM_NAMES + ("alive",)


class GaussianScene(nn.Module):
    """Padded Gaussian parameters. All leading dims are the capacity C.

    means (C,3); scales (C,3) log-scales; quats (C,4) wxyz, not necessarily
    normalized; features_dc (C,3); features_rest (C,K-1,3); opacities (C,1)
    logits — ``nn.Parameter``s; alive (C,) bool — a buffer."""

    def __init__(self, means, scales, quats, features_dc, features_rest,
                 opacities, alive):
        super().__init__()
        self.means = nn.Parameter(means)
        self.scales = nn.Parameter(scales)
        self.quats = nn.Parameter(quats)
        self.features_dc = nn.Parameter(features_dc)
        self.features_rest = nn.Parameter(features_rest)
        self.opacities = nn.Parameter(opacities)
        self.register_buffer("alive", alive)

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()

    def params(self) -> Dict[str, nn.Parameter]:
        """The optimizable parameters (alive mask excluded)."""
        return {name: getattr(self, name) for name in PARAM_NAMES}


def scene_from_numpy(arrays: Dict[str, np.ndarray], device: DeviceLike = None
                     ) -> GaussianScene:
    """Scene from numpy arrays keyed by field name (``means`` ... ``alive``),
    e.g. a gstk_tpu scene's fields or a checkpoint's ``.scene/.*`` entries."""
    device = resolve_device(device)
    # copies: training updates the parameters in place
    t = {
        k: torch.tensor(np.asarray(arrays[k], np.float32), device=device)
        for k in PARAM_NAMES
    }
    alive = torch.tensor(np.asarray(arrays["alive"], bool), device=device)
    return GaussianScene(**t, alive=alive)


def scene_to_numpy(scene: GaussianScene) -> Dict[str, np.ndarray]:
    """Numpy copy of every field, keyed by field name."""
    return {k: getattr(scene, k).detach().cpu().numpy() for k in FIELD_NAMES}


def _knn_mean_dist(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean distance to the k nearest neighbors (scale init)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    # k+1 because the nearest neighbor of each point is itself.
    d, _ = tree.query(points, k=k + 1)
    return d[:, 1:].mean(axis=1)


def init_scene(
    generator: torch.Generator,
    capacity: int,
    seed_points: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    num_random: int = 50_000,
    random_scale: float = 10.0,
    sh_degree: int = 3,
    init_opacity: float = 0.1,
    device: DeviceLike = None,
) -> GaussianScene:
    """A scene from SfM seed points (positions, rgb in [0,255]) or a random
    init, padded to ``capacity``: kNN mean-distance log scales, Shoemake
    random quats, RGB->SH DC features, logit(init_opacity) opacities.

    Random numbers come from ``generator`` (on its own device); for the
    same seed they differ from the ``jax.random`` draws of gstk_tpu."""
    device = resolve_device(device)
    gen_dev = generator.device
    if seed_points is not None and seed_points[0].shape[0] > 0:
        pts = np.asarray(seed_points[0], np.float32)
        rgb = np.asarray(seed_points[1], np.float32)
    else:
        u = torch.rand((num_random, 3), generator=generator, device=gen_dev)
        pts = ((u - 0.5) * random_scale).cpu().numpy().astype(np.float32)
        rgb = None
    n = pts.shape[0]
    if n > capacity:
        raise ValueError(f"seed points ({n}) exceed capacity ({capacity})")

    avg_dist = np.maximum(_knn_mean_dist(pts), 1e-7)
    scales = np.log(avg_dist)[:, None].repeat(3, axis=1).astype(np.float32)

    dim_sh = num_sh_bases(sh_degree)
    if rgb is not None:
        dc = rgb_to_sh(rgb / 255.0).astype(np.float32)
    else:
        dc = torch.rand((n, 3), generator=generator, device=gen_dev).cpu().numpy()

    def pad(x, fill=0.0):
        out = np.full((capacity,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return out

    quats = np.zeros((capacity, 4), np.float32)
    quats[:, 0] = 1.0
    quats[:n] = random_quats(generator, n).cpu().numpy()
    alive = np.zeros((capacity,), bool)
    alive[:n] = True
    logit = float(np.log(init_opacity / (1.0 - init_opacity)))
    return scene_from_numpy(
        {
            "means": pad(pts),
            "scales": pad(scales),
            "quats": quats,
            "features_dc": pad(dc),
            "features_rest": np.zeros((capacity, dim_sh - 1, 3), np.float32),
            "opacities": np.full((capacity, 1), logit, np.float32),
            "alive": alive,
        },
        device,
    )


def grow_scene(scene: GaussianScene, new_capacity: int) -> GaussianScene:
    """Capacity growth on the scene's device: pad with dead lanes (zeros,
    identity quats)."""
    if new_capacity < scene.capacity:
        raise ValueError(f"cannot shrink {scene.capacity} -> {new_capacity}")
    extra = new_capacity - scene.capacity

    def pad(x: torch.Tensor) -> torch.Tensor:
        x = x.detach()
        return torch.cat([x, x.new_zeros((extra,) + x.shape[1:])])

    fields = {k: pad(getattr(scene, k)) for k in FIELD_NAMES}
    fields["quats"][scene.capacity:, 0] = 1.0
    return GaussianScene(**fields)
