"""Densification statistics (port of the state half of
``gstk_tpu/train/strategy.py``).

The train step accumulates these between refine steps. ``update_stats``,
the cull criteria and ``refine`` itself (split, duplicate, cull, opacity
reset at a static capacity) are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gstk_torch import DeviceLike, resolve_device


class RefineState(NamedTuple):
    """Densification statistics accumulated between refine steps."""

    xys_grad_norm: torch.Tensor  # (C,) summed screen-space grad norms
    vis_counts: torch.Tensor  # (C,) number of steps each Gaussian was visible
    max_2dsize: torch.Tensor  # (C,) max radius / max(H, W) seen


def init_refine_state(capacity: int, device: DeviceLike = None) -> RefineState:
    device = resolve_device(device)
    z = lambda: torch.zeros((capacity,), dtype=torch.float32, device=device)
    return RefineState(xys_grad_norm=z(), vis_counts=z(), max_2dsize=z())
