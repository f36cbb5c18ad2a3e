"""Named colors (port of ``gstk_tpu/utils/colors.py``)."""

from __future__ import annotations

import torch

COLORS_DICT = {
    "white": (1.0, 1.0, 1.0),
    "black": (0.0, 0.0, 0.0),
    "red": (1.0, 0.0, 0.0),
    "green": (0.0, 1.0, 0.0),
    "blue": (0.0, 0.0, 1.0),
    "yellow": (1.0, 1.0, 0.0),
    "cyan": (0.0, 1.0, 1.0),
    "magenta": (1.0, 0.0, 1.0),
    "gray": (0.5, 0.5, 0.5),
    "viser": (0.1490, 0.1647, 0.2157),  # viser default background
}

# nerfstudio's fixed eval background: the reference renders eval frames on
# it when background_color is "random" and composites RGBA GT over the same
# color, so in-training and offline eval use it alike.
EVAL_BACKGROUND = COLORS_DICT["viser"]


def get_color(color, device=None) -> torch.Tensor:
    """Name or RGB sequence -> (3,) float32 tensor in [0, 1]."""
    if isinstance(color, str):
        name = color.lower()
        if name not in COLORS_DICT:
            raise ValueError(f"unknown color {color!r}")
        return torch.tensor(COLORS_DICT[name], dtype=torch.float32,
                            device=device)
    rgb = torch.as_tensor(color, dtype=torch.float32, device=device)
    if rgb.shape != (3,):
        raise ValueError("color must be a name or a 3-sequence")
    return rgb
