"""gstk_torch — the PyTorch / CUDA port of gstk_tpu for NVIDIA Hopper.

The module layout follows ``gstk_tpu`` so every module's counterpart is easy
to find. Plain tensor code is PyTorch; every Pallas kernel of ``gstk_tpu``
becomes a hand-written CUDA C++ kernel for ``sm_90a`` under ``csrc/``, built
on first use by :mod:`gstk_torch._build` and launched by a wrapper that keeps
a plain PyTorch twin beside it. A wrapper runs its twin only for tensors on
the CPU; for a CUDA tensor it launches its kernel or raises.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no CUDA device and no device given they raise (:func:`resolve_device`).

This package never imports ``jax`` or ``gstk_tpu``.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else ``cuda``.

    Raises when no device was given and CUDA is absent: the port never moves
    quietly to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gstk_torch runs on CUDA and no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)

