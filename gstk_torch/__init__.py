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

# the intra-op thread counts whose vector math has been settled
_SETTLED_THREADS = set()


def settle_cpu_math() -> None:
    """Run torch's float math kernels once on every intra-op thread.

    On the CPU torch computes ``exp``, ``log``, ``sqrt`` and the like of a
    float tensor through MKL's vector math (``aten/src/ATen/cpu/vml.h``),
    in chunks of 2048 values spread over the intra-op threads. The first
    such parallel call of a process can return one chunk off by up to
    about 1e-4 relative (torch 2.13 with MKL 2024.2 on 8 threads, about one
    process in four), so the same render differed from one process to the
    next; later calls agree bit for bit. One throwaway call of each
    function at the current thread count takes that first call."""
    n = torch.get_num_threads()
    if n in _SETTLED_THREADS:
        return
    x = torch.linspace(0.1, 0.7, 4096 * max(n, 1))  # in every domain
    for fn in (torch.exp, torch.expm1, torch.log, torch.log2, torch.log10,
               torch.log1p, torch.sqrt, torch.rsqrt, torch.sin, torch.cos,
               torch.tan, torch.tanh, torch.asin, torch.acos, torch.atan,
               torch.erf):
        fn(x)
    _SETTLED_THREADS.add(n)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else ``cuda``.

    Raises when no device was given and CUDA is absent: the port never moves
    quietly to the CPU. On the CPU it first settles torch's vector math
    (:func:`settle_cpu_math`), so results do not depend on the process."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gstk_torch runs on CUDA and no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cpu":
        settle_cpu_math()
    return device

