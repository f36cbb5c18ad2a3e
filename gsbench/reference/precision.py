"""The arithmetic of the plain reference: float32 (the configuration's
precision, TF32 off), or the control's TF32, emulated.

Every product of the reference that a tensor core would take (matrix
products, ``einsum`` contractions and the SSIM convolutions) goes through
:class:`Arith`. With ``tf32=True`` the operands are rounded to TF32's
10-bit mantissa first and the sums stay in float32, which is what TF32
matrix units do; emulating it keeps the control the same on the card and
on the CPU, where no TF32 exists. The global TF32 flags stay off either
way (:func:`strict_f32`).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value (10 explicit
    mantissa bits, ties away from zero), still stored as float32; the
    backward's products then take the rounded operands too."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    # the gradient passes through the rounding unchanged
    return x + (rounded - x).detach() if x.requires_grad else rounded


class Arith:
    """Matrix products and convolutions in float32, or with TF32 operands."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def _r(self, x: torch.Tensor) -> torch.Tensor:
        return round_tf32(x) if self.tf32 else x

    def matmul(self, a, b):
        return torch.matmul(self._r(a), self._r(b))

    def einsum(self, spec: str, a, b):
        return torch.einsum(spec, self._r(a), self._r(b))

    def conv2d(self, x, w, groups: int):
        return F.conv2d(self._r(x), self._r(w), groups=groups)


@contextlib.contextmanager
def strict_f32():
    """cuBLAS and cuDNN in float32 inside the block (no TF32)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
