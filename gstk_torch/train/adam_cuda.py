"""Adam for every group of one optimiser state in one CUDA launch
(``csrc/adam_fused.cu``).

The plain twin is :func:`gstk_torch.train.optim.adam_step_plain`;
:func:`gstk_torch.train.optim.adam_step` takes this path for CUDA tensors
under the ``"auto"`` backend. The kernel repeats the twin's f32 operations
in their order, and computes the learning rates and bias corrections from
the device's step and count, so nothing is uploaded from the host and the
launch needs no stream sync. A gradient norm clip comes in as one scale a
group, computed on the device by the caller.

The parameters and moments are updated in place, as the twin updates them;
the wrapper bumps their autograd version counters, which a write through a
raw pointer leaves alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gstk_torch import _build

MAX_GROUPS = 8  # csrc/adam_fused.cu kMaxGroups
MAX_NUMEL = 0x7FFFFFF0  # elements a group, so the kernel indexes in 32 bits

# groups; p, g, m, v pointer arrays; numels, widths, decays; lrs,
# lr_finals, inv_steps; b1, b2, 1 - b1, 1 - b2, eps; mask, clip, step,
# count in, count out, stream
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_void_p] * 3
             + [ctypes.c_void_p] * 3 + [ctypes.c_float] * 5
             + [ctypes.c_void_p] * 6)

Shapes = Tuple[Tuple[str, Tuple[int, ...]], ...]


class Group(NamedTuple):
    """One row of the kernel's group table."""

    name: str
    numel: int
    width: int  # elements a lane: a row of the update mask
    lr: float  # the constant rate, or the decay's first
    decay: Optional[Tuple[float, int]]  # (lr_final, max_steps); None: constant


def _f32(x: float) -> float:
    return float(np.float32(x))


@functools.lru_cache(maxsize=64)
def _table(config, shapes: Shapes):
    """The group table of groups with ``shapes`` under ``config``, and the
    launch arguments that follow from it alone: built once for each, since
    the shapes change only when the capacity grows."""
    table = []
    for name, shape in shapes:
        numel = int(np.prod(shape, dtype=np.int64))
        rows = shape[0] if shape else 1
        width = numel // rows if rows else 1
        table.append(Group(name, numel, max(width, 1), config.lr_for(name),
                           config.decay_for(name)))
    n = len(table)
    arrays = lambda kind, xs: (kind * n)(*xs)
    args = (
        arrays(ctypes.c_longlong, (t.numel for t in table)),
        arrays(ctypes.c_int, (t.width for t in table)),
        arrays(ctypes.c_int, (int(t.decay is not None) for t in table)),
        arrays(ctypes.c_float, (_f32(t.lr) for t in table)),
        arrays(ctypes.c_float, (_f32(t.decay[0]) if t.decay else 0.0
                                for t in table)),
        arrays(ctypes.c_float, (
            _f32(np.float32(1) / np.float32(max(t.decay[1], 1)))
            if t.decay else 0.0 for t in table)),
        _f32(config.b1), _f32(config.b2), _f32(1.0 - config.b1),
        _f32(1.0 - config.b2), _f32(config.eps),
    )
    return tuple(table), args


def group_table(params: Dict[str, torch.Tensor], config) -> Tuple[Group, ...]:
    """The groups of ``params`` in their order, with the schedule of
    ``config`` (an :class:`~gstk_torch.train.optim.OptimizerConfig`)."""
    return _table(config, tuple((k, tuple(p.shape))
                                for k, p in params.items()))[0]


def _check(tensors, n: int, device, update_mask, clip, step, count) -> None:
    """What keeps the kernel's reads and writes inside the tensors: the
    device, dtype, element count and layout of each."""
    if not 1 <= n <= MAX_GROUPS:
        raise ValueError(f"adam_fused: 1 to {MAX_GROUPS} groups, got {n}")
    if device.type != "cuda":
        raise ValueError(f"adam_fused: takes CUDA tensors, got {device}")
    rows = []
    for name, p, g, m, v in tensors:
        rows.append(p.shape[0] if p.ndim else 1)
        if p.numel() > MAX_NUMEL:
            raise ValueError(f"adam_fused: {name}: {p.numel()} elements, "
                             f"at most {MAX_NUMEL}")
        for x in (p, g, m, v):
            if (x.dtype != torch.float32 or x.device != device
                    or x.numel() != p.numel() or not x.is_contiguous()):
                raise ValueError(
                    f"adam_fused: {name}: the parameter, gradient and "
                    f"moments must be contiguous float32 on {device} with "
                    f"{p.numel()} elements")
    if update_mask is not None and (
            update_mask.dtype != torch.bool or update_mask.device != device
            or not update_mask.is_contiguous()
            or any(r != update_mask.numel() for r in rows)):
        raise ValueError("adam_fused: the update mask must be a contiguous "
                         f"bool tensor on {device} with a lane for each of "
                         f"the groups' rows {rows}")
    if clip is not None and (clip.dtype != torch.float32
                             or clip.device != device or clip.numel() != n
                             or not clip.is_contiguous()):
        raise ValueError(f"adam_fused: the clip scales must be {n} "
                         f"contiguous float32 on {device}")
    for what, x in (("step", step), ("count", count)):
        if x.dtype != torch.int32 or x.device != device or x.numel() != 1:
            raise ValueError(f"adam_fused: the {what} must be one int32 on "
                             f"{device}")


def adam_fused(params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state, step: torch.Tensor,
               config, update_mask: Optional[torch.Tensor] = None,
               clip: Optional[torch.Tensor] = None):
    """:func:`~gstk_torch.train.optim.adam_step_plain`'s step of every group
    of ``params`` in one launch, in place; returns the state with count + 1
    (a new 0-d tensor written by the kernel). ``clip`` (one float32 a group,
    on the device) scales each group's masked gradient, as the twin's norm
    clip does; None scales nothing."""
    names = list(params)
    params_ = [params[k] for k in names]
    # a gradient that is not contiguous (a view of a gathered buffer) is
    # copied; an aligned one is read with 16-B loads
    g = [grads[k].contiguous() for k in names]
    mus, nus = [state.mu[k] for k in names], [state.nu[k] for k in names]
    device = params_[0].device
    _check(zip(names, params_, g, mus, nus), len(names), device, update_mask,
           clip, step, state.count)
    _, args = _table(config, tuple((k, tuple(p.shape))
                                   for k, p in zip(names, params_)))
    ptrs = lambda xs: (ctypes.c_void_p * len(names))(
        *(x.data_ptr() for x in xs))
    count = torch.empty((), dtype=torch.int32, device=device)
    fn = _build.kernel_function("gstk_adam_fused", _ARGTYPES)
    with torch.cuda.device(device):
        err = fn(
            len(names), ptrs(params_), ptrs(g), ptrs(mus), ptrs(nus), *args,
            None if update_mask is None else update_mask.data_ptr(),
            None if clip is None else clip.data_ptr(),
            step.data_ptr(), state.count.data_ptr(), count.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _build.check("adam_fused", err)
    _build.count_launch(adam_fused)
    for x in (*params_, *mus, *nus):
        torch.autograd.graph.increment_version(x)
    return state._replace(count=count)


adam_fused.launches = 0
