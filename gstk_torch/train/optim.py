"""Per-group Adam with LR schedules and per-lane moment surgery (port of
``gstk_tpu/train/optim.py``).

A hand-written Adam with torch.optim.Adam's update rule (eps outside the
sqrt), because ``torch.optim.Adam`` has no update mask and adaptive density
control edits the moments per lane. Schedules return float32 tensors on the
step's device. Default learning rates are the reference method config:
means 1.6e-4 (exponential decay to 1.6e-6 over 30k steps), features_dc
2.5e-3, features_rest 1.25e-4, opacities 5e-2, scales 5e-3, quats 1e-3.

On the card :func:`adam_step` is one launch of a CUDA kernel for all the
groups (:mod:`gstk_torch.train.adam_cuda`), which computes the rates from
the device's step; :func:`adam_step_plain` is its twin, the path on the
CPU and under the ``"plain"`` backend.

Unlike gstk_tpu's pure functions, :func:`adam_step`,
:func:`zero_moments_at` and :func:`zero_moments_group` update the
parameters and moments in place: the state is C-sized per group, and a copy
per step would only cost memory.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from gstk_torch._build import takes_kernels
from gstk_torch.train import adam_cuda

Params = Dict[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]


class AdamState(NamedTuple):
    count: torch.Tensor  # () int32 step count, shared by the groups
    mu: Params
    nu: Params


def _f32(x, like=None) -> torch.Tensor:
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def exponential_decay(
    lr_init: float,
    lr_final: float,
    max_steps: int,
    warmup_steps: int = 0,
    lr_pre_warmup: float = 1e-8,
) -> Schedule:
    """Log-linear decay from ``lr_init`` to ``lr_final`` over ``max_steps``,
    with an optional sine warmup from ``lr_pre_warmup``."""

    def schedule(step):
        step = _f32(step, step)
        if warmup_steps > 0:
            w = lr_pre_warmup + (lr_init - lr_pre_warmup) * torch.sin(
                0.5 * math.pi * torch.clamp(step / warmup_steps, 0.0, 1.0)
            )
        else:
            w = _f32(lr_init, step)
        t = torch.clamp(
            (step - warmup_steps) / max(max_steps - warmup_steps, 1), 0.0, 1.0
        )
        decayed = torch.exp(
            torch.log(_f32(lr_init, step)) * (1.0 - t)
            + torch.log(_f32(lr_final, step)) * t
        )
        return torch.where(step < warmup_steps, w, decayed)

    return schedule


def multistep_decay(
    lr_init: float, milestones: tuple, gamma: float = 0.33
) -> Schedule:
    """``lr_init * gamma**k`` after the k-th milestone."""

    def schedule(step):
        step = _f32(step, step)
        n = torch.zeros_like(step)
        for m in milestones:
            n = n + (step >= m).to(torch.float32)
        return lr_init * gamma**n

    return schedule


def cosine_decay(
    lr_init: float, max_steps: int, lr_final: float = 0.0,
    warmup_steps: int = 0,
) -> Schedule:
    """Cosine decay from ``lr_init`` to ``lr_final`` with a linear warmup."""

    def schedule(step):
        step = _f32(step, step)
        warm = lr_init * torch.clamp(step / max(warmup_steps, 1), 0.0, 1.0)
        t = torch.clamp(
            (step - warmup_steps) / max(max_steps - warmup_steps, 1), 0.0, 1.0
        )
        cos = lr_final + 0.5 * (lr_init - lr_final) * (
            1.0 + torch.cos(math.pi * t)
        )
        return torch.where(step < warmup_steps, warm, cos)

    return schedule


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Per-group learning rates; groups missing here fall back to 1e-3."""

    lrs: tuple = (
        ("means", 1.6e-4),
        ("features_dc", 2.5e-3),
        ("features_rest", 2.5e-3 / 20),
        ("opacities", 5e-2),
        ("scales", 5e-3),
        ("quats", 1e-3),
    )
    means_lr_final: float = 1.6e-6
    means_max_steps: int = 30_000
    # extra per-group exponential decays: ((group, lr_final, max_steps), ...)
    extra_exp: tuple = ()
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-15
    # optional per-group gradient norm clip; None disables
    max_norm: Optional[float] = None

    def lr_for(self, group: str) -> float:
        return dict(self.lrs).get(group, 1e-3)

    def decay_for(self, group: str) -> Optional[Tuple[float, int]]:
        """``(lr_final, max_steps)`` of the group's exponential decay from
        :meth:`lr_for`, None when its rate is constant."""
        if group == "means":
            return self.means_lr_final, self.means_max_steps
        for name, lr_final, max_steps in self.extra_exp:
            if name == group:
                return lr_final, max_steps
        return None

    def schedule_for(self, group: str) -> Schedule:
        base = self.lr_for(group)
        decay = self.decay_for(group)
        if decay is not None:
            return exponential_decay(base, *decay)
        return lambda step: _f32(base, step)


def init_adam(params: Params) -> AdamState:
    """Zero moments shaped like ``params``, on their devices."""
    first = next(iter(params.values()))
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=first.device),
        mu={k: torch.zeros_like(v, memory_format=torch.contiguous_format)
            for k, v in params.items()},
        nu={k: torch.zeros_like(v, memory_format=torch.contiguous_format)
            for k, v in params.items()},
    )


def _lanes(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (C,) mask shaped to broadcast over ``like`` (C, ...)."""
    return mask.reshape(mask.shape + (1,) * (like.ndim - mask.ndim))


def _masked(g: torch.Tensor, update_mask: Optional[torch.Tensor]):
    if update_mask is None:
        return g
    return torch.where(_lanes(update_mask, g), g, 0.0)


def _clip_scale(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that brings ``g``'s norm down to ``max_norm``, at most 1
    (a 0-d tensor on ``g``'s device)."""
    norm = torch.linalg.norm(g)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


@torch.no_grad()
def adam_step(
    params: Params,
    grads: Params,
    state: AdamState,
    step: torch.Tensor,
    config: OptimizerConfig = OptimizerConfig(),
    update_mask: Optional[torch.Tensor] = None,
    backend: str = "auto",
) -> AdamState:
    """One Adam step (torch semantics) on every group of ``params``, in
    place: the parameters and the moments of ``state`` are updated where
    they lie, and the returned state (sharing them) carries count + 1.

    ``update_mask`` (C,) freezes dead capacity lanes: their gradient and
    update are zeroed, so their parameters stay put while their moments
    decay. ``step`` drives the learning-rate schedules. ``backend`` is the
    rasterizer's (``RasterizeConfig.backend``): where it takes the kernels
    (:func:`gstk_torch._build.takes_kernels`: CUDA tensors under
    ``"auto"``), one launch of :func:`~gstk_torch.train.adam_cuda.adam_fused`
    steps every group, else :func:`adam_step_plain`, its twin, does. A
    norm clip's scales are then computed on the device, a group each."""
    device = next(iter(params.values())).device
    if not takes_kernels(device, backend):
        return adam_step_plain(params, grads, state, step, config,
                               update_mask)
    clip = None
    if config.max_norm is not None:
        clip = torch.stack([
            _clip_scale(_masked(grads[k], update_mask), config.max_norm)
            for k in params])
    return adam_cuda.adam_fused(params, grads, state, step, config,
                                update_mask, clip)


@torch.no_grad()
def adam_step_plain(
    params: Params,
    grads: Params,
    state: AdamState,
    step: torch.Tensor,
    config: OptimizerConfig = OptimizerConfig(),
    update_mask: Optional[torch.Tensor] = None,
) -> AdamState:
    """:func:`adam_step` in plain PyTorch ops, on any device: the twin of
    the fused kernel."""
    count = state.count + 1
    count_f = count.to(torch.float32)
    c1 = 1.0 - config.b1 ** count_f
    c2 = 1.0 - config.b2 ** count_f
    for name, p in params.items():
        g = _masked(grads[name], update_mask)
        if config.max_norm is not None:
            g = g * _clip_scale(g, config.max_norm)
        mu, nu = state.mu[name], state.nu[name]
        mu.copy_(config.b1 * mu + (1.0 - config.b1) * g)
        nu.copy_(config.b2 * nu + (1.0 - config.b2) * (g * g))
        lr = config.schedule_for(name)(step)
        update = lr * (mu / c1) / (torch.sqrt(nu / c2) + config.eps)
        if update_mask is not None:
            update = torch.where(_lanes(update_mask, update), update, 0.0)
        p.sub_(update)
    return AdamState(count=count, mu=state.mu, nu=state.nu)


@torch.no_grad()
def zero_moments_at(
    state: AdamState, slots: torch.Tensor, active: torch.Tensor
) -> AdamState:
    """Zero every group's moments at ``slots`` where ``active``, in place
    (new Gaussians start with fresh moments). Inactive slots and slots past
    the capacity are dropped, whatever their value."""
    capacity = next(iter(state.mu.values())).shape[0]
    keep = active & (slots >= 0) & (slots < capacity)
    hit = torch.zeros(capacity + 1, dtype=torch.bool, device=slots.device)
    hit[torch.where(keep, slots.long(), capacity)] = True
    hit = hit[:capacity]
    for moments in (state.mu, state.nu):
        for v in moments.values():
            v.masked_fill_(_lanes(hit, v), 0.0)
    return state


@torch.no_grad()
def zero_moments_group(state: AdamState, group: str,
                       when: Optional[torch.Tensor] = None) -> AdamState:
    """Zero a whole group's moments in place (the opacity reset). With
    ``when``, a 0-d bool tensor, only if it holds, without a host sync."""
    for v in (state.mu[group], state.nu[group]):
        if when is None:
            v.zero_()
        else:
            v.masked_fill_(when, 0.0)
    return state
