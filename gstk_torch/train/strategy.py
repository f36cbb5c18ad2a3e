"""Adaptive density control: densification statistics, split, duplicate,
cull and opacity reset at a fixed capacity (port of
``gstk_tpu/train/strategy.py``).

The scene keeps its capacity C and an ``alive`` mask, as in gstk_tpu, so
refinement edits lanes in place:

  * cull  -> clear alive bits;
  * split -> each selected Gaussian emits ``n_split_samples`` children into
             free slots (the original is culled), scales shrunk by 1.6;
  * dup   -> one copy into a free slot (the original is kept);
  * slots -> the r-th valid candidate goes to the r-th free slot, with the
             candidates in segment-major order (every split sample's
             segment, then the dup segment); a stable argsort and a cumsum
             give the mapping, so children land in the same slots as in
             gstk_tpu;
  * Adam  -> moments zeroed at the written slots.

Thresholds and gates are gstk_tpu's. Every gate is a tensor computed from
the step tensor, so :func:`refine` makes no host sync.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gstk_torch import DeviceLike, resolve_device
from gstk_torch.core.gaussians import GaussianScene
from gstk_torch.models.vanilla import VanillaConfig
from gstk_torch.train.optim import (
    AdamState,
    _lanes,
    zero_moments_at,
    zero_moments_group,
)
from gstk_torch.utils.math import normalize, quat_to_rotmat


class RefineState(NamedTuple):
    """Densification statistics accumulated between refine steps."""

    xys_grad_norm: torch.Tensor  # (C,) summed screen-space grad norms
    vis_counts: torch.Tensor  # (C,) number of steps each Gaussian was visible
    max_2dsize: torch.Tensor  # (C,) max radius / max(H, W) seen


def init_refine_state(capacity: int, device: DeviceLike = None) -> RefineState:
    device = resolve_device(device)
    z = lambda: torch.zeros((capacity,), dtype=torch.float32, device=device)
    return RefineState(xys_grad_norm=z(), vis_counts=z(), max_2dsize=z())


def update_stats(
    state: RefineState,
    xys_grad: torch.Tensor,
    radii: torch.Tensor,
    max_img_size: int,
) -> RefineState:
    """One step's statistics: the screen-space gradient norm, visibility
    and the largest screen radius, over visible Gaussians only."""
    visible = radii > 0
    grads = torch.linalg.norm(xys_grad, dim=-1)
    return RefineState(
        xys_grad_norm=state.xys_grad_norm + torch.where(visible, grads, 0.0),
        vis_counts=state.vis_counts + visible.to(torch.float32),
        max_2dsize=torch.maximum(
            state.max_2dsize,
            torch.where(visible, radii.to(torch.float32) / max_img_size, 0.0),
        ),
    )


def _cull_mask(
    scene: GaussianScene,
    cfg: VanillaConfig,
    step: torch.Tensor,
    max_2dsize: torch.Tensor,
) -> torch.Tensor:
    """Alive Gaussians to cull: transparent ones, and past the first opacity
    reset those too large in the world or (before ``stop_screen_size_at``)
    on the screen."""
    op = torch.sigmoid(scene.opacities[:, 0])
    culls = op < cfg.cull_alpha_thresh
    past_reset = step > cfg.refine_every * cfg.reset_alpha_every
    toobig_world = torch.exp(scene.scales).amax(-1) > cfg.cull_scale_thresh
    toobig_screen = (max_2dsize > cfg.cull_screen_size) & (
        step < cfg.stop_screen_size_at
    )
    culls = culls | (past_reset & (toobig_world | toobig_screen))
    return culls & scene.alive


@torch.no_grad()
def refine(
    scene: GaussianScene,
    adam_state: AdamState,
    refine_state: RefineState,
    step,
    cfg: VanillaConfig,
    num_train_data: int,
    max_img_size: int,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[GaussianScene, AdamState, RefineState, Dict[str, torch.Tensor]]:
    """One refinement pass (every ``cfg.refine_every`` steps, after the
    optimizer step).

    ``step`` is the state's step (a 0-d tensor or an int). ``noise`` is the
    split samples' standard normal draws, ``(n_split_samples, C, 3)``; when
    it is None they are drawn with ``generator`` on the scene's device.
    The scene's parameters and the Adam moments are updated in place and
    returned with fresh statistics and an ``info`` dict of 0-d tensors
    (num_alive, num_split, num_dup, num_cull, num_dropped, did_reset)."""
    C = scene.capacity
    device = scene.means.device
    step = torch.as_tensor(step, device=device)
    reset_interval = cfg.reset_alpha_every * cfg.refine_every
    in_warmup = step <= cfg.warmup_length

    do_densify = (
        (step < cfg.stop_split_at)
        & ((step % reset_interval) > (num_train_data + cfg.refine_every))
        & ~in_warmup
    )
    do_cull_only = (
        (step >= cfg.stop_split_at)
        & ~in_warmup
        & bool(cfg.continue_cull_post_densification)
    )

    avg_grad = (
        refine_state.xys_grad_norm
        / torch.clamp(refine_state.vis_counts, min=1.0)
        * 0.5
        * max_img_size
    )
    high_grads = (avg_grad > cfg.densify_grad_thresh) & scene.alive
    scale_exp = torch.exp(scene.scales)
    scale_max = scale_exp.amax(-1)
    big_world = scale_max > cfg.densify_size_thresh
    big_screen = (refine_state.max_2dsize > cfg.split_screen_size) & (
        step < cfg.stop_screen_size_at
    )
    splits = (big_world | big_screen) & high_grads & do_densify
    dups = ~big_world & high_grads & do_densify

    # candidate children, segment-major: nsamps split segments, then the
    # dup segment (a copy of every Gaussian); other attributes are
    # gathered from the parent at the receiving slot
    nsamps = cfg.n_split_samples
    if noise is None:
        noise = torch.randn((nsamps, C, 3), generator=generator, device=device)
    if noise.shape != (nsamps, C, 3):
        raise ValueError(f"noise must be {(nsamps, C, 3)}, got {tuple(noise.shape)}")
    rots = quat_to_rotmat(normalize(scene.quats))  # (C, 3, 3)
    split_scale = torch.log(torch.clamp(scale_exp / 1.6, min=1e-30))
    samples = [
        scene.means + torch.einsum("nij,nj->ni", rots, scale_exp * noise[k])
        for k in range(nsamps)
    ]
    cand_means = torch.cat(samples + [scene.means])
    cand_scales = torch.cat([split_scale] * nsamps + [scene.scales])

    # cull existing lanes; split originals are replaced by their children
    culls = _cull_mask(scene, cfg, step, refine_state.max_2dsize)
    culls = (culls & (do_densify | do_cull_only)) | splits
    alive_after_cull = scene.alive & ~culls

    # children face the same alpha and (past the first reset) world-size
    # cull as the existing lanes
    op_ok = torch.sigmoid(scene.opacities[:, 0]) >= cfg.cull_alpha_thresh
    past_reset = step > cfg.refine_every * cfg.reset_alpha_every
    toobig_split = torch.exp(split_scale).amax(-1) > cfg.cull_scale_thresh
    toobig_orig = scale_max > cfg.cull_scale_thresh
    valid_a = splits & op_ok & ~(past_reset & toobig_split)  # split segments
    valid_b = dups & op_ok & ~(past_reset & toobig_orig)  # dup segment

    # the r-th valid candidate -> the r-th free slot, inverted per slot:
    # slot of free rank r takes segment seg = r // n_a (the dup segment
    # past nsamps * n_a) and that segment's (r - seg * n_a)-th valid parent
    free = ~alive_after_cull
    n_a = valid_a.sum()
    n_b = valid_b.sum()
    total_valid = nsamps * n_a + n_b
    num_free = free.sum()
    # valid lanes first, in lane order (a stable sort of 0 = valid, 1 = not)
    idx_a = torch.argsort((~valid_a).to(torch.uint8), stable=True)
    idx_b = torch.argsort((~valid_b).to(torch.uint8), stable=True)
    r = torch.cumsum(free.to(torch.int64), 0) - 1
    seg = torch.zeros_like(r)
    for s in range(1, nsamps + 1):
        seg = seg + (r >= s * n_a).to(torch.int64)
    pr = torch.clamp(r - seg * n_a, 0, C - 1)
    parent = torch.where(seg < nsamps, idx_a[pr], idx_b[pr])
    written = free & (r < total_valid)
    parent = torch.where(written, parent, 0)
    cand_row = torch.clamp(seg, 0, nsamps) * C + parent

    def put(p: torch.Tensor, new: torch.Tensor) -> None:
        p.copy_(torch.where(_lanes(written, p), new, p))

    put(scene.means, cand_means[cand_row])
    put(scene.scales, cand_scales[cand_row])
    for name in ("quats", "features_dc", "features_rest", "opacities"):
        p = getattr(scene, name)
        put(p, p[parent])
    scene.alive.copy_(alive_after_cull | written)
    dropped = total_valid - torch.minimum(total_valid, num_free)
    zero_moments_at(adam_state, torch.arange(C, device=device), written)

    # opacity reset, gated on warmup like densify and cull
    do_reset = (
        ~in_warmup
        & (step < cfg.stop_split_at)
        & ((step % reset_interval) == cfg.refine_every)
    )
    reset_value = cfg.cull_alpha_thresh * 2.0
    # a float32 log, as gstk_tpu's; a host value, so no copy to the device
    reset_logit = float(np.log(np.float32(reset_value / (1.0 - reset_value))))
    opac = scene.opacities
    opac.copy_(torch.where(do_reset, opac.clamp(max=reset_logit), opac))
    zero_moments_group(adam_state, "opacities", when=do_reset)

    info = {
        "num_alive": scene.num_alive,
        "num_split": splits.sum(),
        "num_dup": dups.sum(),
        "num_cull": culls.sum(),
        "num_dropped": dropped,
        "did_reset": do_reset,
    }
    return scene, adam_state, init_refine_state(C, device), info
