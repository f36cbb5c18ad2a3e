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

Under Gaussian sharding (``refine(..., mesh=)``) each rank refines its own
lanes, as GSPMD partitions gstk_tpu's refine: the masks, the noise rows,
the children's rows and the moments stay on the rank that owns them. The
ranks all-gather only the three per-lane flags the slot ranking reads
(valid split parent, valid dup parent, free slot; one byte each), every
rank ranks the same candidates into the same slots, and one variable-row
exchange (``all_to_all_single``) carries each child's row from its
parent's owner to its slot's owner; the row counts of that exchange are
the one host sync. Of the two ways to move the rows (this exchange, or
one padded all-gather of the requested rows in slot order), the exchange
moves only the written rows and holds no padding. gloo takes CUDA tensors
in all-gather and ``all_to_all_single`` (checked on an H100 with torch
2.11.0+cu128); no point-to-point call is used.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gstk_torch import DeviceLike, resolve_device
from gstk_torch.core.gaussians import GaussianScene
from gstk_torch.models.vanilla import VanillaConfig
from gstk_torch.parallel.mesh import GAUSS_AXIS, axis_of
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
    mesh=None,
) -> Tuple[GaussianScene, AdamState, RefineState, Dict[str, torch.Tensor]]:
    """One refinement pass (every ``cfg.refine_every`` steps, after the
    optimizer step).

    ``step`` is the state's step (a 0-d tensor or an int). ``noise`` is the
    split samples' standard normal draws, ``(n_split_samples, C, 3)``; when
    it is None they are drawn with ``generator`` on the scene's device.
    The scene's parameters and the Adam moments are updated in place and
    returned with fresh statistics and an ``info`` dict of 0-d tensors
    (num_alive, num_split, num_dup, num_cull, num_dropped, did_reset).

    With a Gaussian ``mesh`` (or its ``"gauss"`` axis), ``scene``,
    ``adam_state`` and ``refine_state`` are this rank's lanes of a state of
    C = ranks x local lanes, every rank calls it alike, and the result is
    this rank's lanes of the replicated refine's, bit for bit; ``noise``
    (or the draw) still covers all C lanes, so ``generator`` ends where
    the replicated refine leaves it (see :func:`_place_children_sharded`)."""
    n = scene.capacity
    device = scene.means.device
    axis = None if mesh is None else axis_of(mesh, GAUSS_AXIS)
    C = n if axis is None else n * axis.size
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
    if axis is not None:
        noise = noise[:, axis.index * n:(axis.index + 1) * n]
    split_scale = torch.log(torch.clamp(scale_exp / 1.6, min=1e-30))
    samples = _split_samples(scene, scale_exp, noise)

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
    free = ~alive_after_cull

    if axis is None:
        dropped = _place_children(scene, adam_state, samples, split_scale,
                                  valid_a, valid_b, free)
    else:
        dropped = _place_children_sharded(scene, adam_state, axis, samples,
                                          split_scale, valid_a, valid_b, free)

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

    counts = torch.stack([scene.num_alive, splits.sum(), dups.sum(),
                          culls.sum()])
    if axis is not None:
        axis.sum_(counts)
    info = dict(zip(("num_alive", "num_split", "num_dup", "num_cull"),
                    counts.unbind()))
    info.update(num_dropped=dropped, did_reset=do_reset)
    return scene, adam_state, init_refine_state(n, device), info


def _split_samples(scene: GaussianScene, scale_exp: torch.Tensor,
                   noise: torch.Tensor) -> list:
    """Each split segment's child means on every lane of ``scene``: the
    mean plus the rotated, scaled noise of that segment."""
    rots = quat_to_rotmat(normalize(scene.quats))  # (C, 3, 3)
    return [scene.means + torch.einsum("nij,nj->ni", rots, scale_exp * noise[k])
            for k in range(noise.shape[0])]


def _place_children(scene, adam_state, samples, split_scale, valid_a,
                    valid_b, free) -> torch.Tensor:
    """Write the valid candidates into the free slots of the whole scene
    and zero their moments; returns the number of children dropped."""
    C = scene.capacity
    device = scene.means.device
    nsamps = len(samples)
    cand_means = torch.cat(samples + [scene.means])
    cand_scales = torch.cat([split_scale] * nsamps + [scene.scales])
    # the r-th valid candidate -> the r-th free slot, inverted per slot:
    # slot of free rank r takes segment seg = r // n_a (the dup segment
    # past nsamps * n_a) and that segment's (r - seg * n_a)-th valid parent
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
    scene.alive.copy_(~free | written)
    zero_moments_at(adam_state, torch.arange(C, device=device), written)
    return total_valid - torch.minimum(total_valid, num_free)


def _place_children_sharded(scene, adam_state, axis, samples, split_scale,
                            valid_a, valid_b, free) -> torch.Tensor:
    """:func:`_place_children` on this rank's lanes of the sharded scene.

    Every rank gathers the per-lane ``valid_a``, ``valid_b`` and ``free``
    flags (3 bytes a lane) and ranks the same candidates into the same free
    slots as the replicated refine: candidate c takes the c-th free slot
    and comes from segment ``min(c // n_a, nsamps)`` of the valid parent it
    ranks. The owner of each parent builds its children's rows (mean,
    scale, and the parent's quats, colours and opacity: 59 floats at SH 3)
    and one variable-row exchange sends each row to the owner of its slot,
    which writes it there and zeros the slot's moments. Returns the
    children dropped, from the global totals."""
    n = scene.capacity
    device = scene.means.device
    nsamps = len(samples)
    lo = axis.index * n
    flags = axis.all_gather(
        torch.stack([valid_a, valid_b, free], 1).to(torch.uint8)).bool()
    idx_a = torch.nonzero(flags[:, 0])[:, 0]
    idx_b = torch.nonzero(flags[:, 1])[:, 0]
    n_a, n_b = idx_a.numel(), idx_b.numel()
    total_valid = nsamps * n_a + n_b
    slot = torch.nonzero(flags[:, 2])[:, 0]
    num_free = slot.numel()
    del flags
    # candidate c -> (segment, parent) -> free slot c, over the written ones
    slot = slot[:min(total_valid, num_free)]
    c = torch.arange(slot.numel(), device=device)
    seg = torch.clamp(c // max(n_a, 1), max=nsamps) if n_a else torch.full_like(c, nsamps)
    pr = c - seg * n_a
    parent = torch.cat([idx_a, idx_b])[torch.where(seg < nsamps, pr, n_a + pr)]
    del c, pr, idx_a, idx_b
    src, dst = parent // n, slot // n

    # this rank's parents' children, in candidate (so slot, so rank) order
    mine = src == axis.index
    lane, kind = parent[mine] - lo, seg[mine]
    cand_means = torch.stack(samples + [scene.means])  # (nsamps + 1, n, 3)
    cand_scales = torch.stack([split_scale, scene.scales])
    rows = torch.cat(
        [cand_means[kind, lane],
         cand_scales[(kind == nsamps).to(torch.int64), lane]]
        + [getattr(scene, k).detach()[lane].flatten(1)
           for k in ("quats", "features_dc", "features_rest", "opacities")], 1)
    del cand_means, cand_scales
    send = torch.bincount(dst[mine], minlength=axis.size).tolist()
    # the rows this rank's slots receive arrive grouped by source rank
    here = dst == axis.index
    recv_src = src[here]
    recv = torch.bincount(recv_src, minlength=axis.size).tolist()
    slots = (slot[here] - lo)[torch.argsort(recv_src, stable=True)]
    got = axis.exchange(rows, send, recv)

    col = 0
    for k in ("means", "scales", "quats", "features_dc", "features_rest",
              "opacities"):
        p = getattr(scene, k)
        w = p[0].numel()
        p[slots] = got[:, col:col + w].reshape(slots.shape + p.shape[1:])
        col += w
    scene.alive.copy_(~free)
    scene.alive[slots] = True
    for moments in (adam_state.mu, adam_state.nu):
        for v in moments.values():
            v[slots] = 0.0
    return torch.tensor(total_valid - min(total_valid, num_free),
                        device=device)
