"""Gaussian-sharded rendering and training: parameters sharded over ranks
along the capacity axis (port of ``gstk_tpu/parallel/gaussian_sharding.py``).

For scenes whose padded parameters and Adam state no longer fit one card,
rank r of the ``"gauss"`` axis holds lanes ``[r C / n, (r + 1) C / n)`` of
every capacity-leading tensor. Projection, SH and opacity activation run on
the local lanes; one gather of the compact projected outputs (about 60 B a
Gaussian against about 480 B of parameters and moments) feeds binning and
compositing, which every rank runs on the same gathered inputs.

gstk_tpu trains such a state with the unchanged step under GSPMD, which
partitions the elementwise work and reduce-scatters the gradients. Here the
gather is an autograd ``Function`` whose backward returns this rank's slice
of the incoming cotangent. That is the gradient of the local lanes because
every rank rasterises the same gathered inputs, and the compositing
backward and the per-Gaussian sum (K2, K4) are deterministic, so every
rank's cotangent is the same. Adam and the densify statistics stay local.

No rank ever holds the whole training state: refinement runs on the shards
(``strategy.refine(..., mesh=)``: three flag bytes a lane are gathered, and
only the children's rows move to their slots' owners);
:func:`grow_train_state` moves only the rows whose owner changes when the
capacity grows; ``checkpoint.save_checkpoint(..., mesh=)`` assembles a
checkpoint's arrays on rank 0's host one shard of one tensor at a time; and
:func:`scene_to_rank0` gives the viewer the scene's parameters, not the
moments. :func:`gather_train_state`, which builds the whole state on every
rank, is kept for tests and the card's reference checks.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Dict, Optional

import torch

from gstk_torch.core.cameras import Camera
from gstk_torch.core.gaussians import FIELD_NAMES, GaussianScene
from gstk_torch.models.vanilla import VanillaConfig, render_splats, splat_inputs
from gstk_torch.ops.rasterize import RasterizeConfig
from gstk_torch.parallel.mesh import (
    GAUSS_AXIS,
    Axis,
    Mesh,
    axis_of,
    get_mesh,
    world_size,
)
from gstk_torch.train.optim import AdamState
from gstk_torch.train.strategy import RefineState
# the projected outputs gathered in one f32 tensor, in this column order
_F32_COLUMNS = (("xys", 2), ("depths", 1), ("conics", 3), ("colors", 4),
                ("opacities", 1))


def make_gauss_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A one-axis mesh over every rank, named ``GAUSS_AXIS``."""
    return get_mesh(n_devices, axes=((GAUSS_AXIS, world_size()),))


def _axis(mesh_or_axis) -> Axis:
    return axis_of(mesh_or_axis, GAUSS_AXIS)


def _lanes(capacity: int, axis: Axis) -> slice:
    if capacity % axis.size:
        raise ValueError(
            f"capacity {capacity} does not divide by the {axis.size} ranks of "
            f"the {axis.name!r} axis"
        )
    n = capacity // axis.size
    return slice(axis.index * n, (axis.index + 1) * n)


def shard_scene(scene: GaussianScene, mesh) -> GaussianScene:
    """This rank's lanes of ``scene`` (copies)."""
    s = _lanes(scene.capacity, _axis(mesh))
    return GaussianScene(**{k: getattr(scene, k).detach()[s].clone()
                            for k in FIELD_NAMES})


def shard_train_state(state, mesh):
    """This rank's lanes of every capacity-leading tensor of a TrainState
    (parameters, Adam moments, refine statistics, alive); the step counter,
    Adam's count and the camera-opt group stay replicated."""
    s = _lanes(state.scene.capacity, _axis(mesh))
    cut = lambda x: x.detach()[s].clone()
    return dataclasses.replace(
        state,
        scene=shard_scene(state.scene, mesh),
        adam=AdamState(count=state.adam.count,
                       mu={k: cut(v) for k, v in state.adam.mu.items()},
                       nu={k: cut(v) for k, v in state.adam.nu.items()}),
        refine=RefineState(*(cut(x) for x in state.refine)),
    )


def gather_train_state(state, mesh):
    """The whole TrainState from every rank's shard (every rank calls it and
    gets the same state): one gather of the f32 tensors packed side by side
    and one of ``alive``."""
    axis = _axis(mesh)
    scene = state.scene
    tensors = ([getattr(scene, k).detach() for k in FIELD_NAMES[:-1]]
               + [state.adam.mu[k] for k in state.adam.mu]
               + [state.adam.nu[k] for k in state.adam.nu]
               + list(state.refine))
    n = scene.capacity
    widths = [t[0].numel() if t.dim() > 1 else 1 for t in tensors]
    packed = torch.cat([t.reshape(n, -1) for t in tensors], dim=1)
    full = axis.all_gather(packed)
    alive = axis.all_gather(scene.alive.to(torch.int32)).bool()
    parts, i = [], 0
    for t, w in zip(tensors, widths):
        parts.append(full[:, i:i + w].reshape((full.shape[0],) + t.shape[1:])
                     .contiguous())
        i += w
    k = len(FIELD_NAMES) - 1
    m = len(state.adam.mu)
    fields = dict(zip(FIELD_NAMES[:-1], parts[:k]), alive=alive)
    return dataclasses.replace(
        state,
        scene=GaussianScene(**fields),
        adam=AdamState(count=state.adam.count,
                       mu=dict(zip(state.adam.mu, parts[k:k + m])),
                       nu=dict(zip(state.adam.nu, parts[k + m:k + 2 * m]))),
        refine=RefineState(*parts[k + 2 * m:]),
    )


class _GatherRows(torch.autograd.Function):
    """Every rank's rows concatenated along dim 0; the backward returns this
    rank's rows of the cotangent (the same cotangent on every rank)."""

    @staticmethod
    def forward(ctx, axis: Axis, x: torch.Tensor) -> torch.Tensor:
        ctx.axis, ctx.rows = axis, x.shape[0]
        return axis.all_gather(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        i, n = ctx.axis.index, ctx.rows
        return None, g[i * n:(i + 1) * n]


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` of every rank along dim 0, differentiable (see _GatherRows)."""
    return _GatherRows.apply(_axis(mesh), x)


def gathered_splat_inputs(local: Dict[str, torch.Tensor], mesh
                          ) -> Dict[str, torch.Tensor]:
    """:func:`splat_inputs` of the whole scene from this rank's: the f32
    outputs packed into one differentiable gather, radii and tile counts
    into one int32 gather."""
    n = local["xys"].shape[0]
    packed = torch.cat([local[k].reshape(n, w) for k, w in _F32_COLUMNS], 1)
    full = gather_rows(packed, mesh)
    out, i = {}, 0
    for k, w in _F32_COLUMNS:
        col = full[:, i:i + w]
        out[k] = (col[:, 0] if local[k].dim() == 1 else col).contiguous()
        i += w
    ints = torch.stack([local["radii"].to(torch.int32),
                        local["num_tiles_hit"].to(torch.int32)], 1)
    full_ints = _axis(mesh).all_gather(ints)
    out["radii"] = full_ints[:, 0].to(local["radii"].dtype).contiguous()
    out["num_tiles_hit"] = full_ints[:, 1].to(
        local["num_tiles_hit"].dtype).contiguous()
    return out


def loss_scene(scene: GaussianScene, mesh) -> SimpleNamespace:
    """The fields the scene-reading loss terms use (the scale regulariser,
    the sparse opacity term) over every lane: scales and opacities gathered
    differentiably, alive and its count."""
    full = gather_rows(torch.cat([scene.scales, scene.opacities], 1), mesh)
    alive = _axis(mesh).all_gather(scene.alive.to(torch.int32)).bool()
    return SimpleNamespace(scales=full[:, :3], opacities=full[:, 3:4],
                           alive=alive, num_alive=alive.sum())


def render_scene_gauss_sharded(
    scene: GaussianScene,
    camera: Camera,
    img_height: int,
    img_width: int,
    *,
    sh_degree: int,
    background: torch.Tensor,
    mesh,
    config: VanillaConfig = VanillaConfig(),
    raster_config: RasterizeConfig = RasterizeConfig(),
    xys_offset: Optional[torch.Tensor] = None,
    crop_box=None,
) -> Dict[str, torch.Tensor]:
    """:func:`render_scene` of the whole scene from this rank's lanes:
    local projection and SH, one gather of the projected outputs,
    replicated binning and compositing. ``radii`` and ``visible`` are the
    local lanes' (the densify statistics stay sharded); ``xys_offset`` is
    the local (C / n, 2) zero tensor. Every rank of the axis must call it
    with the same camera."""
    local = splat_inputs(
        scene, camera, img_height, img_width, sh_degree=sh_degree,
        config=config, block_width=raster_config.block_width,
        crop_box=crop_box,
    )
    if xys_offset is not None:
        local["xys"] = local["xys"] + xys_offset
    out = render_splats(gathered_splat_inputs(local, mesh), img_height,
                        img_width, background, raster_config)
    out["radii"] = local["radii"]
    out["visible"] = local["radii"] > 0
    return out


def _overlap(a0: int, a1: int, b0: int, b1: int) -> int:
    return max(0, min(a1, b1) - max(a0, b0))


def grow_train_state(state, new_cap: int, mesh=None):
    """``state`` grown to ``new_cap`` lanes, as gstk_tpu grows it: every
    capacity-leading tensor padded at the end with dead lanes (zeros,
    identity quats; zero moments and statistics).

    With a Gaussian ``mesh`` (every rank calls it), ``state`` is this
    rank's lanes and the result is this rank's lanes of the padded global
    state, exactly :func:`shard_train_state` of it. Lanes keep their global
    index, so after a growth the low ranks hold the live rows (with 2 ranks
    and a doubling, rank 0 takes rank 1's rows and rank 1 holds only dead
    lanes), which keeps the lane order, and so the next refine, equal to
    the replicated run's. Only the rows whose owner changes move: one
    variable-row exchange a tensor (``Axis.exchange``)."""
    n = state.scene.capacity
    if mesh is None:
        if new_cap < n:
            raise ValueError(f"cannot shrink {n} -> {new_cap}")
        grown = lambda x, dead: torch.cat(
            [x.detach(), dead(new_cap - n, x)])
    else:
        axis = _axis(mesh)
        cap, me = n * axis.size, axis.index
        if new_cap < cap:
            raise ValueError(f"cannot shrink {cap} -> {new_cap}")
        _lanes(new_cap, axis)  # raises unless the ranks divide new_cap
        m = new_cap // axis.size
        send = [_overlap(me * n, (me + 1) * n, q * m, (q + 1) * m)
                for q in range(axis.size)]
        recv = [_overlap(p * n, (p + 1) * n, me * m, (me + 1) * m)
                for p in range(axis.size)]
        grown = lambda x, dead: torch.cat(
            [axis.exchange(x.detach(), send, recv), dead(m - sum(recv), x)])

    zeros = lambda k, x: x.new_zeros((k,) + x.shape[1:])

    def dead_quats(k, x):
        q = zeros(k, x)
        q[:, 0] = 1.0
        return q

    scene = GaussianScene(**{
        k: grown(getattr(state.scene, k),
                 dead_quats if k == "quats" else zeros)
        for k in FIELD_NAMES})
    return dataclasses.replace(
        state,
        scene=scene,
        adam=AdamState(count=state.adam.count,
                       mu={k: grown(v, zeros) for k, v in state.adam.mu.items()},
                       nu={k: grown(v, zeros) for k, v in state.adam.nu.items()}),
        refine=RefineState(*(grown(x, zeros) for x in state.refine)),
    )


def scene_to_rank0(scene: GaussianScene, mesh) -> Optional[GaussianScene]:
    """The whole scene (parameters and alive mask, not the moments) on the
    device of index 0, None on the other ranks (every rank calls it): each
    field assembled on index 0's host by ``Axis.gather_to_host``, then
    uploaded. The viewer's snapshot under Gaussian sharding."""
    axis = _axis(mesh)
    fields = {k: axis.gather_to_host(getattr(scene, k)) for k in FIELD_NAMES}
    if axis.index:
        return None
    return GaussianScene(**{k: v.to(scene.means.device)
                            for k, v in fields.items()})
