"""Process groups, a device mesh and data-parallel training over cameras
(port of ``gstk_tpu/parallel/mesh.py``).

gstk_tpu runs one controller per host over all its devices; the port runs
one process per device (SPMD), as the reference's ``mp.spawn`` +
``init_process_group`` did (``gs_toolkit/scripts/train.py:60-118``):

  * :func:`initialize_distributed` starts ``torch.distributed``: NCCL for
    CUDA devices, gloo on the CPU, a ``tcp://`` rendezvous at the
    coordinator (or ``torchrun``'s environment), with a timeout;
  * :func:`get_mesh` lays the ranks out on named axes (``DATA_AXIS`` for
    cameras, ``"gauss"`` for Gaussian sharding), each with its process
    group and this rank's coordinate;
  * :class:`Axis` holds the collectives the step and the sharded renders
    call: sum, max, and a gather along the first dimension (gstk_tpu's
    ``pmean`` is the step's sum, then a division by the axis size, since
    gloo has no average).

gloo takes CUDA tensors in every collective used here (all-reduce sum and
max, all-gather; checked on an H100 with torch 2.11.0+cu128), so a gloo
group on the card, as in the two-rank checks on one card, needs no
staging through host memory.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from gstk_torch import DeviceLike, resolve_device

DATA_AXIS = "data"
# a collective's deadline: a rank that never joins fails the others' call
# instead of hanging them
DEFAULT_TIMEOUT = timedelta(minutes=5)

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _torchrun_env() -> bool:
    return all(k in os.environ
               for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"))


def group_configured(coordinator_address: Optional[str] = None) -> bool:
    """Whether this process is in a process group or will join one: a group
    exists, ``coordinator_address`` is given, or torchrun's environment is
    set."""
    return (dist.is_initialized() or coordinator_address is not None
            or _torchrun_env())


def world_size() -> int:
    """The process group's size; raises without a group."""
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs a torch.distributed process group: call "
            "initialize_distributed (gs-train's --coordinator-address, "
            "--num-processes, --process-id) or start under torchrun"
        )
    return dist.get_world_size()


def _local_index(rank: int) -> int:
    """The card of ``rank`` on its host: ``LOCAL_RANK``, else the rank
    modulo the visible cards."""
    local = os.environ.get("LOCAL_RANK")
    return int(local) if local is not None else rank % torch.cuda.device_count()


def local_device(device: DeviceLike = None) -> torch.device:
    """This process's device: ``device``, and for CUDA without an index the
    card of this rank on its host."""
    device = resolve_device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", _local_index(
        dist.get_rank() if dist.is_initialized() else 0))


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> None:
    """Join the process group (the reference's ``dist.init_process_group``,
    scripts/train.py:97-112): backend ``nccl`` for a CUDA ``device``
    (the default), ``gloo`` for the CPU; rendezvous at
    ``tcp://<coordinator_address>`` (an address with a scheme, such as
    ``file://``, is used as given) as rank ``process_id`` of
    ``num_processes``, or from ``torchrun``'s environment when no
    coordinator is given. No-op with neither, or when the group exists."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        if not _torchrun_env():
            if num_processes is not None:
                raise ValueError(
                    "num_processes without coordinator_address: give the "
                    "coordinator's host:port, or start under torchrun"
                )
            return
        init_method, world, rank = "env://", None, None
    else:
        if num_processes is None or process_id is None:
            raise ValueError(
                "coordinator_address needs num_processes and process_id"
            )
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", _local_index(
                rank if rank is not None else int(os.environ["RANK"])))
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world if world is not None else -1,
                            rank=rank if rank is not None else -1,
                            timeout=timeout)


@dataclasses.dataclass
class Axis:
    """One named mesh axis as this rank sees it: its size, this rank's
    coordinate, the process group of the ranks that differ only along it,
    and its collectives (every rank of the group must call each one, in
    the same order)."""

    name: str
    size: int
    index: int
    group: object

    def all_reduce_(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` reduced over the axis, in place (``op`` sum or max)."""
        dist.all_reduce(x, _OPS[op], group=self.group)
        return x

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_reduce_(x, "sum")

    def max_(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_reduce_(x, "max")

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (equal shapes) concatenated along dim 0 in
        axis order: JAX's ``all_gather(tiled=True)``."""
        src = x.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts)


@dataclasses.dataclass
class Mesh:
    """Named axes over the ranks of the process group, row-major (the last
    axis varies fastest along the ranks)."""

    axes: Dict[str, Axis]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.axes)

    def __getitem__(self, name: str) -> Axis:
        return self.axes[name]

    def __contains__(self, name: str) -> bool:
        return name in self.axes


def get_mesh(n_devices: Optional[int] = None,
             axes: Optional[Sequence[Tuple[str, int]]] = None) -> Mesh:
    """The mesh over every rank of the process group: one ``DATA_AXIS`` by
    default, else ``axes`` as (name, size) pairs whose sizes multiply to the
    world size. Every rank must call it alike (it creates the sub-groups).
    ``n_devices``, gstk_tpu's first-n-devices argument, must be the world
    size: one process drives one device."""
    world, rank = world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"n_devices={n_devices}, but the process group has {world} ranks "
            "(one process a device)"
        )
    axes = list(axes) if axes is not None else [(DATA_AXIS, world)]
    sizes = [int(s) for _, s in axes]
    total = 1
    for s in sizes:
        total *= s
    if total != world:
        raise ValueError(f"mesh axes {axes} hold {total} ranks, not {world}")
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    coords = [(rank // strides[i]) % sizes[i] for i in range(len(sizes))]
    out = {}
    for i, (name, size) in enumerate(axes):
        if size == world:
            group = dist.group.WORLD
        else:
            group = None
            others = [range(s) if j != i else [0]
                      for j, s in enumerate(sizes)]
            for base in itertools.product(*others):
                ranks = [sum(c * st for c, st in zip(base, strides))
                         + k * strides[i] for k in range(size)]
                g = dist.new_group(ranks)
                if rank in ranks:
                    group = g
        out[name] = Axis(name, size, coords[i], group)
    return Mesh(out)


def data_parallel_train_step(train_step, mesh: Mesh):
    """The step of this rank's camera under data parallelism: ``train_step``
    built with ``axis_name=DATA_AXIS`` on ``mesh`` reduces gradients,
    densify statistics and metrics over the axis itself, so this rank passes
    only its own inputs, as the inner function of gstk_tpu's ``shard_map``
    receives them: ``(state, camera, gt_image, generator, mask=None,
    depth=None, camera_index=None, mono_scale=None, mono_shift=None)``."""
    if DATA_AXIS not in mesh:
        raise ValueError(f"the mesh {mesh.axis_names} has no {DATA_AXIS!r} axis")

    def step(state, camera, gt_image, generator=None, mask=None, depth=None,
             camera_index=None, mono_scale=None, mono_shift=None):
        return train_step(state, camera, gt_image, generator, mask, depth,
                          mono_scale=mono_scale, mono_shift=mono_shift,
                          camera_index=camera_index)

    return step


def local_mesh_size(mesh: Mesh) -> int:
    """This process's devices in the mesh: 1, since one process drives one
    device (each rank contributes one camera a step)."""
    return 1


def host_local_to_global(mesh: Mesh, tree):
    """Identity: one process drives one device, so a rank's local batch is
    already its share of the global one (gstk_tpu stitches its per-host
    shards into global arrays here)."""
    return tree


def replicate_global(mesh: Mesh, tree):
    """Identity: every rank holds its own copy of the replicated state
    (identically seeded and identically updated), so there is nothing to
    promote to a global array as in gstk_tpu."""
    return tree
