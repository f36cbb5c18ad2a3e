"""Multi-device training and rendering over ``torch.distributed`` (port of
``gstk_tpu/parallel``): data parallelism over cameras, Gaussian sharding
and tile-sharded renders, one process per device."""

from gstk_torch.parallel.mesh import (
    data_parallel_train_step,
    get_mesh,
    initialize_distributed,
)

__all__ = ["get_mesh", "data_parallel_train_step", "initialize_distributed"]
