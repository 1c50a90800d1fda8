"""Data parallelism over GPUs with ``torch.distributed`` (``mesh``), and
height-sharded inference (``spatial``)."""

from .mesh import (TIMEOUT, all_reduce_sum, average_gradients, barrier,
                   broadcast_object, default_backend, gather_rows, is_main,
                   launch, local_rows, maybe_init_distributed, multi_node,
                   per_rank, rank, run, select_devices, under_torchrun,
                   world_size)
from .spatial import gather_spatial, spatial_forward, spatial_rows

__all__ = [
    "TIMEOUT",
    "all_reduce_sum",
    "average_gradients",
    "barrier",
    "broadcast_object",
    "default_backend",
    "gather_rows",
    "gather_spatial",
    "is_main",
    "launch",
    "local_rows",
    "maybe_init_distributed",
    "multi_node",
    "per_rank",
    "rank",
    "run",
    "select_devices",
    "spatial_forward",
    "spatial_rows",
    "under_torchrun",
    "world_size",
]
