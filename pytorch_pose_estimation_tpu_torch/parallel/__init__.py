"""Data parallelism over GPUs with ``torch.distributed`` (``mesh``)."""

from .mesh import (TIMEOUT, all_reduce_sum, average_gradients, barrier,
                   broadcast_object, default_backend, gather_rows, is_main,
                   launch, local_rows, maybe_init_distributed, multi_node,
                   per_rank, rank, run, select_devices, under_torchrun,
                   world_size)

__all__ = [
    "TIMEOUT",
    "all_reduce_sum",
    "average_gradients",
    "barrier",
    "broadcast_object",
    "default_backend",
    "gather_rows",
    "is_main",
    "launch",
    "local_rows",
    "maybe_init_distributed",
    "multi_node",
    "per_rank",
    "rank",
    "run",
    "select_devices",
    "under_torchrun",
    "world_size",
]
