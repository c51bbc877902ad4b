"""Data-parallel scale-out over torch.distributed (the JAX mesh's
counterpart)."""

from adaptsegnet_tpu_torch.parallel.group import (
    active,
    all_reduce_grads,
    all_reduce_sum,
    all_reduce_sum_grad,
    auto_world_size,
    broadcast_state,
    device_count,
    launch,
    rank,
    started_by_torchrun,
    world,
)

__all__ = [
    "active",
    "all_reduce_grads",
    "all_reduce_sum",
    "all_reduce_sum_grad",
    "auto_world_size",
    "broadcast_state",
    "device_count",
    "launch",
    "rank",
    "started_by_torchrun",
    "world",
]
