"""Data parallelism across GPUs, one process a device — the counterpart of
:mod:`posetpu.parallel` (``posetpu/parallel/dp.py``)."""

from posetpu_torch.parallel.dp import (
    all_reduce_mean_,
    all_reduce_sum,
    all_reduce_sum_,
    barrier,
    broadcast_state_,
    check_batch,
    free_port,
    gather_rows,
    group_rank,
    group_size,
    init_process_group,
    mean_grads_,
    resolve_num_devices,
    shard_slice,
)
from posetpu_torch.parallel.launch import RankContext, RankPool, ranks_equal

__all__ = [
    "RankContext",
    "RankPool",
    "all_reduce_mean_",
    "all_reduce_sum",
    "all_reduce_sum_",
    "barrier",
    "broadcast_state_",
    "check_batch",
    "free_port",
    "gather_rows",
    "group_rank",
    "group_size",
    "init_process_group",
    "mean_grads_",
    "ranks_equal",
    "resolve_num_devices",
    "shard_slice",
]
