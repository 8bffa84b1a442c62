"""Data and tensor parallelism over processes (port of
``dsnt_pose2d_tpu/parallel/``): :mod:`.mesh` lays the ranks out as
``(data, model)`` and holds the counted collectives, :mod:`.tp` shards the
model's kernels over the ``model`` axis.

``--model-parallel 2`` on the CPU, two ranks over gloo::

    torchrun --nproc_per_node=2 -m dsnt_pose2d_tpu_torch.cli.train \
        --device cpu --model-parallel 2 ...

On one card, two ranks share it over gloo (NCCL cannot put two ranks on
one device): ``--device cuda:0`` on each and
``initialize_distributed(device, backend="gloo")``, as
``chip_smoke.py``'s ``tp`` phase runs them.
"""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    all_reduce_grads_,
    all_reduce_sum,
    all_reduce_sum_,
    axis_index,
    axis_size,
    barrier,
    broadcast_,
    broadcast_grads_,
    check_row_order,
    collective_bytes,
    collective_counts,
    collective_device,
    initialize_distributed,
    is_main_process,
    make_mesh,
    rank,
    reset_collective_counts,
    shard_batch,
    shard_super_batch,
    world_size,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "all_reduce_grads_",
    "all_reduce_sum",
    "all_reduce_sum_",
    "axis_index",
    "axis_size",
    "barrier",
    "broadcast_",
    "broadcast_grads_",
    "check_row_order",
    "collective_bytes",
    "collective_counts",
    "collective_device",
    "initialize_distributed",
    "is_main_process",
    "make_mesh",
    "rank",
    "reset_collective_counts",
    "shard_batch",
    "shard_super_batch",
    "world_size",
]
