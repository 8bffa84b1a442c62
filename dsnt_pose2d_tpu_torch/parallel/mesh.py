"""Data parallelism over processes: one process per card, ``torch.distributed``
(port of ``dsnt_pose2d_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``data`` mesh and lets XLA place the
collectives.  The port runs PyTorch's way: one process per card, launched by
``torchrun`` (``torch.distributed.run``), each holding a full replica of the
parameters and its ``1/W`` share of the global batch.  The step computes what
the JAX package's step computes on a ``data`` mesh of ``W`` devices:

- train-mode BatchNorm takes **global-batch** statistics
  (:class:`..models.hourglass.BatchNorm`, one differentiable all-reduce of
  ``[sum x, sum x^2]`` per BN);
- the masked losses divide by the **global** count of visible joints
  (:func:`..ops.losses.average_loss`), so each rank's loss is its share of
  the global loss, and the gradients are **summed** over ranks
  (:meth:`..train.state.OptimizerChain.step`) before the global norm and
  the clip;
- PCKh counts and eval losses are summed over ranks.

Every collective of the port is an all-reduce or a broadcast, the two that
gloo carries for CUDA tensors, so the same code runs over NCCL (the default
for a card) and over gloo (the default for the CPU, and two ranks sharing
one card).  When no process group of size > 1 is up, the helpers below
return at once: a one-process run issues no collective.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..device import DEFAULT_DEVICE, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

# Set by torchrun and other launchers: their presence means THIS process is
# one of several, and a failed bootstrap must be fatal.
_LAUNCH_ENV_VARS = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "TORCHELASTIC_RUN_ID")

# Gradient buckets of at most this many bytes each (a flat copy per bucket).
GRAD_BUCKET_BYTES = 64 << 20

_COUNTS = {"all_reduce": 0, "broadcast": 0}


def collective_counts() -> dict:
    """Collectives issued by this process since the last reset, by kind (the
    backward pass's all-reduces included)."""
    return dict(_COUNTS)


def reset_collective_counts():
    for k in _COUNTS:
        _COUNTS[k] = 0


def world_size() -> int:
    """Processes in the default group, 1 when none is up."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank in the default group, 0 when none is up."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_main_process() -> bool:
    """Rank 0: the process that logs, writes checkpoints and metric records."""
    return rank() == 0


def launched() -> bool:
    """Whether a launcher's variables say this process is one of several."""
    return any(os.environ.get(v) for v in _LAUNCH_ENV_VARS)


def rank_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` for this process: a bare ``cuda`` becomes
    ``cuda:{LOCAL_RANK}`` under a launcher (``cuda:0`` without one); an
    explicit ``cuda:N`` and ``cpu`` stay as given."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def initialize_distributed(device=DEFAULT_DEVICE, backend: str | None = None,
                           timeout: datetime.timedelta | None = None):
    """Join the launcher's process group; call before :func:`make_mesh`.

    A no-op on a plain run (none of ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``TORCHELASTIC_RUN_ID`` set) and when a group is already up.  Under a
    launcher, a failed ``init_process_group`` is raised, never swallowed:
    swallowing it would run the job as N independent one-process runs that
    each think they are fine.  The backend is ``nccl`` for a CUDA device and
    ``gloo`` for the CPU unless named; an NCCL failure is not retried over
    gloo.
    """
    if dist.is_initialized() or not launched():
        return
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method="env://", **kw)


@dataclass(frozen=True)
class Mesh:
    """The data-parallel layout as one process sees it: ``world_size``
    processes (one card each), this one's ``rank`` and ``local_rank``, its
    ``device`` and the process ``group`` (None without one).  ``shape`` reads
    as the JAX mesh's, ``{"data": W, "model": 1}``."""

    world_size: int
    rank: int
    local_rank: int
    device: torch.device
    group: Any = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.world_size, MODEL_AXIS: 1}


def make_mesh(model_parallel: int = 1, device=DEFAULT_DEVICE) -> Mesh:
    """The data mesh over the processes of the default group (one process,
    world size 1, when none is up)."""
    if model_parallel > 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: tensor parallelism "
            "(parallel/tp.py) is not ported yet (ROADMAP Queue 1, Data parallel: "
            "item 8, Tensor parallel)")
    up = dist.is_available() and dist.is_initialized()
    return Mesh(world_size=world_size(), rank=rank(),
                local_rank=int(os.environ.get("LOCAL_RANK", 0)) if up else 0,
                device=rank_device(device),
                group=dist.group.WORLD if up else None)


def check_row_order(mesh: Mesh) -> None:
    """Verify the global-batch row layout that ``predict`` relies on.

    A global batch is the ranks' local rows in rank order
    (``ShardedLoader.global_index_batches``): rank ``r`` holds block ``r``.
    That holds when the mesh's rank is the process's rank in the default
    group and the mesh spans that group; raise early otherwise rather than
    silently permuting predictions.
    """
    if (mesh.world_size, mesh.rank) != (world_size(), rank()):
        raise ValueError(
            f"mesh (world {mesh.world_size}, rank {mesh.rank}) is not this "
            f"process's place in the default group (world {world_size()}, "
            f"rank {rank()}); global-batch rows would not be in rank order")


def _rows(x, mesh: Mesh, axis: int):
    n = x.shape[axis]
    if n % mesh.world_size:
        raise ValueError(f"{n} rows do not divide over {mesh.world_size} ranks")
    b = n // mesh.world_size
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    t = t.narrow(axis, mesh.rank * b, b).contiguous()
    return t.to(mesh.device, non_blocking=True)


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's rows of a host-global batch (block ``rank`` of the batch
    axis), on the rank's device."""
    return {k: _rows(v, mesh, 0) for k, v in batch.items()}


def shard_super_batch(mesh: Mesh, super_batch: dict) -> dict:
    """This rank's rows of a ``(k, global batch, ...)`` super-batch."""
    return {k: _rows(v, mesh, 1) for k, v in super_batch.items()}


def _all_reduce(t: torch.Tensor):
    _COUNTS["all_reduce"] += 1
    dist.all_reduce(t)


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over ranks in place, outside autograd; returns ``t``.  No
    collective without a group of size > 1."""
    if world_size() > 1:
        with torch.no_grad():
            _all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    """``y = sum over ranks of x``; its backward sums the gradient over ranks
    (every rank's loss depends on every rank's ``x``)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        _all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        _all_reduce(g)
        return g


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``t`` over ranks (a new tensor); ``t`` itself
    without a group of size > 1."""
    if world_size() > 1:
        return _AllReduceSum.apply(t)
    return t


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place; returns ``t``."""
    if world_size() > 1:
        _COUNTS["broadcast"] += 1
        dist.broadcast(t, src)
    return t


def _buckets(tensors, cap_bytes: int):
    """Consecutive runs of same-dtype, same-device tensors, each run at most
    ``cap_bytes`` (a single larger tensor makes a run of its own)."""
    run, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or size + nbytes > cap_bytes):
            yield run
            run, size = [], 0
        run.append(t)
        size += nbytes
    if run:
        yield run


@torch.no_grad()
def _bucketed(tensors, collective, cap_bytes: int) -> int:
    n = 0
    for run in _buckets(list(tensors), cap_bytes):
        flat = torch.cat([t.reshape(-1) for t in run])
        collective(flat)
        for t, part in zip(run, flat.split([t.numel() for t in run])):
            t.copy_(part.view_as(t))
        n += 1
    return n


def all_reduce_grads_(grads) -> int:
    """Sum the gradients over ranks in place, flattened into buckets of at
    most ``GRAD_BUCKET_BYTES``; returns the number of buckets (0 without a
    group of size > 1)."""
    if world_size() == 1:
        return 0
    return _bucketed(grads, _all_reduce, GRAD_BUCKET_BYTES)


def collective_device() -> torch.device:
    """Where a small tensor for a collective lives: this process's card under
    NCCL (which carries CUDA tensors only), else the CPU."""
    if world_size() > 1 and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier():
    """Every rank waits here for the others: an all-reduce of one element,
    read back."""
    if world_size() == 1:
        return
    t = torch.zeros(1, device=collective_device())
    _all_reduce(t)
    t.item()
