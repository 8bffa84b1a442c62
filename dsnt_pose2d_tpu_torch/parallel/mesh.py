"""Data and tensor parallelism over processes: one process per card,
``torch.distributed`` (port of ``dsnt_pose2d_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``(data, model)`` mesh and lets
XLA place the collectives.  The port runs PyTorch's way: one process per
card, launched by ``torchrun`` (``torch.distributed.run``).
``make_mesh(model_parallel=t)`` lays the ``W`` processes out as the JAX
package lays its devices, ``(W / t, t)`` as ``(data, model)``: rank ``r``
has data index ``r // t`` and model index ``r % t``.  The ``t`` ranks of
one data index (a *model group*) hold the shards of one replica
(:mod:`.tp`) and see the same rows; the ranks of one model index (a *data
group*) each take ``t / W`` of the global batch.  The step computes what
the JAX package's step computes on that mesh:

- train-mode BatchNorm takes **global-batch** statistics
  (:class:`..models.hourglass.BatchNorm`, one differentiable all-reduce of
  ``[sum x, sum x^2]`` per BN over the data group);
- the masked losses divide by the **global** count of visible joints
  (:func:`..ops.losses.average_loss`), so each data rank's loss is its
  share of the global loss, and the gradients are **summed** over the data
  group (:meth:`..train.state.OptimizerChain.step`) before the global norm
  and the clip;
- PCKh counts and eval losses are summed over the data group;
- the column-parallel convs and denses gather their output features over
  the model group and sum their input gradients there (:mod:`.tp`).

Every collective helper takes the ``axis`` it runs over: ``"data"``,
``"model"``, or None for every process.  The groups are those of the mesh
that :func:`make_mesh` made last in this process, as ``torch.distributed``
keeps its default group per process (the models reach them deep inside a
forward pass); with ``model_parallel`` 1, or before any mesh, the data axis
is the default group and the model axis has one rank.  Every collective
of the port is an all-reduce or a broadcast, the two that gloo carries for
CUDA tensors, so the same code runs over NCCL (the default for a card) and
over gloo (the default for the CPU, and two ranks sharing one card).  A
helper over an axis of one rank returns at once: a one-process run issues
no collective.
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
_AXES = (DATA_AXIS, MODEL_AXIS, None)

# Set by torchrun and other launchers: their presence means THIS process is
# one of several, and a failed bootstrap must be fatal.
_LAUNCH_ENV_VARS = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "TORCHELASTIC_RUN_ID")

# Gradient buckets of at most this many bytes each (a flat copy per bucket).
GRAD_BUCKET_BYTES = 64 << 20

_KINDS = ("all_reduce", "broadcast")
_COUNTS = {(axis, kind): 0 for axis in _AXES for kind in _KINDS}
_BYTES = dict(_COUNTS)

# The mesh make_mesh made last in this process (its groups serve the axes).
_ACTIVE = None


def collective_counts(axis: str | None = "all") -> dict:
    """Collectives issued by this process since the last reset, by kind (the
    backward pass's all-reduces included): over every axis (the default),
    or over one of ``"data"``, ``"model"`` and None (every process)."""
    axes = _AXES if axis == "all" else (axis,)
    return {kind: sum(_COUNTS[(a, kind)] for a in axes) for kind in _KINDS}


def collective_bytes(axis: str | None = "all") -> dict:
    """The bytes of the tensors those collectives carried, by kind, as
    :func:`collective_counts` counts them."""
    axes = _AXES if axis == "all" else (axis,)
    return {kind: sum(_BYTES[(a, kind)] for a in axes) for kind in _KINDS}


def reset_collective_counts():
    """Zero the counts and bytes of :func:`collective_counts` and
    :func:`collective_bytes`."""
    for k in _COUNTS:
        _COUNTS[k] = _BYTES[k] = 0


def _count(axis, kind: str, t: torch.Tensor):
    _COUNTS[(axis, kind)] += 1
    _BYTES[(axis, kind)] += t.numel() * t.element_size()


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
    """The ``(data, model)`` layout as one process sees it: ``world_size``
    processes (one card each), this one's ``rank`` and ``local_rank``, its
    ``device``, the default process ``group`` (None without one), the
    ``model_parallel`` width ``t`` and, for ``t > 1``, this rank's data and
    model groups.  ``shape`` reads as the JAX mesh's,
    ``{"data": W // t, "model": t}``."""

    world_size: int
    rank: int
    local_rank: int
    device: torch.device
    group: Any = None
    model_parallel: int = 1
    data_group: Any = None
    model_group: Any = None

    @property
    def data_size(self) -> int:
        return self.world_size // self.model_parallel

    @property
    def data_index(self) -> int:
        return self.rank // self.model_parallel

    @property
    def model_index(self) -> int:
        return self.rank % self.model_parallel

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data_size, MODEL_AXIS: self.model_parallel}


def _groups(w: int, r: int, t: int):
    """``(data group, model group)`` of rank ``r``: every rank creates every
    group, in the same order (``new_group`` is collective over the default
    group), and keeps its own two."""
    data = model = None
    for m in range(t):
        g = dist.new_group(list(range(m, w, t)))
        if r % t == m:
            data = g
    for d in range(w // t):
        g = dist.new_group(list(range(d * t, d * t + t)))
        if r // t == d:
            model = g
    return data, model


def make_mesh(model_parallel: int = 1, device=DEFAULT_DEVICE) -> Mesh:
    """The ``(data, model)`` mesh over the processes of the default group
    (one process, world size 1, when none is up); its groups serve the
    axes of this process's collectives from here on.  Raises
    ``ValueError`` when ``model_parallel`` does not divide the world, as
    the JAX package's ``make_mesh`` does.  A second call for the same
    world and width keeps the groups of the first."""
    global _ACTIVE
    up = dist.is_available() and dist.is_initialized()
    w, r = world_size(), rank()
    if model_parallel < 1 or w % model_parallel:
        raise ValueError(
            f"{w} devices not divisible by model_parallel={model_parallel}")
    world = dist.group.WORLD if up else None
    groups = (None, None)
    if model_parallel > 1:
        old = _ACTIVE
        if (old is not None and old.group is world and old.world_size == w
                and old.model_parallel == model_parallel):
            groups = (old.data_group, old.model_group)
        else:
            groups = _groups(w, r, model_parallel)
    mesh = Mesh(world_size=w, rank=r,
                local_rank=int(os.environ.get("LOCAL_RANK", 0)) if up else 0,
                device=rank_device(device), group=world,
                model_parallel=model_parallel,
                data_group=groups[0], model_group=groups[1])
    _ACTIVE = mesh
    return mesh


def _axis(axis: str | None):
    """``(group, size, index)`` of this process on ``axis``: the active
    mesh's group for a ``model_parallel > 1`` mesh over the default group
    that is up; else the default group for the data axis and None, and one
    rank with the model axis."""
    if not (dist.is_available() and dist.is_initialized()):
        return None, 1, 0
    mesh = _ACTIVE
    if (axis is not None and mesh is not None and mesh.model_parallel > 1
            and mesh.group is dist.group.WORLD):
        if axis == DATA_AXIS:
            return mesh.data_group, mesh.data_size, mesh.data_index
        return mesh.model_group, mesh.model_parallel, mesh.model_index
    if axis == MODEL_AXIS:
        return None, 1, 0
    return dist.group.WORLD, dist.get_world_size(), dist.get_rank()


def axis_size(axis: str | None = DATA_AXIS) -> int:
    """Ranks on ``axis`` (``"data"``, ``"model"``, None: every process)."""
    return _axis(axis)[1]


def axis_index(axis: str | None = DATA_AXIS) -> int:
    """This process's index on ``axis``."""
    return _axis(axis)[2]


def check_row_order(mesh: Mesh) -> None:
    """Verify the global-batch row layout that ``predict`` relies on.

    A global batch is the data groups' local rows in data-index order
    (``ShardedLoader.global_index_batches``): data index ``d`` holds block
    ``d``.  That holds when the mesh's rank is the process's rank in the
    default group and the mesh spans that group; raise early otherwise
    rather than silently permuting predictions.
    """
    if (mesh.world_size, mesh.rank) != (world_size(), rank()):
        raise ValueError(
            f"mesh (world {mesh.world_size}, rank {mesh.rank}) is not this "
            f"process's place in the default group (world {world_size()}, "
            f"rank {rank()}); global-batch rows would not be in rank order")


def _rows(x, mesh: Mesh, axis: int):
    n = x.shape[axis]
    if n % mesh.data_size:
        raise ValueError(f"{n} rows do not divide over {mesh.data_size} ranks")
    b = n // mesh.data_size
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    t = t.narrow(axis, mesh.data_index * b, b).contiguous()
    return t.to(mesh.device, non_blocking=True)


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's rows of a host-global batch (block ``data_index`` of the
    batch axis: the ranks of one model group take the same rows), on the
    rank's device."""
    return {k: _rows(v, mesh, 0) for k, v in batch.items()}


def shard_super_batch(mesh: Mesh, super_batch: dict) -> dict:
    """This rank's rows of a ``(k, global batch, ...)`` super-batch."""
    return {k: _rows(v, mesh, 1) for k, v in super_batch.items()}


def _all_reduce(t: torch.Tensor, axis: str | None):
    _count(axis, "all_reduce", t)
    dist.all_reduce(t, group=_axis(axis)[0])


def all_reduce_sum_(t: torch.Tensor, axis: str | None = DATA_AXIS) -> torch.Tensor:
    """Sum ``t`` over ``axis`` in place, outside autograd; returns ``t``.  No
    collective over an axis of one rank."""
    if axis_size(axis) > 1:
        with torch.no_grad():
            _all_reduce(t, axis)
    return t


class _AllReduceSum(torch.autograd.Function):
    """``y = sum over the axis of x``; its backward sums the gradient over
    the axis (every rank's loss depends on every rank's ``x``)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        y = x.clone(memory_format=torch.contiguous_format)
        _all_reduce(y, axis)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        _all_reduce(g, ctx.axis)
        return g, None


def all_reduce_sum(t: torch.Tensor, axis: str | None = DATA_AXIS) -> torch.Tensor:
    """Differentiable sum of ``t`` over ``axis`` (a new tensor); ``t``
    itself over an axis of one rank."""
    if axis_size(axis) > 1:
        return _AllReduceSum.apply(t, axis)
    return t


def _src_rank(axis: str | None, src: int) -> int:
    """The default group's rank of ``axis``'s rank ``src``."""
    group = _axis(axis)[0]
    return src if group is dist.group.WORLD else dist.get_global_rank(group, src)


def _broadcast(t: torch.Tensor, axis: str | None, src: int):
    _count(axis, "broadcast", t)
    dist.broadcast(t, _src_rank(axis, src), group=_axis(axis)[0])


def broadcast_(t: torch.Tensor, src: int = 0, axis: str | None = None) -> torch.Tensor:
    """``axis``'s rank ``src``'s ``t`` on every rank of the axis (every
    process by default), in place; returns ``t``."""
    if axis_size(axis) > 1:
        _broadcast(t, axis, src)
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


def all_reduce_grads_(grads, axis: str | None = DATA_AXIS) -> int:
    """Sum the gradients over ``axis`` in place, flattened into buckets of
    at most ``GRAD_BUCKET_BYTES``; returns the number of buckets (0 over an
    axis of one rank)."""
    if axis_size(axis) == 1:
        return 0
    return _bucketed(grads, lambda flat: _all_reduce(flat, axis),
                     GRAD_BUCKET_BYTES)


def broadcast_grads_(grads, axis: str | None = MODEL_AXIS, src: int = 0) -> int:
    """``axis``'s rank ``src``'s gradients on every rank of the axis, in
    place, in buckets as :func:`all_reduce_grads_`; returns the number of
    buckets (0 over an axis of one rank)."""
    if axis_size(axis) == 1:
        return 0
    return _bucketed(grads, lambda flat: _broadcast(flat, axis, src),
                     GRAD_BUCKET_BYTES)


def collective_device() -> torch.device:
    """Where a small tensor for a collective lives: this process's card under
    NCCL (which carries CUDA tensors only), else the CPU."""
    if world_size() > 1 and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier():
    """Every process waits here for the others: an all-reduce of one
    element over every process, read back."""
    if world_size() == 1:
        return
    t = torch.zeros(1, device=collective_device())
    _all_reduce(t, None)
    t.item()
