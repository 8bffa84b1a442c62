"""Train state, learning-rate schedule and optimizer
(port of ``dsnt_pose2d_tpu/train/state.py``).

The JAX package builds an optax chain ``clip_by_global_norm -> add_decayed_weights
-> {rmsprop | adam | sgd}`` whose learning rate is ``schedule(count)``, count
being the optimizer's own step counter.  :class:`OptimizerChain` does the same
with a torch optimizer:

- the clip is optax's formula, ``g`` kept when ``norm < max_norm``, else
  ``(g / norm) * max_norm`` (``torch.nn.utils.clip_grad_norm_`` scales by
  ``max_norm / (norm + 1e-6)`` instead);
- weight decay is the torch optimizers' ``weight_decay`` (``g + wd * p``
  before the update rule), which is ``add_decayed_weights``;
- RMSProp is ``torch.optim.RMSprop(alpha=rmsprop_decay, eps=eps)``: eps
  outside the square root, as the JAX package's ``eps_in_sqrt=False``;
- the learning rate of each step is set from the schedule at the chain's
  count before the update, as optax's ``scale_by_learning_rate``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..models.factory import PoseModel
from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, all_reduce_grads_,
                             all_reduce_sum_, broadcast_grads_)
from ..parallel.tp import shard_of
from ..utils.config import Config, OptimConfig


def make_lr_schedule(cfg: OptimConfig, steps_per_epoch: int, epochs: int = 200):
    """``step -> learning rate``: step decay (``lr_drop_factor`` from each of
    ``lr_drop_epochs``, counted in optimizer steps), constant, or cosine to 0
    over ``epochs``, as ``optax.piecewise_constant_schedule`` /
    ``constant_schedule`` / ``cosine_decay_schedule``."""
    if cfg.schedule == "constant":
        return lambda step: cfg.lr
    if cfg.schedule == "cosine":
        total = max(steps_per_epoch, 1) * max(epochs, 1)
        return lambda step: cfg.lr * 0.5 * (1.0 + math.cos(
            math.pi * min(step, total) / total))
    if cfg.schedule != "step":
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    boundaries = sorted({e * steps_per_epoch: cfg.lr_drop_factor
                         for e in cfg.lr_drop_epochs}.items())

    def schedule(step: int) -> float:
        lr = cfg.lr
        for boundary, factor in boundaries:
            if step >= boundary:
                lr *= factor
        return lr

    return schedule


def global_norm(tensors, sharded=()) -> torch.Tensor:
    """``sqrt(sum of squares)`` over all ``tensors``, as ``optax.global_norm``;
    with ``sharded`` tensors (this rank's shards of the model's sharded
    leaves) their squares are summed over the model group and added."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))
    if not sharded:
        return norm
    sq = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(sharded))) ** 2
    return torch.sqrt(norm * norm + all_reduce_sum_(sq, MODEL_AXIS))


@torch.no_grad()
def clip_by_global_norm_(tensors, max_norm: float, norm: torch.Tensor):
    """optax's ``clip_by_global_norm`` in place, given the tensors' ``norm``."""
    keep = norm < max_norm
    for t in tensors:
        t.copy_(torch.where(keep, t, t / norm * max_norm))


class OptimizerChain:
    """clip -> weight decay -> optimizer, with the lr from ``schedule(count)``;
    built by :func:`make_optimizer`."""

    def __init__(self, params: list, optimizer: torch.optim.Optimizer,
                 schedule, max_norm: float):
        self.params = params
        self.optimizer = optimizer
        self.schedule = schedule
        self.max_norm = max_norm
        self.count = 0

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def step(self, check=None) -> torch.Tensor:
        """One update from the parameters' ``.grad``; returns the global norm
        of the gradients before the clip (``optax.global_norm(grads)``).

        Over a data axis of more than one rank the gradients are first
        summed over the data group in place (each data rank's loss is its
        share of the global loss, so the sum is the global gradient; DDP's
        mean would not be), in buckets
        (:func:`..parallel.mesh.all_reduce_grads_`).  Over a model axis of
        more than one rank each replicated leaf's gradient is then model
        rank 0's on every rank of the model group (a bucketed broadcast:
        exact, so the replicated leaves stay bitwise equal across the group
        whatever order each rank's backward summed in), and the norm sums
        the sharded leaves' squares over the model group, each replicated
        leaf counted once.  The norm, the clip and the update then see the
        global gradient on every rank.  ``check``, if given, is called with
        the norm before the update (``--debug-nans``'s finite check: every
        rank sees the same norm, so all raise together).
        """
        params = [p for p in self.params if p.grad is not None]
        grads = [p.grad for p in params]
        all_reduce_grads_(grads, DATA_AXIS)
        whole = [p.grad for p in params if shard_of(p) is None]
        broadcast_grads_(whole, MODEL_AXIS)
        norm = global_norm(whole, [p.grad for p in params if shard_of(p)])
        if check is not None:
            check(norm)
        if self.max_norm:
            clip_by_global_norm_(grads, self.max_norm, norm)
        lr = self.schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1
        return norm


def make_optimizer(params, cfg: OptimConfig, steps_per_epoch: int = 1,
                   epochs: int = 200) -> OptimizerChain:
    """The optimizer chain of ``cfg`` over ``params``."""
    params = list(params)
    kw = dict(lr=cfg.lr, weight_decay=cfg.weight_decay)
    if cfg.optimizer == "rmsprop":
        if cfg.momentum and cfg.schedule != "constant":
            # optax traces the lr-scaled update, torch the unscaled one: the
            # two agree only while the learning rate stays constant.
            raise NotImplementedError(
                "rmsprop with momentum under a changing learning rate is not "
                "ported (torch's momentum buffer would differ from optax's)")
        opt = torch.optim.RMSprop(params, alpha=cfg.rmsprop_decay, eps=cfg.eps,
                                  momentum=cfg.momentum, **kw)
    elif cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, eps=cfg.eps, **kw)
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, momentum=cfg.momentum, **kw)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return OptimizerChain(params, opt,
                          make_lr_schedule(cfg, steps_per_epoch, epochs),
                          cfg.grad_clip_norm)


@dataclass
class TrainState:
    """What a train step reads and advances: the step count, the model (its
    parameters and BN running statistics), the optimizer chain with its
    schedule, and the seed that the step's augmentation draws derive from."""

    step: int
    model: PoseModel
    optimizer: OptimizerChain
    seed: int


def create_train_state(model: PoseModel, cfg: Config,
                       steps_per_epoch: int = 1) -> TrainState:
    """A step count of 0 and a fresh optimizer chain over ``model``."""
    opt = make_optimizer(model.net.parameters(), cfg.optim, steps_per_epoch,
                         cfg.train.epochs)
    return TrainState(step=0, model=model, optimizer=opt, seed=cfg.train.seed)


def step_seed(seed: int, step: int) -> int:
    """The augmentation generator's seed for ``step``: a pure function of
    ``(seed, step)``, as ``jax.random.fold_in(rng, step)`` (not its bits)."""
    return ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)
