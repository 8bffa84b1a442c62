"""A JAX ``TrainState`` -> the port's checkpoint payload (numpy and torch
only; no JAX at run time).

The JAX package checkpoints ``TrainState(step, params, batch_stats,
opt_state, rng)`` (``dsnt_pose2d_tpu/train/state.py``).
:func:`state_payload_from_jax` takes one as a plain tree of numpy arrays
(a mapping, or the dataclass itself after ``jax.device_get``; optax's
states stay the named tuples they are) and returns what
:func:`.checkpoint.state_payload` returns for the same run, ready for
:func:`.checkpoint.load_payload_`:

- ``model``: the weights and BN running statistics through
  :func:`..models.from_jax.pose_net_from_jax`;
- ``optimizer``: the torch optimizer's ``state_dict`` of
  :func:`.state.make_optimizer` for ``cfg.optim``, indexed in the order of
  ``PoseNet(cfg.model).parameters()``; each moment tree goes through
  :func:`..models.from_jax.params_from_jax`, the parameters' own transform:

  ====================================================  =====================================
  optax state                                           port state (per parameter)
  ====================================================  =====================================
  ``rmsprop``: ``ScaleByRmsState.nu``                   ``RMSprop``: ``square_avg``; ``step``
  ``rmsprop`` + momentum: ``TraceState.trace``          ``RMSpropTrace``: ``momentum_buffer``, negated
  ``adam``: ``ScaleByAdamState`` ``count, mu, nu``      ``Adam``: ``step, exp_avg, exp_avg_sq``
  ``sgd`` + momentum: ``TraceState.trace``              ``SGD``: ``momentum_buffer``
  ``ScaleByScheduleState.count``                        ``count`` (:class:`.state.OptimizerChain`)
  ``EmptyState`` (clip, weight decay, no momentum)      nothing
  ====================================================  =====================================

  rmsprop's trace follows ``scale_by_learning_rate`` and so holds the
  negated, lr-scaled updates; :class:`.state.RMSpropTrace` keeps them with
  the sign of the step it subtracts, so its buffer is the trace negated.
  SGD's trace comes before the learning rate: the raw gradients, as
  torch's buffer.  torch's ``step`` is a float32 scalar tensor equal to optax's count
  (Adam's bias correction reads it).  A state is known by its type's name
  and its fields; any other, or a set of states that is not the one
  ``cfg.optim`` makes, raises, so that an optax version that nests or
  names its states otherwise fails here and maps nothing wrongly;
- ``step`` (``TrainState.step``), ``count`` and ``seed`` (``cfg.train.seed``).

The JAX ``rng`` has no counterpart: the port draws a step's augmentation
from ``(seed, step)`` (:func:`.state.step_seed`), so a resumed run takes
other draws than the JAX run would have.  The function returns that note
(:data:`DRAWS_NOTE`) beside the payload.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from ..models.factory import PoseNet
from ..models.from_jax import params_from_jax, pose_net_from_jax
from .state import make_optimizer

DRAWS_NOTE = ("the JAX rng is not carried over: the port draws each step's "
              "augmentation from (seed, step), so a resumed run takes other "
              "draws than the JAX run would have")

# optax state type -> its fields (optax 0.2).
KNOWN_STATES = {
    "ScaleByRmsState": ("nu",),
    "ScaleByAdamState": ("count", "mu", "nu"),
    "TraceState": ("trace",),
    "ScaleByScheduleState": ("count",),
    "EmptyState": (),
}


def _expected_states(optim) -> Counter:
    """The non-empty states the JAX package's ``make_optimizer`` chain of
    ``optim`` holds."""
    rule = {"rmsprop": ["ScaleByRmsState"] + (["TraceState"] if optim.momentum
                                               else []),
            "adam": ["ScaleByAdamState"],
            "sgd": ["TraceState"] if optim.momentum else []}
    if optim.optimizer not in rule:
        raise ValueError(f"unknown optimizer {optim.optimizer!r}")
    return Counter(rule[optim.optimizer] + ["ScaleByScheduleState"])


def optax_states(opt_state) -> list:
    """The states of an optax chain in order (nested tuples flattened), each
    checked against :data:`KNOWN_STATES` by its type's name and fields."""
    if hasattr(opt_state, "_fields"):
        name = type(opt_state).__name__
        fields = tuple(opt_state._fields)
        if KNOWN_STATES.get(name) != fields:
            raise ValueError(
                f"unknown optimizer state {name}{fields}: the converter maps "
                f"{sorted(KNOWN_STATES)} (optax 0.2's names and fields)")
        return [opt_state]
    if isinstance(opt_state, (tuple, list)):
        return [s for sub in opt_state for s in optax_states(sub)]
    raise ValueError(f"unknown optimizer state of type {type(opt_state).__name__}")


def _field(obj, name: str):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def state_payload_from_jax(state, cfg) -> tuple[dict, str]:
    """``(payload, note)``: the JAX ``TrainState`` ``state`` of a run of
    ``cfg`` (the port's ``Config``, read from the run's ``config.json``) as
    :func:`.checkpoint.state_payload` would write it, and what the
    conversion could not carry (:data:`DRAWS_NOTE`)."""
    params = _field(state, "params")
    weights = pose_net_from_jax({"params": params,
                                 "batch_stats": _field(state, "batch_stats")},
                                cfg.model)
    with torch.device("meta"):
        net = PoseNet(cfg.model)
        names = [n for n, _ in net.named_parameters()]
        groups = make_optimizer(net.parameters(), cfg.optim).optimizer \
            .state_dict()["param_groups"]
    if set(names) != set(params_from_jax(params, cfg.model)):
        raise ValueError("the JAX params do not name the parameters of "
                         f"PoseNet({cfg.model.base!r})")

    states = optax_states(_field(state, "opt_state"))
    found = Counter(type(s).__name__ for s in states
                    if type(s).__name__ != "EmptyState")
    want = _expected_states(cfg.optim)
    if found != want:
        raise ValueError(f"optimizer {cfg.optim.optimizer!r} (momentum "
                         f"{cfg.optim.momentum}) holds {dict(want)} in the JAX "
                         f"package's chain; the checkpoint has {dict(found)}")
    by_type = {type(s).__name__: s for s in states}
    count = int(np.asarray(by_type["ScaleByScheduleState"].count))

    def per_param(tree) -> list:
        mapped = params_from_jax(tree, cfg.model)
        return [torch.from_numpy(np.array(mapped[n])) for n in names]

    moments = {}   # torch key -> per-parameter tensors
    if "ScaleByAdamState" in by_type:
        adam = by_type["ScaleByAdamState"]
        moments = {"exp_avg": per_param(adam.mu), "exp_avg_sq": per_param(adam.nu)}
        steps = int(np.asarray(adam.count))
    else:
        steps = count
        if "ScaleByRmsState" in by_type:
            moments["square_avg"] = per_param(by_type["ScaleByRmsState"].nu)
        if "TraceState" in by_type:
            trace = per_param(by_type["TraceState"].trace)
            rms = cfg.optim.optimizer == "rmsprop"
            moments["momentum_buffer"] = [-t for t in trace] if rms else trace
    # torch's RMSprop and Adam keep a per-parameter step; SGD and
    # RMSpropTrace (rmsprop with momentum) keep none.
    with_step = cfg.optim.optimizer == "adam" or (
        cfg.optim.optimizer == "rmsprop" and not cfg.optim.momentum)
    per_index = {}
    for i in range(len(names) if moments else 0):   # plain SGD keeps no state
        step = ({"step": torch.tensor(float(steps), dtype=torch.float32)}
                if with_step else {})
        per_index[i] = {**step, **{k: v[i] for k, v in moments.items()}}
    payload = {"model": {k: torch.from_numpy(np.array(v))
                         for k, v in weights.items()},
               "optimizer": {"state": per_index, "param_groups": groups},
               "count": count,
               "step": int(np.asarray(_field(state, "step"))),
               "seed": int(cfg.train.seed)}
    return payload, DRAWS_NOTE
