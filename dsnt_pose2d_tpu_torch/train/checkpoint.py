"""Checkpoints: the latest epochs, the best by val PCKh and mid-epoch saves
(port of ``dsnt_pose2d_tpu/train/checkpoint.py``).

The JAX package saves with orbax; the port writes ``torch.save`` files into
the same layout under ``out_dir``:

- ``config.json`` (the run's config) and ``best.json`` (the best epoch and
  its metrics);
- ``ckpt/<epoch>/``: epoch-end saves, the newest ``max_to_keep`` kept;
- ``ckpt_best/<epoch>/``: the best-by-PCKh save, one kept, so that it
  survives the rolling store's collection;
- ``ckpt_step/<global step>/``: mid-epoch saves, two kept.

Each checkpoint directory holds ``state.pt`` (the model's ``state_dict``:
fp32 parameters and BN running statistics; the torch optimizer's
``state_dict``; :attr:`.state.OptimizerChain.count`, which the learning-rate
schedule reads; the global step and the seed) and ``meta.json`` (``epoch``,
``step``, ``step_in_epoch``, ``metrics``).  A save is synchronous and
written to a temporary directory that is renamed into place, so a run that
dies mid-save leaves no partial checkpoint.  A restore loads with
``weights_only=True`` into the template :class:`.state.TrainState` in place:
the steps that hold that state train on from it.

Under data parallelism every rank calls the saves: rank 0 writes (the
replicas are equal), then all ranks meet at a barrier, so that no rank
reads or lists a checkpoint before it is in place.  Under tensor
parallelism a checkpoint stays whole, as a one-process run writes it: the
model group of data index 0 gathers its shards of the parameters and of
their optimizer state (:func:`..parallel.tp.whole_state_dict`,
:func:`..parallel.tp.whole_optimizer_state`) and rank 0 writes.  Every
rank restores the same file, each sharded parameter taking its shard, so a
checkpoint restores at any model-parallel width, bitwise.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import warnings

import torch

from ..parallel import tp
from ..parallel.mesh import DATA_AXIS, axis_index, barrier, is_main_process
from ..utils.config import MODEL_VERSION, Config, config_from_json, config_to_json

CONFIG_FILENAME = "config.json"
BEST_STEP_FILENAME = "best.json"
STATE_FILENAME = "state.pt"
META_FILENAME = "meta.json"


def _to_cpu(obj):
    """``obj`` with every tensor in it on the host (the file is device-free)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def state_payload(state) -> dict:
    """What a checkpoint stores of a :class:`.state.TrainState`, whole, on
    the host (a collective over the model group when the model is
    sharded: every rank of it calls this)."""
    return _to_cpu({"model": tp.whole_state_dict(state.model.net),
                    "optimizer": tp.whole_optimizer_state(
                        state.optimizer.optimizer),
                    "count": state.optimizer.count,
                    "step": state.step, "seed": state.seed})


def load_payload_(state, payload: dict):
    """Load a :func:`state_payload` into ``state`` in place, each sharded
    parameter and its optimizer state taking this rank's shard."""
    tp.load_whole_state_dict_(state.model.net, payload["model"])
    opt = state.optimizer.optimizer
    opt.load_state_dict(tp.local_optimizer_state(opt, payload["optimizer"]))
    state.optimizer.count = int(payload["count"])
    state.step = int(payload["step"])
    state.seed = int(payload["seed"])


def _gathered_payload(state) -> dict | None:
    """:func:`state_payload` on the ranks of data index 0 (rank 0's model
    group gathers the shards), None on the others."""
    return state_payload(state) if axis_index(DATA_AXIS) == 0 else None


class _Store:
    """One directory of checkpoints keyed by an integer, the newest
    ``max_to_keep`` kept (orbax's ``CheckpointManager`` policy)."""

    def __init__(self, root: str, max_to_keep: int):
        self.root = root
        self.max_to_keep = max_to_keep
        os.makedirs(root, exist_ok=True)

    def _dir(self, key: int) -> str:
        return os.path.join(self.root, str(key))

    def all_steps(self) -> list[int]:
        return sorted(int(name) for name in os.listdir(self.root)
                      if name.isdigit() and os.path.exists(
                          os.path.join(self.root, name, META_FILENAME)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, key: int, payload: dict, meta: dict):
        tmp = self._dir(key) + f".tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILENAME))
        with open(os.path.join(tmp, META_FILENAME), "w") as f:
            json.dump(meta, f)
        shutil.rmtree(self._dir(key), ignore_errors=True)
        os.replace(tmp, self._dir(key))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._dir(old))

    def meta(self, key: int) -> dict:
        with open(os.path.join(self._dir(key), META_FILENAME)) as f:
            return json.load(f)

    def restore(self, key: int, state) -> dict:
        payload = torch.load(os.path.join(self._dir(key), STATE_FILENAME),
                             map_location="cpu", weights_only=True)
        load_payload_(state, payload)
        return self.meta(key)


class CheckpointManager:
    def __init__(self, out_dir: str, cfg: Config | None = None,
                 max_to_keep: int = 3):
        self.dir = os.path.abspath(out_dir)
        os.makedirs(self.dir, exist_ok=True)
        if cfg is not None and is_main_process():
            with open(os.path.join(self.dir, CONFIG_FILENAME), "w") as f:
                f.write(config_to_json(cfg))
        self.mgr = _Store(os.path.join(self.dir, "ckpt"), max_to_keep)
        # A one-slot store, so that the best-by-val-PCKh save survives the
        # rolling max_to_keep collection.
        self.best_mgr = _Store(os.path.join(self.dir, "ckpt_best"), 1)
        # Mid-epoch saves, keyed by the GLOBAL step (a store of their own, so
        # step keys never collide with the epoch keys).
        self.step_mgr = _Store(os.path.join(self.dir, "ckpt_step"), 2)

    def save(self, epoch: int, state, *, is_best: bool = False,
             metrics: dict | None = None):
        payload = _gathered_payload(state)
        if is_main_process():
            meta = {"epoch": epoch, "step": state.step, "step_in_epoch": 0,
                    "metrics": metrics or {}}
            self.mgr.save(epoch, payload, meta)
            if is_best:
                self.best_mgr.save(epoch, payload, meta)
                with open(os.path.join(self.dir, BEST_STEP_FILENAME), "w") as f:
                    json.dump({"epoch": epoch, "metrics": metrics or {}}, f)
        barrier()

    def save_step(self, state, *, epoch: int, step_in_epoch: int):
        """Mid-epoch save, keyed by the global step (for an exact resume)."""
        payload = _gathered_payload(state)
        if is_main_process():
            self.step_mgr.save(state.step, payload,
                               {"epoch": epoch, "step": state.step,
                                "step_in_epoch": step_in_epoch, "metrics": {}})
        barrier()

    def restore_latest(self, state_template):
        """Restore the most recent save of the epoch AND step stores.

        Returns ``(state, meta)``; ``meta['step_in_epoch']`` is non-zero iff
        the save was mid-epoch (resume inside that epoch at that offset).
        Epoch-boundary saves win ties: a step save at the same global step
        carries no extra progress and the boundary one resumes cleanly.
        """
        candidates = []
        epoch_key = self.mgr.latest_step()
        if epoch_key is not None:
            candidates.append((self.mgr.meta(epoch_key).get("step", 0), 1,
                               epoch_key))
        step_key = self.step_mgr.latest_step()
        if step_key is not None:
            candidates.append((step_key, 0, step_key))
        if not candidates:
            return None, None
        _, is_epoch, key = max(candidates)
        store = self.mgr if is_epoch else self.step_mgr
        meta = store.restore(key, state_template)
        meta.setdefault("step_in_epoch", 0)
        return state_template, meta

    def restore(self, state_template, epoch: int | None = None):
        """Restore the latest (or the given epoch / recorded best) save into
        the template.

        A recorded best epoch may have been collected by the ``max_to_keep``
        policy: it is then read from the best slot, or, failing that, the
        latest retained checkpoint is used.
        """
        mgr = self.mgr
        steps = set(mgr.all_steps())
        if epoch is not None and epoch not in steps:
            if epoch in set(self.best_mgr.all_steps()):
                mgr = self.best_mgr  # the best slot survived the rolling GC
            else:
                print(f"checkpoint epoch {epoch} no longer retained "
                      f"(have {sorted(steps)}); using latest", file=sys.stderr)
                epoch = None
        if epoch is None:
            epoch = mgr.latest_step()
        if epoch is None:
            return None, None
        return state_template, mgr.restore(epoch, state_template)

    def best_epoch(self) -> int | None:
        path = os.path.join(self.dir, BEST_STEP_FILENAME)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)["epoch"]

    def best_metrics(self) -> dict:
        """Metrics recorded with the best checkpoint ({} if none yet)."""
        path = os.path.join(self.dir, BEST_STEP_FILENAME)
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f).get("metrics", {})

    def load_config(self) -> Config | None:
        path = os.path.join(self.dir, CONFIG_FILENAME)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            cfg = config_from_json(f.read())
        if cfg.model.model_version == 0:
            # Field-less config: written before model_version existed, which
            # does NOT pin it either side of the stem-padding fix.
            warnings.warn(
                f"checkpoint in {self.dir} predates the model_version "
                f"field; if it was trained before the hourglass "
                "stem-padding parity fix its numerics differ from the "
                f"current graph (v{MODEL_VERSION})", stacklevel=2)
        elif cfg.model.model_version < MODEL_VERSION:
            warnings.warn(
                f"checkpoint in {self.dir} was trained with model graph "
                f"v{cfg.model.model_version} (current v{MODEL_VERSION}): it "
                "loads structurally but its numerics predate the hourglass "
                "stem-padding parity fix — expect degraded accuracy; retrain "
                "for current-version numerics", stacklevel=2)
        return cfg

    def wait(self):
        """Saves are synchronous: nothing to wait for."""

    def close(self):
        """Nothing is held open between saves."""


def load_config_from_dir(out_dir: str) -> Config:
    path = os.path.join(out_dir, CONFIG_FILENAME)
    with open(path) as f:
        return config_from_json(f.read())
