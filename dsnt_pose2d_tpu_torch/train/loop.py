"""The train, serving and eval steps (port of the step bodies of
``dsnt_pose2d_tpu/train/loop.py``).

:func:`make_train_fn` is ``_build_step_bodies``'s train step: train
preprocess with this step's augmentation draws -> train-mode forward -> loss
-> backward -> optimizer step, BN running statistics updated, step + 1.
:func:`make_infer_fn` is the serving step: canvases -> deterministic eval
preprocess -> forward -> decode of the last stack -> original-image pixels.
:func:`make_eval_fn` is the same path plus the loss over all stacks and the
PCKh counts, returning what the JAX package's ``_build_eval_body`` returns.
Infer and eval run the module in eval mode under
:func:`torch.inference_mode`.

:func:`make_multi_step` runs ``k`` train steps per call over a stacked
super-batch (the JAX package's ``lax.scan``; here a Python loop), and
:func:`make_resident_step` / :func:`make_resident_multi_step` gather each
batch on the device from a :class:`..data.resident.ResidentTrainData` first.
Each takes the train step whose state it advances, so that a multi-step and
a single step (the ragged tail of an epoch) share one optimizer.  Flip and
multi-scale evaluation and the Trainer are not ported yet.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..data.augment import preprocess_batch, sample_train_draws
from ..data.loader import stage_ahead, to_device
from ..data.transforms import invert, transform_coords
from ..device import DEFAULT_DEVICE, resolve_device
from ..evaluation.pckh import pckh_batch_counts
from ..models.factory import PoseModel
from ..utils.config import Config
from .state import create_train_state, step_seed

BATCH_KEYS = ("canvases", "coords_px", "mask", "head_length",
              "canvas_from_orig", "canvas_margin")


def normalized_to_crop_px(coords_norm: torch.Tensor, size: int) -> torch.Tensor:
    return ((coords_norm + 1.0) * size - 1.0) / 2.0


def _to_original_px(coords_norm, crop_from_orig, in_size: int):
    """Map normalized crop-space coords back to ORIGINAL-image pixels."""
    crop_px = normalized_to_crop_px(coords_norm, in_size)
    return transform_coords(invert(crop_from_orig), crop_px)


def _decode_averaged(model: PoseModel, images):
    """Eval-mode forward + decode: ``(raw heatmaps, coords_norm)``.  Only
    the default case (no flip averaging) is ported."""
    heatmaps = model.forward(images, train=False)
    return heatmaps, model.decode(heatmaps)


def _check_device(model: PoseModel, device) -> torch.device:
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(f"model is on {model.device}, step asked for {dev}")
    return dev


def _check_supported(model: PoseModel, cfg: Config, device) -> torch.device:
    dev = _check_device(model, device)
    if cfg.train.flip_eval:
        raise NotImplementedError("flip_eval is not ported yet (ROADMAP Queue 1)")
    if tuple(float(s) for s in (cfg.train.eval_scales or (1.0,))) != (1.0,):
        raise NotImplementedError(
            "multi-scale eval is not ported yet (ROADMAP Queue 1)")
    return dev


def _on_device(batch: dict, dev: torch.device) -> dict:
    """Batch arrays (numpy or tensors) as tensors on ``dev``."""
    out = {}
    for k in BATCH_KEYS:
        v = batch.get(k)
        if v is None:
            continue
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        out[k] = v.to(dev, non_blocking=True)
    return out


def _preprocess(batch: dict, cfg: Config, in_size: int,
                draws: dict | None = None) -> dict:
    return preprocess_batch(
        batch["canvases"], batch["coords_px"], batch["mask"],
        batch["head_length"], batch["canvas_from_orig"], cfg.data, in_size,
        train=draws is not None, canvas_margin=batch.get("canvas_margin"),
        draws=draws)


def make_train_fn(model: PoseModel, cfg: Config, device=DEFAULT_DEVICE,
                  steps_per_epoch: int = 1):
    """Train step: ``step(batch, draws=None) -> {loss, grad_norm, euclidean, reg}``.

    The step's :class:`.state.TrainState` (step count, model, optimizer
    chain, seed) is ``step.state``; each call advances it by one optimizer
    step.  The augmentation draws come from a ``torch.Generator`` on the
    device seeded with ``step_seed(seed, step)``, unless ``draws`` are given
    (the tests pass the JAX package's).  ``grad_norm`` is the global norm of
    the gradients before any clip.  The metrics stay on the device: reading
    them waits for the step.
    """
    dev = _check_device(model, device)
    in_size = model.input_size
    state = create_train_state(model, cfg, steps_per_epoch)

    def train_step(batch: dict, draws: dict | None = None) -> dict:
        batch = _on_device(batch, dev)
        if draws is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(step_seed(state.seed, state.step))
            draws = sample_train_draws(batch["canvases"].shape[0], cfg.data,
                                       gen)
        with torch.no_grad():
            pre = _preprocess(batch, cfg, in_size, draws)
        heatmaps = model.forward(pre["images"], train=True)
        loss, aux = model.loss(heatmaps, pre["coords"], pre["mask"])
        state.optimizer.zero_grad()
        loss.backward()
        grad_norm = state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm,
                "euclidean": aux["euclidean"].detach(),
                "reg": aux["reg"].detach()}

    train_step.state = state
    return train_step


def _stack_metrics(metrics: list[dict]) -> dict:
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def make_multi_step(model: PoseModel, cfg: Config, device=DEFAULT_DEVICE,
                    steps_per_epoch: int = 1, train_step=None):
    """``k`` train steps per call: ``multi(super_batch, draws=None)``.

    Every array of ``super_batch`` has a leading ``k`` axis; step ``i``
    trains on ``{key: v[i]}`` with ``draws[i]`` (or its own draws from
    ``(seed, step)`` when ``draws`` is None).  The metrics come back stacked
    ``(k,)``.  The steps are those of ``train_step`` (a new
    :func:`make_train_fn` step if None), so the result is that of ``k``
    calls of it, bit for bit.  ``multi.state`` is its state.
    """
    train_step = train_step or make_train_fn(model, cfg, device, steps_per_epoch)

    def multi_step(super_batch: dict, draws: list | None = None) -> dict:
        k = len(next(iter(super_batch.values())))
        return _stack_metrics([
            train_step({key: v[i] for key, v in super_batch.items()},
                       None if draws is None else draws[i])
            for i in range(k)])

    multi_step.state = train_step.state
    return multi_step


def _resident_gather(resident: dict, idx: torch.Tensor) -> dict:
    """The batch at rows ``idx`` of every resident array, on the device."""
    return {k: v[idx] for k, v in resident.items()}


def make_resident_step(model: PoseModel, cfg: Config, device=DEFAULT_DEVICE,
                       steps_per_epoch: int = 1, train_step=None):
    """Train step over a device-resident split: ``step(resident, idx,
    draws=None)``.  The same step as the streaming one on the same rows;
    only the batch comes from a gather on the device."""
    train_step = train_step or make_train_fn(model, cfg, device, steps_per_epoch)

    def step(resident: dict, idx: torch.Tensor, draws: dict | None = None):
        return train_step(_resident_gather(resident, idx), draws)

    step.state = train_step.state
    return step


def make_resident_multi_step(model: PoseModel, cfg: Config,
                             device=DEFAULT_DEVICE, steps_per_epoch: int = 1,
                             train_step=None):
    """``k`` resident train steps per call: ``multi(resident, idx_k,
    draws=None)`` with ``idx_k`` of shape ``(k, B)``: the gather gives the
    ``(k, B, ...)`` super-batch of :func:`make_multi_step`."""
    multi = make_multi_step(model, cfg, device, steps_per_epoch, train_step)

    def resident_multi(resident: dict, idx_k: torch.Tensor,
                       draws: list | None = None):
        return multi(_resident_gather(resident, idx_k), draws)

    resident_multi.state = multi.state
    return resident_multi


def _prefetch_dispatch_groups(batch_iter, k: int, device, depth: int = 1):
    """Group host batches into ``k``-step super-batches, staged on the
    device ``depth`` groups ahead of the consumer.

    Yields ``("multi", super_batch)`` for each full group (every array
    stacked ``(k, B, ...)``) and ``("single", batch)`` for each batch of a
    ragged tail.  The host-to-device copies are ``non_blocking`` from pinned
    memory (:func:`..data.loader.to_device`), so they overlap the groups
    that run before them.
    """
    def groups():
        it = iter(batch_iter)
        while group := list(itertools.islice(it, k)):
            if len(group) < k:
                yield from (("single", b) for b in group)
                return
            yield "multi", {key: np.stack([b[key] for b in group])
                            for key in group[0]}

    return stage_ahead(((kind, to_device(host, device)) for kind, host in groups()),
                       depth)


def make_infer_fn(model: PoseModel, cfg: Config, device=DEFAULT_DEVICE):
    """Serving step: batch of canvases -> ``(B, J, 2)`` original-image px."""
    dev = _check_supported(model, cfg, device)
    in_size = model.input_size

    @torch.inference_mode()
    def infer_step(batch: dict) -> torch.Tensor:
        batch = _on_device(batch, dev)
        pre = _preprocess(batch, cfg, in_size)
        _, coords_norm = _decode_averaged(model, pre["images"])
        return _to_original_px(coords_norm, pre["crop_from_orig"], in_size)

    return infer_step


def make_eval_fn(model: PoseModel, cfg: Config, device=DEFAULT_DEVICE):
    """Eval step: ``{loss, pckh_correct, pckh_total, pred_orig}`` per batch."""
    dev = _check_supported(model, cfg, device)
    in_size = model.input_size

    @torch.inference_mode()
    def eval_step(batch: dict) -> dict:
        batch = _on_device(batch, dev)
        pre = _preprocess(batch, cfg, in_size)
        heatmaps, coords_norm = _decode_averaged(model, pre["images"])
        loss, _ = model.loss(heatmaps, pre["coords"], pre["mask"])
        pred_orig = _to_original_px(coords_norm, pre["crop_from_orig"], in_size)
        gt_orig = _to_original_px(pre["coords"], pre["crop_from_orig"], in_size)
        correct, total = pckh_batch_counts(
            pred_orig, gt_orig, pre["mask"], pre["head_length"])
        return {"loss": loss, "pckh_correct": correct, "pckh_total": total,
                "pred_orig": pred_orig}

    return eval_step
