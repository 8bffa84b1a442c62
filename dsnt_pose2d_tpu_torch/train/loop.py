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
a single step (the ragged tail of an epoch) share one optimizer.
:func:`make_resident_eval_step` and :func:`make_resident_eval_scan` run the
eval step over a :class:`..data.resident.ResidentEvalData` split.

:class:`Trainer` is the epoch loop: train steps (resident ``k``-step
dispatch groups or streamed single steps), the eval pass at epoch ends
(:func:`run_evaluation`, :func:`run_evaluation_resident`,
:func:`run_evaluation_resident_scan`), checkpoints and metric records,
and auto-pack: a decode-backed train split streams its first epoch while
the packed archive is written, then trains from the archive (resident when
it fits).  The infer and eval steps average a mirrored pass
(``flip_eval``) and several crop scales (``eval_scales``) in original-image
pixels.

:class:`EvalDriver` is the evaluate/infer path without the Trainer: a
restore template, the eval pass, and ``predict`` in dataset order.
:func:`set_debug_nans` makes every train step stop at the first NaN.

Over a mesh of W > 1 ranks (:mod:`..parallel.mesh`), ``(W / t, t)`` as
``(data, model)``, each step runs on this data rank's rows of the global
batch and computes the global batch's step: the draws are the global
batch's, the metrics and the eval counts are summed over the data group,
and ``predict`` gathers every data rank's rows.  The ``t`` ranks of a
model group take the same rows and each holds its shards of the model
(:mod:`..parallel.tp`); the Trainer and ``EvalDriver`` shard the model they
are given.

While a ``torch.profiler`` records, a train step is one ``train`` unit of
:mod:`..utils.spans`' log and a serving call one ``serve`` unit, each
with its spans by layer (``train.feed`` ... ``train.optimizer``,
``serve.feed`` ... ``serve.head``); the resident wrappers' gathers are
``train.feed`` spans logged before the steps they feed.  With no profiler
the spans cost a read of a flag each.
"""

from __future__ import annotations

import functools
import itertools
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..data.augment import preprocess_batch, sample_train_draws
from ..data.loader import prefetch_pairs, prefetch_to_device, stage_ahead, to_device
from ..data.transforms import flip_permutation, invert, transform_coords
from ..device import DEFAULT_DEVICE, resolve_device
from ..evaluation.pckh import PCKhEvaluator, pckh_batch_counts
from ..models.factory import PoseModel
from ..parallel import tp
from ..parallel.mesh import (DATA_AXIS, all_reduce_sum_, axis_index, axis_size,
                             check_row_order, is_main_process, make_mesh,
                             world_size)
from ..utils import spans
from ..utils.config import Config
from ..utils.spans import span
from ..utils.visualization import render_skeleton, save_png
from .state import TrainState, create_train_state, global_norm, step_seed

# The head's aux values that a train step reports, where its head has them.
AUX_METRICS = ("euclidean", "reg", "mse")
BATCH_KEYS = ("canvases", "coords_px", "mask", "head_length",
              "canvas_from_orig", "canvas_margin")

# Most dispatches queued ahead of the oldest result not yet read, in the
# eval passes and in the train loop's metric records: each queued eval step
# pins its input batch in device memory, and a read right after a dispatch
# would wait for it.
_MAX_INFLIGHT = 4


_DEBUG_NANS = False


def set_debug_nans(on: bool):
    """Stop training at the first NaN (the train CLI's ``--debug-nans``; the
    JAX package's ``jax_debug_nans``), process-wide until switched off.

    It turns on autograd's anomaly mode (a backward function that returns
    NaN raises, with the forward op's traceback) and makes every train step
    check its loss before the backward pass and its gradients after it,
    before the optimizer step, raising ``FloatingPointError``.  Unlike
    JAX's, a NaN made in the forward pass is caught at the loss, not at the
    op that made it, and the checks wait for the step (one device sync
    each).  Under a process group of size > 1 anomaly mode keeps its
    tracebacks but does not raise inside the backward pass (one rank would
    leave the others waiting in the next BN all-reduce): the gradient check
    after the sum over ranks raises on every rank together.
    """
    global _DEBUG_NANS
    _DEBUG_NANS = bool(on)
    torch.autograd.set_detect_anomaly(_DEBUG_NANS)


def _backward_checked(loss: torch.Tensor, named_params=(),
                      global_loss: torch.Tensor | None = None):
    """``loss.backward()`` under :func:`set_debug_nans`: a non-finite loss
    (``global_loss`` if given: the loss summed over ranks, the same on every
    rank), a backward function that returns NaN (anomaly mode, in one
    process only) or a non-finite gradient among ``named_params`` raises
    ``FloatingPointError``.  The train step checks its gradients later,
    with their global norm (:func:`_check_grads`), so that every rank
    raises together."""
    checked = loss if global_loss is None else global_loss
    if not torch.isfinite(checked).all():
        raise FloatingPointError(f"debug_nans: the loss is {checked.item()}")
    try:
        with torch.autograd.set_detect_anomaly(True, check_nan=world_size() == 1):
            loss.backward()
    except RuntimeError as e:
        if "returned nan values" in str(e):
            raise FloatingPointError(f"debug_nans: {e}") from e
        raise
    _check_grads(named_params)


def _check_grads(named_params, norm: torch.Tensor | None = None):
    """Raise ``FloatingPointError`` at the first non-finite gradient (under
    :func:`set_debug_nans`), given their global ``norm`` (after the sums
    over ranks: the same on every rank; of these gradients if None).  A
    non-finite norm whose bad gradient is a shard of another model rank's
    raises too, naming none."""
    named = [(n, p.grad) for n, p in named_params if p.grad is not None]
    if not named:
        return
    if norm is None:
        norm = global_norm([g for _, g in named])
    if not torch.isfinite(norm):
        bad = next((n for n, g in named if not torch.isfinite(g).all()), None)
        if bad is None:
            raise FloatingPointError(
                "debug_nans: a gradient shard of another model rank is not finite")
        raise FloatingPointError(f"debug_nans: the gradient of {bad} is not finite")


def _sum_over_ranks(values: dict) -> dict:
    """Each tensor of ``values`` summed over the data group, outside
    autograd, in ONE all-reduce (a flat vector of their common dtype); the
    tensors as they are over a data axis of one rank."""
    values = {k: v.detach() for k, v in values.items()}
    if axis_size(DATA_AXIS) == 1:
        return values
    dtype = functools.reduce(torch.promote_types,
                             (v.dtype for v in values.values()))
    flat = all_reduce_sum_(torch.cat([v.reshape(-1).to(dtype)
                                      for v in values.values()]), DATA_AXIS)
    parts = flat.split([v.numel() for v in values.values()])
    return {k: p.view_as(v).to(v.dtype)
            for (k, v), p in zip(values.items(), parts)}


def _rank_draws(local_batch: int, cfg: Config, dev: torch.device,
                seed: int) -> dict:
    """This rank's rows of the GLOBAL batch's augmentation draws: every rank
    draws for ``D * local_batch`` rows (D data ranks) from a generator
    seeded with ``seed`` and keeps block ``data_index``, so that the data
    ranks see exactly the draws of one process on the global batch (the JAX
    step draws once for it too), and a model group's ranks the same ones."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ranks = axis_size(DATA_AXIS)
    draws = sample_train_draws(local_batch * ranks, cfg.data, gen)
    if ranks == 1:
        return draws
    lo = axis_index(DATA_AXIS) * local_batch
    return {k: None if v is None else v[lo:lo + local_batch]
            for k, v in draws.items()}


def normalized_to_crop_px(coords_norm: torch.Tensor, size: int) -> torch.Tensor:
    return ((coords_norm + 1.0) * size - 1.0) / 2.0


def _to_original_px(coords_norm, crop_from_orig, in_size: int):
    """Map normalized crop-space coords back to ORIGINAL-image pixels."""
    crop_px = normalized_to_crop_px(coords_norm, in_size)
    return transform_coords(invert(crop_from_orig), crop_px)


def _eval_scales(cfg: Config) -> tuple:
    """The multi-scale evaluation's crop scales, canonical first."""
    scales = tuple(float(s) for s in (cfg.train.eval_scales or (1.0,)))
    return scales or (1.0,)


def _decode_averaged(model: PoseModel, cfg: Config, images):
    """Eval-mode forward + decode: ``(output, coords_norm)``.

    ``output`` is the unflipped pass's :class:`..models.heads.PoseOutput`
    (the loss is always scored on the canonical view).  With ``flip_eval``
    a mirrored pass is decoded too, whatever the head: ``images`` are NHWC,
    so the flip is along dim 2 (the width); its x is negated (exact on the
    symmetric pixel-center grid), the L/R joints are swapped and the two
    decodes averaged.  The forward passes are ``serve.backbone`` spans and
    the decodes ``serve.head`` spans, in the eval step too.
    """
    with span("serve.backbone"):
        output = model.forward(images, train=False)
    with span("serve.head"):
        coords_norm = model.decode(output)
    if cfg.train.flip_eval:
        with span("serve.backbone"):
            output_f = model.forward(torch.flip(images, dims=(2,)), train=False)
        with span("serve.head"):
            coords_f = model.decode(output_f)
            perm = flip_permutation(coords_f.shape[-2], device=coords_f.device)
            coords_f = torch.stack([-coords_f[..., 0], coords_f[..., 1]],
                                   dim=-1)[..., perm, :]
            coords_norm = 0.5 * (coords_norm + coords_f)
    return output, coords_norm


def _check_host_split(mesh, *loaders):
    """Each loader must be this rank's host split of ``mesh``, one per data
    index: a loader of the whole stream on every rank would train each rank
    on all rows."""
    for ld in loaders:
        if ld is not None and (getattr(ld, "num_hosts", 1),
                               getattr(ld, "host_id", 0)) != (mesh.data_size,
                                                               mesh.data_index):
            raise ValueError(
                f"loader split over {getattr(ld, 'num_hosts', 1)} hosts "
                f"(host {getattr(ld, 'host_id', 0)}) on data index "
                f"{mesh.data_index} of {mesh.data_size}: pass "
                "num_hosts=W, host_id=rank (with model_parallel t: W // t "
                "and rank // t)")


def _check_device(model: PoseModel, device) -> torch.device:
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(f"model is on {model.device}, step asked for {dev}")
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
                draws: dict | None = None, eval_scale: float = 1.0) -> dict:
    return preprocess_batch(
        batch["canvases"], batch["coords_px"], batch["mask"],
        batch["head_length"], batch["canvas_from_orig"], cfg.data, in_size,
        train=draws is not None, canvas_margin=batch.get("canvas_margin"),
        eval_scale=eval_scale, draws=draws)


def make_train_fn(model: PoseModel, cfg: Config, device=DEFAULT_DEVICE,
                  steps_per_epoch: int = 1):
    """Train step: ``step(batch, draws=None) -> {loss, grad_norm, ...}``,
    plus the head's ``euclidean``, ``reg`` and ``mse`` where its aux has
    them (dsnt: euclidean and reg; gauss: mse; fc: euclidean).  Under
    :func:`set_debug_nans` a NaN loss or gradient raises
    ``FloatingPointError`` before the optimizer step.

    The step's :class:`.state.TrainState` (step count, model, optimizer
    chain, seed) is ``step.state``; each call advances it by one optimizer
    step.  The augmentation draws come from a ``torch.Generator`` on the
    device seeded with ``step_seed(seed, step)`` (:func:`_rank_draws`),
    unless ``draws`` for the batch's rows are given (the tests pass the JAX
    package's).  ``grad_norm`` is the global norm of the gradients before
    any clip.  The metrics stay on the device: reading them waits for the
    step.

    Over a mesh of W > 1 ranks, ``batch`` is this data rank's rows of the
    global batch: BN takes global statistics, the loss is this rank's share
    of the global loss, the gradients are summed over the data group
    (:meth:`.state.OptimizerChain.step`), and the metrics returned are
    those of the global batch, equal on every rank.  A model sharded by
    :func:`..parallel.tp.shard_model_` trains its shards (shard it before
    this call: the optimizer is made over its parameters here).
    """
    dev = _check_device(model, device)
    in_size = model.input_size
    state = create_train_state(model, cfg, steps_per_epoch)

    def train_step(batch: dict, draws: dict | None = None) -> dict:
        with spans.unit("train"):
            with span("train.feed"):
                batch = _on_device(batch, dev)
                if draws is None:
                    draws = _rank_draws(batch["canvases"].shape[0], cfg, dev,
                                        step_seed(state.seed, state.step))
            with span("train.preprocess"), torch.no_grad():
                pre = _preprocess(batch, cfg, in_size, draws)
            with span("train.backbone"):
                output = model.forward(pre["images"], train=True)
            with span("train.head"):
                loss, aux = model.loss(output, pre["coords"], pre["mask"])
                metrics = _sum_over_ranks(
                    {"loss": loss, **{k: aux[k] for k in AUX_METRICS if k in aux}})
            with span("train.optimizer"):
                state.optimizer.zero_grad()
            check = None
            with span("train.backward"):
                if _DEBUG_NANS:
                    _backward_checked(loss, global_loss=metrics["loss"])
                    check = functools.partial(_check_grads, model.net.named_parameters())
                else:
                    loss.backward()
            with span("train.optimizer"):
                grad_norm = state.optimizer.step(check)
            state.step += 1
            return {"loss": metrics.pop("loss"), "grad_norm": grad_norm, **metrics}

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
        with span("train.feed"):
            batch = _resident_gather(resident, idx)
        return train_step(batch, draws)

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
        with span("train.feed"):
            super_batch = _resident_gather(resident, idx_k)
        return multi(super_batch, draws)

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
    """Serving step: batch of canvases -> ``(B, J, 2)`` original-image px.

    One deterministic preprocess, forward and decode per scale of
    ``eval_scales`` (each with its mirrored pass under ``flip_eval``),
    averaged in original-image pixels.
    """
    dev = _check_device(model, device)
    in_size = model.input_size

    @torch.inference_mode()
    def infer_step(batch: dict) -> torch.Tensor:
        with spans.unit("serve"):
            with span("serve.feed"):
                batch = _on_device(batch, dev)
            preds = []
            for s in _eval_scales(cfg):
                with span("serve.preprocess"):
                    pre = _preprocess(batch, cfg, in_size, eval_scale=s)
                _, coords_norm = _decode_averaged(model, cfg, pre["images"])
                with span("serve.head"):
                    preds.append(_to_original_px(coords_norm, pre["crop_from_orig"],
                                                 in_size))
            with span("serve.head"):
                return sum(preds) / len(preds)

    return infer_step


def make_eval_fn(model: PoseModel, cfg: Config, device=DEFAULT_DEVICE):
    """Eval step: ``{loss, pckh_correct, pckh_total, pred_orig}`` per batch.

    The loss and the ground truth's mapping come from the canonical
    scale-1.0 pass, whatever ``eval_scales`` says; each other scale re-crops
    and decodes, and the predictions average in original-image pixels.
    Under data parallelism the loss and the PCKh counts are the global
    batch's (summed over the data group, as the JAX step's psum) and
    ``pred_orig`` holds this data rank's rows.
    """
    dev = _check_device(model, device)
    in_size = model.input_size

    @torch.inference_mode()
    def eval_step(batch: dict) -> dict:
        batch = _on_device(batch, dev)
        pre = _preprocess(batch, cfg, in_size)
        output, coords_norm = _decode_averaged(model, cfg, pre["images"])
        loss, _ = model.loss(output, pre["coords"], pre["mask"])
        pred_canonical = _to_original_px(coords_norm, pre["crop_from_orig"],
                                         in_size)
        preds = []
        for s in _eval_scales(cfg):
            if s == 1.0:
                preds.append(pred_canonical)
                continue
            pre_s = _preprocess(batch, cfg, in_size, eval_scale=s)
            _, coords_s = _decode_averaged(model, cfg, pre_s["images"])
            preds.append(_to_original_px(coords_s, pre_s["crop_from_orig"],
                                         in_size))
        pred_orig = sum(preds) / len(preds)
        gt_orig = _to_original_px(pre["coords"], pre["crop_from_orig"], in_size)
        correct, total = pckh_batch_counts(
            pred_orig, gt_orig, pre["mask"], pre["head_length"])
        sums = _sum_over_ranks({"loss": loss, "pckh_correct": correct,
                                "pckh_total": total})
        return {**sums, "pred_orig": pred_orig}

    return eval_step


def make_resident_eval_step(model: PoseModel, cfg: Config,
                            device=DEFAULT_DEVICE, eval_step=None):
    """Eval step over a device-resident val split: ``step(resident, idx,
    valid)``.  The streaming eval step on the gathered rows, with the
    ``(B,)`` ``valid`` vector multiplied into the joint mask, so that pad
    rows count in neither the masked loss nor the PCKh counts."""
    eval_step = eval_step or make_eval_fn(model, cfg, device)

    def step(resident: dict, idx: torch.Tensor, valid: torch.Tensor) -> dict:
        batch = _resident_gather(resident, idx)
        batch["mask"] = batch["mask"] * valid[:, None]
        return eval_step(batch)

    return step


def make_resident_eval_scan(model: PoseModel, cfg: Config,
                            device=DEFAULT_DEVICE, eval_step=None):
    """The whole resident eval pass in one call: ``scan(resident, idxs,
    valids)`` with ``(steps, B)`` ``idxs``/``valids``
    (:meth:`..data.resident.ResidentEvalData.epoch_stacked`), per-step
    outputs stacked on a leading axis: those of ``steps`` sequential
    :func:`make_resident_eval_step` calls, bit for bit (the JAX package's
    ``lax.scan``; here a loop)."""
    step = make_resident_eval_step(model, cfg, device, eval_step)

    def scan_eval(resident: dict, idxs: torch.Tensor, valids: torch.Tensor):
        return _stack_metrics([step(resident, idx, valid)
                               for idx, valid in zip(idxs, valids)])

    return scan_eval


def _dump_samples(sample_dir: str, epoch: int, batch: dict,
                  pred_orig: np.ndarray, max_n: int = 4):
    """Render the predicted skeletons over the first few canvases as
    ``epoch<epoch>_s<i>.png``."""
    os.makedirs(sample_dir, exist_ok=True)
    canvases = np.asarray(batch["canvases"])[:max_n]
    m = torch.from_numpy(np.asarray(batch["canvas_from_orig"], np.float32)[:max_n])
    mask = np.asarray(batch["mask"])[:max_n]
    pred = torch.from_numpy(np.asarray(pred_orig, np.float32)[:max_n])
    pred_canvas = transform_coords(m, pred).numpy()
    for i, canvas in enumerate(canvases):
        img = render_skeleton(canvas, pred_canvas[i], mask[i])
        save_png(img, os.path.join(sample_dir, f"epoch{epoch:04d}_s{i}.png"))


def _lagged_eval(outputs, num_joints: int):
    """Reduce ``(host batch or None, step output)`` pairs as an iterator
    dispatches them, each output read ``_MAX_INFLIGHT`` dispatches after its
    own, so that the pass pipelines without queuing more steps than that
    (each queued step pins its input batch in device memory).  Returns
    ``({"loss", "pckh", "evaluator"}, first pair)``; ``loss`` is the mean of
    the per-step losses."""
    evaluator = PCKhEvaluator(num_joints)
    losses, first, inflight = [], None, deque()

    def drain(out):
        evaluator.add_counts(out["pckh_correct"], out["pckh_total"])
        losses.append(float(out["loss"]))

    for pair in outputs:
        inflight.append(pair[1])
        if first is None:
            first = pair
        if len(inflight) > _MAX_INFLIGHT:
            drain(inflight.popleft())
    while inflight:
        drain(inflight.popleft())
    return {"loss": float(np.mean(losses)) if losses else float("nan"),
            "pckh": evaluator.total_pckh(), "evaluator": evaluator}, first


def _resident_sample_batch(res, dataset) -> dict:
    """The host rows of the resident pass's first step (the pass never
    builds a host batch), for the sample renders: shard 0's, rank 0's."""
    from ..data.resident import resident_arrays

    rows = res.host_rows(0)[:4]
    return {k: np.asarray(a[rows]) for k, a in resident_arrays(dataset).items()}


def run_evaluation(eval_step, device, loader, num_joints: int,
                   sample_dir: str | None = None, epoch: int = 0) -> dict:
    """One full pass of ``loader`` through an eval step:
    ``{"loss", "pckh", "evaluator"}``.  Batches are copied to the device
    ahead of the step that reads them; results are read behind it
    (:func:`_lagged_eval`)."""
    result, first = _lagged_eval(
        ((host, eval_step(dev)) for host, dev in
         prefetch_pairs(loader.epoch(0), device)), num_joints)
    if sample_dir and first is not None and is_main_process():
        _dump_samples(sample_dir, epoch, first[0],
                      first[1]["pred_orig"].cpu().numpy())
    return result


def run_evaluation_resident(resident_eval_step, res, num_joints: int,
                            sample_dir: str | None = None, epoch: int = 0,
                            dataset=None) -> dict:
    """One full eval pass over a device-resident val split, one dispatch a
    step (a ``(B,)`` index and valid vector uploaded each), results read
    behind as in :func:`run_evaluation`."""
    result, first = _lagged_eval(
        ((None, resident_eval_step(res.resident, idx, valid))
         for idx, valid in res.epoch()), num_joints)
    if (sample_dir and first is not None and dataset is not None
            and is_main_process()):
        _dump_samples(sample_dir, epoch, _resident_sample_batch(res, dataset),
                      first[1]["pred_orig"].cpu().numpy())
    return result


def run_evaluation_resident_scan(resident_eval_scan, res, num_joints: int,
                                 sample_dir: str | None = None,
                                 epoch: int = 0, dataset=None) -> dict:
    """One full eval pass as one scan call and one read of its stacked
    results, reduced in the order of :func:`run_evaluation_resident` (its
    loss is the fp32 mean of the stacked per-step losses, as the JAX
    package's)."""
    idxs, valids = res.epoch_stacked()
    stacked = resident_eval_scan(res.resident, idxs, valids)
    host = {k: v.cpu().numpy() for k, v in stacked.items()}
    evaluator = PCKhEvaluator(num_joints)
    for correct, total in zip(host["pckh_correct"], host["pckh_total"]):
        evaluator.add_counts(correct, total)
    if sample_dir and dataset is not None and is_main_process():
        _dump_samples(sample_dir, epoch, _resident_sample_batch(res, dataset),
                      host["pred_orig"][0])
    losses = host["loss"]
    return {"loss": float(losses.mean()) if losses.size else float("nan"),
            "pckh": evaluator.total_pckh(), "evaluator": evaluator}


class _LaggedLog:
    """Metric records whose device values are read ``_MAX_INFLIGHT``
    dispatches after they were queued.

    :meth:`put` starts each value's copy to pinned host memory at once
    (``non_blocking``) and records a CUDA event behind it; :meth:`drain`
    waits on that event, never on the whole device, before it writes the
    record.  No step waits for its own metrics.
    """

    def __init__(self, writer, device: torch.device):
        self.writer = writer
        self.device = device
        self.pending: deque = deque()

    def put(self, rec: dict, vals: dict):
        if self.device.type == "cuda":
            host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    for k, v in vals.items()}
            for k, v in vals.items():
                host[k].copy_(v, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = vals, None
        self.pending.append((rec, host, ready))
        self.drain(_MAX_INFLIGHT)

    def drain(self, limit: int = 0):
        while len(self.pending) > limit:
            rec, host, ready = self.pending.popleft()
            if ready is not None:
                ready.synchronize()
            self.writer.write({**rec, **{k: float(v) for k, v in host.items()}})


@dataclass
class Trainer:
    """The epoch loop: train, eval at epoch ends, checkpoints, metrics.

    The steps carry their state (:class:`.state.TrainState`: the model, the
    optimizer chain, the step count and the seed).  The Trainer builds its
    steps once, and the single, multi-step and resident steps share one
    state, which :meth:`init_state` returns; :meth:`run` trains that object
    and takes no other (restore a checkpoint into it in place).  With
    ``auto_pack`` a decode-backed train split streams epoch 0 through
    :class:`..data.pack.AutoPackDataset` and trains from the published
    archive after it (:meth:`_swap_to_packed`).  For a ``resnet*`` base,
    ``cfg.data.pretrained_resnet`` (a torchvision state dict, ``.npz`` or
    ``torch.save``) is loaded into the backbone when the Trainer is made,
    before its first step.

    Over a ``mesh`` of W processes (:func:`..parallel.mesh.make_mesh`; the
    default group's when None), ``(D, t)`` as ``(data, model)``, each data
    rank trains its share of every global batch: the loaders split hosts as
    ``ShardedLoader(num_hosts=D, host_id=data_index)``, a resident split
    stages its data index's strided shard, and the steps compute the global
    batch's step.  The Trainer shards ``model`` over the model axis
    (:func:`..parallel.tp.shard_model_`, after ``pretrained_resnet`` is
    loaded into the whole model).  Only rank 0 logs, renders samples and
    writes metric records (``metric_writer`` is dropped on the other
    ranks); ``images_per_sec`` counts the global batch; every rank calls
    the checkpointer, which gathers the shards and writes on rank 0.
    """

    model: PoseModel
    cfg: Config
    train_loader: Any
    val_loader: Any = None
    checkpointer: Any = None          # train.checkpoint.CheckpointManager
    metric_writer: Any = None         # train.metrics.MetricWriter
    hooks: tuple = ()
    device: Any = DEFAULT_DEVICE
    mesh: Any = None                  # parallel.mesh.Mesh

    def __post_init__(self):
        self.device = _check_device(self.model, self.device)
        if self.mesh is None:
            self.mesh = make_mesh(device=self.device)
        _check_host_split(self.mesh, self.train_loader, self.val_loader)
        if self.mesh.rank != 0:
            self.metric_writer = None
        self._load_pretrained()
        tp.shard_model_(self.model.net, self.mesh)
        self._autopack = self._maybe_autopack()
        self.resident = self._maybe_resident()
        spe = max((self.resident or self.train_loader).steps_per_epoch, 1)
        k = self.cfg.train.steps_per_dispatch
        self.train_step = make_train_fn(self.model, self.cfg, self.device, spe)
        self.state = self.train_step.state
        self.eval_step = make_eval_fn(self.model, self.cfg, self.device)
        self.resident_step = self.resident_multi = None
        if self.resident is not None:
            self._make_resident_steps()
        elif k > 1:
            # Grouped dispatch is resident-only: on the streaming path a
            # k-step super-batch defeats the overlap of one batch's copy
            # with the previous step.
            self._log0(
                f"steps_per_dispatch={k} "
                "clamped to 1 on the streaming input path (measured slower "
                "than single-step dispatch, docs/bench_streaming.json); "
                "grouped dispatch re-enables when the input is HBM-resident")
        self.val_resident = self._maybe_val_resident()
        self.resident_eval_scan = None
        if self.val_resident is not None:
            self.resident_eval_scan = make_resident_eval_scan(
                self.model, self.cfg, self.device, self.eval_step)

    def _log0(self, msg: str):
        if self.mesh.rank == 0:
            print(msg, flush=True)

    def _load_pretrained(self):
        """Load ``cfg.data.pretrained_resnet`` into a ResNet backbone, in
        place (the optimizer keeps the same parameter objects); the score
        conv and an fc head keep their initialization."""
        path = getattr(self.cfg.data, "pretrained_resnet", "")
        if not path or not self.model.cfg.base.startswith("resnet"):
            return
        from ..models.import_torch import load_torchvision_resnet, read_state_dict

        net = self.model.net
        net.load_state_dict(
            load_torchvision_resnet(net.state_dict(), read_state_dict(path)),
            strict=True)
        self._log0(f"pretrained_resnet: loaded {path} into the backbone")

    def _make_resident_steps(self):
        """The resident single and (k > 1) multi-step over the Trainer's
        own train step: one optimizer state and one step count, whichever
        input path runs."""
        self.resident_step = make_resident_step(
            self.model, self.cfg, self.device, train_step=self.train_step)
        if self.cfg.train.steps_per_dispatch > 1:
            self.resident_multi = make_resident_multi_step(
                self.model, self.cfg, self.device, train_step=self.train_step)

    def _maybe_autopack(self):
        """Install pack-as-you-stream on a decode-backed train split.

        Epoch 0 then doubles as the pack pass (see
        :class:`..data.pack.AutoPackDataset`); the epoch boundary publishes
        the archive and :meth:`_swap_to_packed` swaps the loader (and
        residency).  One process only: the archive's files would collide
        across processes, and each would stream only its share.
        """
        if not getattr(self.cfg.data, "auto_pack", True):
            return None
        if self.mesh.world_size != 1:
            return None
        ds = self.train_loader.dataset
        # Duck-typed: only a decode-backed MPII split (images_dir +
        # canvas_size) needs packing; packed and array-backed ones do not.
        if not (hasattr(ds, "images_dir") and hasattr(ds, "canvas_size")):
            return None
        from ..data.pack import AutoPackDataset

        out_dir = os.path.join(getattr(self.cfg.data, "data_dir", "."), "packed")
        ap = AutoPackDataset(ds, out_dir, subset=getattr(ds, "subset", "train"))
        self.train_loader.dataset = ap
        self._log0(f"auto_pack: epoch 0 streams {len(ds)} samples AND writes "
                   f"the packed archive -> {out_dir} (switching to the mmap "
                   "reader at the epoch boundary; --no-auto-pack disables)")
        return ap

    def _swap_to_packed(self, epoch: int):
        """Publish the auto-packed archive and swap the train input path.

        Residency is evaluated again as at construction, so with
        ``device_resident`` auto/on the next epoch runs the resident steps.
        They are made over :attr:`train_step`, so the optimizer state and
        the step count run on through the swap; steps_per_epoch is
        unchanged (same samples, same batch), and so are the lr schedule
        and the mid-epoch checkpoint cadence.
        """
        from ..data.loader import ShardedLoader
        from ..data.pack import PackedDataset

        packed_dir = self._autopack.finalize()
        subset = self._autopack.subset
        self._autopack = None
        old = self.train_loader
        self.train_loader = ShardedLoader(
            PackedDataset(packed_dir, subset), old.global_batch_size,
            shuffle=old.shuffle, seed=old.seed, num_hosts=old.num_hosts,
            host_id=old.host_id, drop_last=old.drop_last,
            prefetch=old.prefetch, workers=old.workers)
        self._log0(f"auto_pack: published {packed_dir} after epoch {epoch}; "
                   "train input is now the mmap-packed reader")
        self.resident = self._maybe_resident()
        if self.resident is not None:
            self._make_resident_steps()

    def _maybe_resident(self):
        """Stage the train split on the device when configured (and it fits)."""
        mode = getattr(self.cfg.data, "device_resident", "off")
        if mode == "off":
            return None
        from ..data.resident import (ResidentTrainData, resident_arrays,
                                     resident_budget_bytes, resident_fits,
                                     resident_nbytes)

        ds = self.train_loader.dataset
        shards = self.mesh.data_size
        if resident_arrays(ds) is None:
            if mode == "on":
                raise ValueError(
                    "device_resident=on but the train dataset is not "
                    "array-backed; pack it first (data.pack)")
            self._log0("device_resident=auto: train dataset is not "
                       "array-backed -> streaming")
            return None
        share = resident_nbytes(ds) // shards
        budget = resident_budget_bytes(self.device)
        if mode == "auto" and not resident_fits(ds, self.device,
                                                num_shards=shards):
            self._log0(
                f"device_resident=auto: train split {share / 2**30:.2f} "
                f"GiB/device > budget {budget / 2**30:.2f} GiB -> streaming "
                "(raise DSNT_RESIDENT_BUDGET_BYTES to force)")
            return None
        self._log0(
            f"device_resident={mode}: staging train split on the device "
            f"({share / 2**30:.2f} GiB/device, budget {budget / 2**30:.2f} "
            "GiB)")
        return ResidentTrainData(ds, self.cfg.train.batch_size, self.device,
                                 seed=self.cfg.train.seed, num_shards=shards,
                                 shard=self.mesh.data_index)

    def _maybe_val_resident(self):
        """Stage the val split on the device too, when configured and it
        fits beside the staged train split; else the eval pass streams
        (with the same results)."""
        mode = getattr(self.cfg.data, "device_resident", "off")
        if mode == "off" or self.val_loader is None:
            return None
        from ..data.resident import (ResidentEvalData, resident_arrays,
                                     resident_fits, resident_nbytes)

        ds = self.val_loader.dataset
        if resident_arrays(ds) is None:
            return None
        shards = self.mesh.data_size
        staged = self.resident.nbytes if self.resident is not None else 0
        if mode == "auto" and not resident_fits(ds, self.device,
                                                extra_nbytes=staged,
                                                num_shards=shards):
            self._log0(
                "device_resident=auto: val split does not fit beside the "
                "staged train split -> streaming eval")
            return None
        self._log0(
            f"device_resident={mode}: staging val split on the device "
            f"({resident_nbytes(ds) // shards / 2**30:.2f} GiB/device)")
        return ResidentEvalData(ds, self.cfg.train.batch_size, self.device,
                                num_shards=shards, shard=self.mesh.data_index)

    def init_state(self) -> TrainState:
        """The state the Trainer's steps train: the restore template."""
        return self.state

    def run(self, state: TrainState | None = None, start_epoch: int = 0,
            best_pckh: float = -1.0, start_step: int = 0):
        """Train from ``start_epoch`` to ``cfg.train.epochs``; returns
        ``(state, best_pckh)``.

        ``state`` is None or :meth:`init_state`'s object (restored in place
        from a checkpoint).  ``best_pckh`` seeds the best-model tracker: on
        resume pass the recorded best, so that a worse resumed model does
        not take the ``ckpt_best`` slot.  ``start_step`` resumes the FIRST
        epoch at a mid-epoch offset (exact: the epoch's index stream is
        replayed from there, and the augmentation draws derive from the
        restored global step).
        """
        if state is None:
            state = self.state
        elif state is not self.state:
            raise ValueError(
                "run(state=...) takes the Trainer's own state "
                "(init_state()), restored in place: its steps never see "
                "another TrainState and would train on the old weights")
        cfg = self.cfg
        local_bs = self.train_loader.local_batch_size
        k_dispatch = max(cfg.train.steps_per_dispatch, 1)
        every_steps = cfg.train.checkpoint_every_steps
        spe = (self.resident or self.train_loader).steps_per_epoch
        for epoch in range(start_epoch, cfg.train.epochs):
            t0 = time.time()
            losses = []
            step_in_epoch = start_step if epoch == start_epoch else 0

            def maybe_save_step(sie):
                # Only strictly inside the epoch: the boundary save follows.
                if (self.checkpointer and every_steps and sie < spe
                        and sie % every_steps == 0):
                    self.checkpointer.save_step(state, epoch=epoch,
                                                step_in_epoch=sie)

            # The input modes (resident single or multi-step, streamed
            # single steps) become one ("single"|"multi", payload) stream,
            # so that loss bookkeeping, step counting, checkpoint cadence
            # and metric records live in ONE loop.  Single-step dispatch
            # logs the full metrics every ``log_every_steps``; multi-step
            # dispatch logs its last loss once per dispatch (its ragged
            # single tail does not log).
            multi_fn = None
            if self.resident is not None:
                res = self.resident.resident
                single_fn = lambda idx: self.resident_step(res, idx)
                if self.resident_multi is not None:
                    multi_fn = lambda idx: self.resident_multi(res, idx)
                    groups = self.resident.epoch_groups(
                        epoch, k_dispatch, step_in_epoch)
                else:
                    groups = (("single", idx) for idx in
                              self.resident.epoch(epoch, step_in_epoch))
            else:
                single_fn = self.train_step
                groups = (("single", b) for b in prefetch_to_device(
                    self.train_loader.epoch(epoch, step_in_epoch), self.device))

            log = _LaggedLog(self.metric_writer, self.device)
            dispatches = 0  # log gate counter
            steps_done = 0
            base_step = state.step
            log_every_dispatches = max(
                1, cfg.train.log_every_steps // k_dispatch)
            for kind, payload in groups:
                if kind == "single":
                    m = single_fn(payload)
                    losses.append(m["loss"])
                    steps_done += 1
                    step_in_epoch += 1
                    maybe_save_step(step_in_epoch)
                    if (self.metric_writer and multi_fn is None and
                            dispatches % cfg.train.log_every_steps == 0):
                        log.put({"epoch": epoch, "step": base_step + steps_done},
                                m)
                else:
                    ms = multi_fn(payload)
                    losses.append(ms["loss"])  # (k,) on the device
                    steps_done += k_dispatch
                    step_in_epoch += k_dispatch
                    maybe_save_step(step_in_epoch)
                    if (self.metric_writer and
                            dispatches % log_every_dispatches == 0):
                        log.put({"epoch": epoch, "step": base_step + steps_done},
                                {"loss": ms["loss"][-1]})
                dispatches += 1
            if self.metric_writer:
                log.drain(0)
            # One read of the epoch's losses, which waits for its last step.
            flat_losses = (torch.cat([x.reshape(-1) for x in losses]).cpu().numpy()
                           if losses else np.zeros(0, np.float32))
            epoch_time = time.time() - t0
            n_steps = int(flat_losses.size)
            train_loss = float(flat_losses.mean()) if n_steps else float("nan")

            summary = {"epoch": epoch, "train_loss": train_loss,
                       "epoch_seconds": epoch_time,
                       "images_per_sec": n_steps * local_bs * self.mesh.data_size
                       / max(epoch_time, 1e-9)}
            will_ckpt = bool(self.checkpointer) and \
                (epoch + 1) % cfg.train.checkpoint_every_epochs == 0
            if self.val_loader is not None and \
                    (epoch + 1) % cfg.train.eval_every_epochs == 0:
                sample_dir = None
                if self.metric_writer is not None and self.metric_writer.path:
                    sample_dir = os.path.join(
                        os.path.dirname(self.metric_writer.path), "samples")
                tb = time.time()
                val = self.evaluate(sample_dir=sample_dir, epoch=epoch)
                summary.update({"val_loss": val["loss"],
                                "val_pckh": val["pckh"],
                                "eval_seconds": round(time.time() - tb, 3)})
                is_best = val["pckh"] > best_pckh
                best_pckh = max(best_pckh, val["pckh"])
            else:
                is_best = False
            if will_ckpt:
                tb = time.time()
                self.checkpointer.save(epoch, state, is_best=is_best,
                                       metrics=summary)
                summary["ckpt_seconds"] = round(time.time() - tb, 3)
            if self.metric_writer:
                self.metric_writer.write(summary)
            for hook in self.hooks:
                hook(epoch, state, summary)
            if self._autopack is not None:
                # finalize() fills the rows this epoch never fetched (a
                # drop_last tail, a mid-epoch resume), so one streamed
                # epoch, complete or not, is enough to publish.
                self._swap_to_packed(epoch)
        if self.checkpointer:
            self.checkpointer.wait()
        return state, best_pckh

    def evaluate(self, sample_dir: str | None = None, epoch: int = 0) -> dict:
        """One eval pass of the val split with the current weights: the
        resident scan when the split is staged, else the streaming pass."""
        if self.val_resident is not None:
            return run_evaluation_resident_scan(
                self.resident_eval_scan, self.val_resident,
                self.model.cfg.num_joints, sample_dir=sample_dir,
                epoch=epoch, dataset=self.val_loader.dataset)
        return run_evaluation(self.eval_step, self.device, self.val_loader,
                              self.model.cfg.num_joints,
                              sample_dir=sample_dir, epoch=epoch)


@dataclass
class EvalDriver:
    """The evaluate/infer path: the eval and serving steps only, no Trainer.

    Like the Trainer's, its steps close over one :class:`.state.TrainState`
    (the model and an optimizer chain, which a checkpoint also holds):
    :meth:`init_state` returns it as the restore template, a checkpoint
    restores into it in place, and :meth:`evaluate` and :meth:`predict`
    take no other object.  Over a ``mesh`` of W processes the loader is
    this data index's host split: :meth:`evaluate` gives the global counts
    and :meth:`predict` every row, on every rank; it shards
    ``model`` over the model axis, as the Trainer does.
    """

    model: PoseModel
    cfg: Config
    loader: Any
    device: Any = DEFAULT_DEVICE
    mesh: Any = None                  # parallel.mesh.Mesh

    def __post_init__(self):
        self.device = _check_device(self.model, self.device)
        if self.mesh is None:
            self.mesh = make_mesh(device=self.device)
        _check_host_split(self.mesh, self.loader)
        tp.shard_model_(self.model.net, self.mesh)
        self.state = create_train_state(self.model, self.cfg)
        self.eval_step = make_eval_fn(self.model, self.cfg, self.device)
        self._infer_step = None  # made at the first predict()

    def init_state(self) -> TrainState:
        """The restore template: the state the driver's steps read."""
        return self.state

    def _own(self, state):
        if state is not None and state is not self.state:
            raise ValueError(
                "EvalDriver takes its own state (init_state()), restored in "
                "place: its steps never see another TrainState and would "
                "score the template's weights")

    def evaluate(self, state: TrainState | None = None,
                 sample_dir: str | None = None, epoch: int = 0) -> dict:
        self._own(state)
        return run_evaluation(self.eval_step, self.device, self.loader,
                              self.model.cfg.num_joints,
                              sample_dir=sample_dir, epoch=epoch)

    def predict(self, state: TrainState | None = None) -> np.ndarray:
        """Original-image predictions over the loader, in dataset order.

        Rows go back through the loader's per-batch index map
        (:meth:`..data.loader.ShardedLoader.global_index_batches`); pad rows
        (index -1) are dropped by index.  Coverage is an explicit mask, not a
        NaN sentinel: a diverged model's NaN coords are written out.  Over D
        data ranks each step's global batch is gathered first (an all-reduce
        over the data group of a zeroed ``(D * B, J, 2)`` buffer holding
        this rank's rows in block ``data_index``, the layout
        :func:`..parallel.mesh.check_row_order` verifies), so every rank
        returns all rows.
        """
        self._own(state)
        check_row_order(self.mesh)
        if self._infer_step is None:
            self._infer_step = make_infer_fn(self.model, self.cfg, self.device)
        n = len(self.loader.dataset)
        out_arr = np.zeros((n, self.model.cfg.num_joints, 2), np.float32)
        covered = np.zeros((n,), bool)
        gidx = self.loader.global_index_batches(0)

        def scatter(gi, out):
            preds = out.cpu().numpy()
            keep = gi >= 0
            out_arr[gi[keep]] = preds[keep]
            covered[gi[keep]] = True

        # Reads lag dispatches by _MAX_INFLIGHT: each queued step pins its
        # input batch in device memory.
        inflight: deque = deque()
        count = 0
        for _, dev_batch in prefetch_pairs(self.loader.epoch(0), self.device):
            if count < len(gidx):
                inflight.append((gidx[count],
                                 self._gathered(self._infer_step(dev_batch))))
            count += 1
            if len(inflight) > _MAX_INFLIGHT:
                scatter(*inflight.popleft())
        if count != len(gidx):
            raise RuntimeError(f"loader produced {count} batches, index map "
                               f"has {len(gidx)}")
        while inflight:
            scatter(*inflight.popleft())
        if not covered.all():
            raise RuntimeError(
                f"predict() left {int((~covered).sum())} of {n} dataset rows "
                "uncovered (loader/index-map mismatch)")
        return out_arr

    @torch.inference_mode()
    def _gathered(self, local: torch.Tensor) -> torch.Tensor:
        """The global batch's rows from every data rank's ``local`` rows."""
        d, i, b = self.mesh.data_size, self.mesh.data_index, local.shape[0]
        if d == 1:
            return local
        out = local.new_zeros((d * b, *local.shape[1:]))
        out[i * b:(i + 1) * b] = local
        return all_reduce_sum_(out, DATA_AXIS)
