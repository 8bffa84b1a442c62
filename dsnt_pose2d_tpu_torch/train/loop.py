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
:func:`torch.inference_mode`.  Flip and multi-scale evaluation, multi-step
dispatch and the Trainer are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.augment import preprocess_batch, sample_train_draws
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
