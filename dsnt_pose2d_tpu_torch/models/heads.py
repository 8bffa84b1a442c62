"""Output strategies: DSNT, heatmap matching (``gauss``) and FC regression
(port of ``dsnt_pose2d_tpu/models/heads.py``).

The backbone emits per-stack raw score maps ``(S, B, J, H, W)``
(:class:`PoseOutput`):

- ``dsnt``: activate, soft-argmax, an optional distribution regularizer on
  the activated maps; the hot path runs as the fused DSNT-head kernel when
  :func:`use_cuda_head` allows it;
- ``gauss``: pixelwise MSE of the raw fp32 maps against a Gaussian rendered
  at the target (peak 1 unless ``gauss_target_normalize``); decoded by the
  argmax with a quarter-pixel offset (:func:`..ops.heatmaps_to_coords`);
- ``fc``: a per-joint linear map of the flat raw map to (x, y)
  (``PoseOutput.fc_coords``), with the coordinate loss on it.

The loss is a visibility-masked mean per stack, summed (or averaged) over
stacks; only the last stack is decoded.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import torch

from .. import ops
from ..ops.cuda.dsnt_head import PREACT_KINDS, fused_dsnt_head
from ..utils.config import ModelConfig


@dataclass
class PoseOutput:
    """Raw model outputs: ``heatmaps`` (S, B, J, H, W) unactivated scores;
    ``fc_coords`` (S, B, J, 2) for the fc strategy, else None."""

    heatmaps: torch.Tensor
    fc_coords: torch.Tensor | None = None


def activate_heatmaps(raw: torch.Tensor, preact: str,
                      threshold: float = 0.0) -> torch.Tensor:
    """Apply the configured pre-activation, in fp32."""
    raw = raw.to(torch.float32)
    if preact == "thresholded_softmax":
        return ops.thresholded_softmax(raw, threshold)
    return ops.HEATMAP_ACTIVATIONS[preact](raw)


def _reg_losses(act, t, cfg: ModelConfig):
    reg_fn = ops.REGULARIZERS[cfg.reg]
    if reg_fn is None:
        return None
    if cfg.reg == "var":
        return reg_fn(act, cfg.hm_sigma)
    return reg_fn(act, t, cfg.hm_sigma)


def _coord_losses(coords, t, cfg: ModelConfig):
    return ops.COORD_LOSSES[cfg.coord_loss](coords, t)


def _masked_mean_keep_stacks(per_joint, mask):
    """(S, B, J) losses + (S, B, J) mask -> (S,) masked means."""
    mask = mask.to(per_joint.dtype)
    num = (per_joint * mask).sum(dim=(1, 2))
    den = mask.sum(dim=(1, 2)).clamp_min(1.0)
    return num / den


def _stack_reduce(per_stack, cfg: ModelConfig):
    return per_stack.sum() if cfg.stack_loss == "sum" else per_stack.mean()


def pose_loss(output: PoseOutput, target_coords: torch.Tensor,
              mask: torch.Tensor, cfg: ModelConfig):
    """Total loss + aux dict (per-strategy diagnostics).

    Args:
        output: the model's raw outputs.
        target_coords: (B, J, 2) normalized targets.
        mask: (B, J) joint visibility (1 = visible).

    The aux holds ``coords`` (the last stack's, (B, J, 2)) and
    ``euclidean`` and ``reg`` (dsnt), ``mse`` (gauss) or ``euclidean`` (fc).
    """
    raw = output.heatmaps
    t = target_coords[None]
    m = mask[None].expand(raw.shape[:3])
    if cfg.output_strat == "gauss":
        target_hm = ops.make_gauss(t, raw.shape[-2:], cfg.hm_sigma,
                                   normalize=cfg.gauss_target_normalize)
        per_joint = ((raw.to(torch.float32) - target_hm) ** 2).mean(dim=(-2, -1))
        per_stack = _masked_mean_keep_stacks(per_joint, m)
        coords = ops.heatmaps_to_coords(raw[-1].to(torch.float32))
        return _stack_reduce(per_stack, cfg), {"coords": coords,
                                               "mse": per_stack[-1]}
    if cfg.output_strat == "fc":
        per_stack = _masked_mean_keep_stacks(
            _coord_losses(output.fc_coords, t, cfg), m)
        return _stack_reduce(per_stack, cfg), {"coords": output.fc_coords[-1],
                                               "euclidean": per_stack[-1]}
    if cfg.output_strat != "dsnt":
        raise ValueError(f"unknown output strategy {cfg.output_strat!r}")
    if use_cuda_head(cfg):
        coords, reg = fused_dsnt_head(
            raw.to(torch.float32), t.expand(*raw.shape[:3], 2),
            sigma_px=cfg.hm_sigma, reg=cfg.reg, preact=cfg.preact,
            threshold=cfg.hm_threshold)
    else:
        act = activate_heatmaps(raw, cfg.preact, cfg.hm_threshold)
        coords = ops.dsnt(act)
        reg = _reg_losses(act, t, cfg)
    euc = _coord_losses(coords, t, cfg)
    per_joint = euc if reg is None else euc + cfg.reg_coeff * reg
    per_stack = _masked_mean_keep_stacks(per_joint, m)
    aux = {"coords": coords[-1],
           "euclidean": ops.average_loss(euc[-1], mask),
           "reg": (ops.average_loss(reg[-1], mask) if reg is not None
                   else torch.zeros((), device=raw.device))}
    return _stack_reduce(per_stack, cfg), aux


def decode_coords(output: PoseOutput, cfg: ModelConfig) -> torch.Tensor:
    """Normalized (x, y) coords from the LAST stack: (B, J, 2)."""
    if cfg.output_strat == "gauss":
        return ops.heatmaps_to_coords(output.heatmaps[-1].to(torch.float32))
    if cfg.output_strat == "fc":
        return output.fc_coords[-1]
    if cfg.output_strat != "dsnt":
        raise ValueError(f"unknown output strategy {cfg.output_strat!r}")
    raw = output.heatmaps[-1]
    if use_cuda_head(cfg):
        coords, _ = fused_dsnt_head(raw.to(torch.float32), None,
                                    sigma_px=cfg.hm_sigma, reg="none",
                                    preact=cfg.preact,
                                    threshold=cfg.hm_threshold)
        return coords
    return ops.dsnt(activate_heatmaps(raw, cfg.preact, cfg.hm_threshold))


_WARNED: set = set()


def _warn_once(msg: str):
    if msg not in _WARNED:
        _WARNED.add(msg)
        warnings.warn(msg, stacklevel=3)


def use_cuda_head(cfg: ModelConfig) -> bool:
    """Whether the fused DSNT-head kernel runs for this config.

    ``use_pallas`` keeps its name from the shared config schema.  Warns once
    per reason when ``use_pallas=True`` is bypassed.
    """
    if not cfg.use_pallas or cfg.output_strat != "dsnt":
        return False
    if cfg.preact not in PREACT_KINDS:
        _warn_once(f"use_pallas=True but preact={cfg.preact!r} is not fused "
                   f"(kernel supports {PREACT_KINDS}); using the plain ops path")
        return False
    return True
