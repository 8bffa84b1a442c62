"""Output strategy ``dsnt``: loss and coordinate decoding
(port of the dsnt branch of ``dsnt_pose2d_tpu/models/heads.py``).

The backbone emits per-stack raw score maps ``(S, B, J, H, W)``.  The dsnt
head activates them, takes the soft-argmax, and adds an optional
distribution regularizer; the loss is a visibility-masked mean per stack,
summed (or averaged) over stacks, and only the last stack is decoded.  The
hot path runs as the fused DSNT-head kernel when :func:`use_cuda_head`
allows it.  The ``gauss`` and ``fc`` strategies are not ported yet.
"""

from __future__ import annotations

import warnings

import torch

from .. import ops
from ..ops.cuda.dsnt_head import PREACT_KINDS, fused_dsnt_head
from ..utils.config import ModelConfig


def _not_ported(cfg: ModelConfig):
    return NotImplementedError(
        f"output_strat={cfg.output_strat!r} is not ported yet (ROADMAP Queue 1)")


def activate_heatmaps(raw: torch.Tensor, preact: str,
                      threshold: float = 0.0) -> torch.Tensor:
    """Apply the configured pre-activation, in fp32."""
    raw = raw.to(torch.float32)
    if preact == "thresholded_softmax":
        return ops.thresholded_softmax(raw, threshold)
    if preact not in ops.HEATMAP_ACTIVATIONS:
        raise NotImplementedError(f"preact={preact!r} is not ported yet")
    return ops.HEATMAP_ACTIVATIONS[preact](raw)


def _reg_losses(act, t, cfg: ModelConfig):
    reg_fn = ops.REGULARIZERS[cfg.reg]
    if reg_fn is None:
        return None
    if cfg.reg == "var":
        return reg_fn(act, cfg.hm_sigma)
    return reg_fn(act, t, cfg.hm_sigma)


def _coord_losses(coords, t, cfg: ModelConfig):
    if cfg.coord_loss != "euclidean":
        raise NotImplementedError(
            f"coord_loss={cfg.coord_loss!r} is not ported yet")
    return ops.euclidean_losses(coords, t)


def _masked_mean_keep_stacks(per_joint, mask):
    """(S, B, J) losses + (S, B, J) mask -> (S,) masked means."""
    mask = mask.to(per_joint.dtype)
    num = (per_joint * mask).sum(dim=(1, 2))
    den = mask.sum(dim=(1, 2)).clamp_min(1.0)
    return num / den


def pose_loss(heatmaps: torch.Tensor, target_coords: torch.Tensor,
              mask: torch.Tensor, cfg: ModelConfig):
    """Total loss + aux dict for raw ``(S, B, J, H, W)`` heatmaps.

    Args:
        heatmaps: raw per-stack score maps.
        target_coords: (B, J, 2) normalized targets.
        mask: (B, J) joint visibility (1 = visible).
    """
    if cfg.output_strat != "dsnt":
        raise _not_ported(cfg)
    raw = heatmaps
    t = target_coords[None]
    m = mask[None].expand(raw.shape[:3])
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
    loss = per_stack.sum() if cfg.stack_loss == "sum" else per_stack.mean()
    aux = {"coords": coords[-1],
           "euclidean": ops.average_loss(euc[-1], mask),
           "reg": (ops.average_loss(reg[-1], mask) if reg is not None
                   else torch.zeros((), device=raw.device))}
    return loss, aux


def decode_coords(heatmaps: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Normalized (x, y) coords from the LAST stack: (B, J, 2)."""
    if cfg.output_strat != "dsnt":
        raise _not_ported(cfg)
    raw = heatmaps[-1]
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
