"""Heatmap pre-activations (port of ``dsnt_pose2d_tpu/ops/activations.py``).

Each maps raw heatmaps ``(..., H, W)`` to per-map distributions summing to 1
over the H*W pixels.  The softmax pair is what the fused head kernel takes;
``relu``, ``abs`` and ``sigmoid`` (the paper's ablation) divide by the
per-map sum, floored at ``1e-24``, and run on the plain path only.
"""

from __future__ import annotations

import torch

_EPS = 1e-24


def flat_softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the flattened trailing (H, W) axes, per leading index."""
    *lead, h, w = x.shape
    return torch.softmax(x.reshape(*lead, h * w), dim=-1).reshape(*lead, h, w)


def thresholded_softmax(x: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Softmax restricted to values >= ``threshold``; others get probability 0.

    If every value of a map falls below the threshold, that map falls back
    to the plain softmax, so the output is always a distribution.
    """
    *lead, h, w = x.shape
    flat = x.reshape(*lead, h * w)
    keep = flat >= threshold
    keep = keep | ~keep.any(dim=-1, keepdim=True)
    masked = flat.masked_fill(~keep, float("-inf"))
    return torch.softmax(masked, dim=-1).reshape(*lead, h, w)


def _sum_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.sum(dim=(-2, -1), keepdim=True).clamp_min(_EPS)


def relu_normalized(x: torch.Tensor) -> torch.Tensor:
    """ReLU then divide by the per-map sum."""
    return _sum_normalize(torch.relu(x))


def abs_normalized(x: torch.Tensor) -> torch.Tensor:
    """|x| then divide by the per-map sum."""
    return _sum_normalize(torch.abs(x))


def sigmoid_normalized(x: torch.Tensor) -> torch.Tensor:
    """sigmoid then divide by the per-map sum."""
    return _sum_normalize(torch.sigmoid(x))


HEATMAP_ACTIVATIONS = {
    "softmax": flat_softmax,
    "thresholded_softmax": thresholded_softmax,
    "relu": relu_normalized,
    "abs": abs_normalized,
    "sigmoid": sigmoid_normalized,
}
