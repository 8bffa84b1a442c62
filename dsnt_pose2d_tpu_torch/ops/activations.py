"""Heatmap pre-activations (port of ``dsnt_pose2d_tpu/ops/activations.py``).

Both map raw heatmaps ``(..., H, W)`` to per-map distributions summing to 1
over the H*W pixels.
"""

from __future__ import annotations

import torch


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


HEATMAP_ACTIVATIONS = {
    "softmax": flat_softmax,
    "thresholded_softmax": thresholded_softmax,
}
