"""The DSNT soft-argmax (port of ``dsnt_pose2d_tpu/ops/dsnt.py``).

``x_hat = <Z, X>``, ``y_hat = <Z, Y>`` over normalized pixel-center grids.
"""

from __future__ import annotations

import torch

from .coords import normalized_linspace


def dsnt(heatmaps: torch.Tensor) -> torch.Tensor:
    """Expected (x, y) under ``(..., H, W)`` distributions -> ``(..., 2)``."""
    h, w = heatmaps.shape[-2:]
    xs = normalized_linspace(w, heatmaps.dtype, heatmaps.device)
    ys = normalized_linspace(h, heatmaps.dtype, heatmaps.device)
    x_hat = (heatmaps.sum(dim=-2) * xs).sum(dim=-1)
    y_hat = (heatmaps.sum(dim=-1) * ys).sum(dim=-1)
    return torch.stack([x_hat, y_hat], dim=-1)
