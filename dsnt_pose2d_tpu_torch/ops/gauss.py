"""Target Gaussians on the normalized grid (port of ``dsnt_pose2d_tpu/ops/gauss.py``).

Sigma is in pixels, ``2 * sigma / L`` in normalized units per axis.
"""

from __future__ import annotations

import torch

from .coords import normalized_linspace

_EPS = 1e-24


def make_gauss(coords: torch.Tensor, size_hw, sigma_px,
               normalize: bool = True) -> torch.Tensor:
    """Gaussians centered at normalized ``(..., 2)`` coords -> ``(..., H, W)``."""
    h, w = size_hw
    xs = normalized_linspace(w, coords.dtype, coords.device)
    ys = normalized_linspace(h, coords.dtype, coords.device)
    std_x = 2.0 * sigma_px / w
    std_y = 2.0 * sigma_px / h
    dx = (xs - coords[..., 0:1]) / std_x                 # (..., W)
    dy = (ys - coords[..., 1:2]) / std_y                 # (..., H)
    gauss = torch.exp(-0.5 * (dy[..., :, None] ** 2 + dx[..., None, :] ** 2))
    if normalize:
        denom = gauss.sum(dim=(-2, -1), keepdim=True)
        gauss = gauss / denom.clamp_min(_EPS)
    return gauss
