"""Normalized coordinate grids (port of ``dsnt_pose2d_tpu/ops/coords.py``).

For an axis of length ``L`` the center of 0-indexed pixel ``i`` is
``n(i) = (2 * i + 1) / L - 1`` in (-1, 1); coordinates are (x, y) with x along
the width axis.
"""

from __future__ import annotations

import torch

from ..device import device_constant


def normalized_linspace(length: int, dtype=torch.float32,
                        device=None) -> torch.Tensor:
    """Pixel-center coordinates for an axis of ``length`` pixels, in (-1, 1)."""
    i = torch.arange(length, dtype=dtype, device=device)
    return (2.0 * i + 1.0) / length - 1.0


def coordinate_grids(height: int, width: int, dtype=torch.float32,
                     device=None):
    """``(X, Y)`` grids of shape ``(height, width)``."""
    xs = normalized_linspace(width, dtype, device)
    ys = normalized_linspace(height, dtype, device)
    return (xs[None, :].expand(height, width),
            ys[:, None].expand(height, width))


def pixel_to_normalized(coords_px: torch.Tensor, size_hw) -> torch.Tensor:
    """Continuous pixel coords (x, y), pixel-center units in ``[0, L-1]``,
    to normalized (-1, 1) space; ``size_hw = (H, W)``."""
    h, w = size_hw
    scale = device_constant((w, h), coords_px.dtype, coords_px.device)
    return (2.0 * coords_px + 1.0) / scale - 1.0


def normalized_to_pixel(coords_norm: torch.Tensor, size_hw) -> torch.Tensor:
    """Inverse of :func:`pixel_to_normalized`."""
    h, w = size_hw
    scale = device_constant((w, h), coords_norm.dtype, coords_norm.device)
    return ((coords_norm + 1.0) * scale - 1.0) / 2.0
