"""Hard-argmax heatmap decoding with a quarter-pixel offset
(port of ``dsnt_pose2d_tpu/ops/decode.py``), the ``gauss`` head's decode.

Take the argmax pixel (``torch.argmax``: the first maximum on ties, as
``jnp.argmax``), shift
it a quarter pixel toward the larger of each axis's two neighbours (no
shift where they are equal), with no shift on a border pixel, then map to
normalized coordinates.  Branch-free: gathers and ``torch.where`` only.
"""

from __future__ import annotations

import torch

from .coords import pixel_to_normalized


def heatmaps_to_coords(heatmaps: torch.Tensor) -> torch.Tensor:
    """Argmax + quarter-offset decode: ``(..., H, W) -> (..., 2)`` normalized."""
    h, w = heatmaps.shape[-2:]
    flat = heatmaps.reshape(*heatmaps.shape[:-2], h * w)
    idx = torch.argmax(flat, dim=-1)
    py = idx // w
    px = idx % w

    def at(y, x):
        pos = y.clamp(0, h - 1) * w + x.clamp(0, w - 1)
        return torch.gather(flat, -1, pos[..., None])[..., 0]

    dx = 0.25 * torch.sign(at(py, px + 1) - at(py, px - 1))
    dy = 0.25 * torch.sign(at(py + 1, px) - at(py - 1, px))
    zero = torch.zeros((), dtype=dx.dtype, device=dx.device)
    dx = torch.where((px > 0) & (px < w - 1), dx, zero)
    dy = torch.where((py > 0) & (py < h - 1), dy, zero)
    coords_px = torch.stack([px.to(heatmaps.dtype) + dx,
                             py.to(heatmaps.dtype) + dy], dim=-1)
    return pixel_to_normalized(coords_px, (h, w))
