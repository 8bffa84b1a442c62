"""The DSNT head, its regularizer and the pose loss in plain fp32 PyTorch.

Softmax over each map, the soft-argmax on the normalized pixel-center grid,
the Jensen-Shannon divergence against a Gaussian of ``sigma_px`` at the
target (eps-guarded logs, 1e-24), the Euclidean coordinate loss, a
visibility-masked mean per stack and the sum over stacks (Nibali et al.,
arXiv:1801.07372, sections 3-4).  Decoding maps the last stack's
coordinates to original-image pixels.
"""

from __future__ import annotations

import torch

_EPS = 1e-24


def grid(length: int, device) -> torch.Tensor:
    """Pixel-center coordinates of an axis, ``(2i + 1) / L - 1``."""
    i = torch.arange(length, dtype=torch.float32, device=device)
    return (2.0 * i + 1.0) / length - 1.0


def softmax_maps(raw: torch.Tensor) -> torch.Tensor:
    *lead, h, w = raw.shape
    return torch.softmax(raw.float().reshape(*lead, h * w), dim=-1).reshape(*lead, h, w)


def soft_argmax(z: torch.Tensor) -> torch.Tensor:
    h, w = z.shape[-2:]
    x = (z.sum(dim=-2) * grid(w, z.device)).sum(dim=-1)
    y = (z.sum(dim=-1) * grid(h, z.device)).sum(dim=-1)
    return torch.stack([x, y], dim=-1)


def gaussian(coords: torch.Tensor, h: int, w: int, sigma_px: float) -> torch.Tensor:
    dx = (grid(w, coords.device) - coords[..., 0:1]) / (2.0 * sigma_px / w)
    dy = (grid(h, coords.device) - coords[..., 1:2]) / (2.0 * sigma_px / h)
    g = torch.exp(-0.5 * (dy[..., :, None] ** 2 + dx[..., None, :] ** 2))
    return g / g.sum(dim=(-2, -1), keepdim=True).clamp_min(_EPS)


def _kl(p, q):
    return (p * (torch.log(p + _EPS) - torch.log(q + _EPS))).sum(dim=(-2, -1))


def js_divergence(z, target, sigma_px):
    g = gaussian(target, *z.shape[-2:], sigma_px)
    m = 0.5 * (z + g)
    return 0.5 * _kl(z, m) + 0.5 * _kl(g, m)


def check_model(model: dict):
    """The head this reference computes: dsnt, softmax, reg none or js,
    Euclidean coordinate loss, stacks summed."""
    got = (model["output_strat"], model["preact"], model["coord_loss"],
           model["stack_loss"])
    if got != ("dsnt", "softmax", "euclidean", "sum") or model["reg"] not in ("none", "js"):
        raise ValueError(f"the reference has no head for {got} with reg {model['reg']!r}")


def pose_loss(raw: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
              model: dict) -> torch.Tensor:
    """``raw`` (S, B, J, H, W), ``target`` (B, J, 2) normalized, ``mask``
    (B, J) -> the scalar loss."""
    z = softmax_maps(raw)
    t = target[None].expand(*raw.shape[:3], 2)
    per_joint = torch.linalg.vector_norm(soft_argmax(z) - t, dim=-1)
    if model["reg"] == "js":
        per_joint = per_joint + model["reg_coeff"] * js_divergence(z, t, model["hm_sigma"])
    count = mask.sum().clamp_min(1.0)
    return ((per_joint * mask[None]).sum(dim=(1, 2)) / count).sum()


def decode(raw_last: torch.Tensor) -> torch.Tensor:
    """The last stack's (B, J, H, W) maps -> (B, J, 2) normalized coords."""
    return soft_argmax(softmax_maps(raw_last))
