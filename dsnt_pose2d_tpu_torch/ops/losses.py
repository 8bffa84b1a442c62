"""Coordinate losses, regularizers and masked averaging
(port of ``dsnt_pose2d_tpu/ops/losses.py``).

KL/JS use ``sum p * (log(p + eps) - log(q + eps))`` with ``eps = 1e-24``,
logs kept in subtraction form.  These are the plain versions of the fused
DSNT-head kernel's regularizer math.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import DATA_AXIS, all_reduce_sum_
from .coords import normalized_linspace
from .gauss import make_gauss

_EPS = 1e-24


def euclidean_losses(actual: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-joint L2 distance between ``(..., 2)`` coordinate pairs."""
    return torch.linalg.vector_norm(actual - target, dim=-1)


def l1_losses(actual: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-joint L1 distance (paper ablation variant)."""
    return (actual - target).abs().sum(dim=-1)


def mse_losses(actual: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-joint squared L2 distance (paper ablation variant)."""
    return ((actual - target) ** 2).sum(dim=-1)


COORD_LOSSES = {
    "euclidean": euclidean_losses,
    "l1": l1_losses,
    "mse": mse_losses,
}


def _kl(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """KL(p || q) over the trailing (H, W) axes, eps-guarded logs."""
    return (p * (torch.log(p + _EPS) - torch.log(q + _EPS))).sum(dim=(-2, -1))


def kl_reg_losses(heatmaps, target_coords, sigma_px):
    """KL(heatmap || Gaussian at target)."""
    gauss = make_gauss(target_coords, heatmaps.shape[-2:], sigma_px)
    return _kl(heatmaps, gauss)


def js_reg_losses(heatmaps, target_coords, sigma_px):
    """Jensen-Shannon divergence between heatmap and Gaussian at target."""
    gauss = make_gauss(target_coords, heatmaps.shape[-2:], sigma_px)
    m = 0.5 * (heatmaps + gauss)
    return 0.5 * _kl(heatmaps, m) + 0.5 * _kl(gauss, m)


def mse_reg_losses(heatmaps, target_coords, sigma_px):
    """Pixelwise mean squared error between heatmap and Gaussian at target."""
    gauss = make_gauss(target_coords, heatmaps.shape[-2:], sigma_px)
    return ((heatmaps - gauss) ** 2).mean(dim=(-2, -1))


def variance_reg_losses(heatmaps, sigma_px):
    """``(var_x - sx^2)^2 + (var_y - sy^2)^2`` with ``s = 2 * sigma_px / L``."""
    h, w = heatmaps.shape[-2:]
    xs = normalized_linspace(w, heatmaps.dtype, heatmaps.device)
    ys = normalized_linspace(h, heatmaps.dtype, heatmaps.device)
    marg_x = heatmaps.sum(dim=-2)
    marg_y = heatmaps.sum(dim=-1)
    mu_x = (marg_x * xs).sum(dim=-1)
    mu_y = (marg_y * ys).sum(dim=-1)
    var_x = (marg_x * xs ** 2).sum(dim=-1) - mu_x ** 2
    var_y = (marg_y * ys ** 2).sum(dim=-1) - mu_y ** 2
    target_var_x = (2.0 * sigma_px / w) ** 2
    target_var_y = (2.0 * sigma_px / h) ** 2
    return (var_x - target_var_x) ** 2 + (var_y - target_var_y) ** 2


REGULARIZERS = {
    "none": None,
    "kl": kl_reg_losses,
    "js": js_reg_losses,
    "mse": mse_reg_losses,
    "var": variance_reg_losses,
}


def visible_count(mask: torch.Tensor) -> torch.Tensor:
    """The masked mean's denominator: the visible joints of the GLOBAL
    batch, at least 1.  Over a data axis of more than one rank the local
    count is summed over the data group (one all-reduce, outside autograd),
    so every data rank's masked mean is its share of the global batch's
    mean, as the JAX package's ``average_loss`` on a ``data`` mesh."""
    count = mask.sum().detach()
    return all_reduce_sum_(count, DATA_AXIS).clamp_min(1.0)


def average_loss(losses: torch.Tensor, mask: torch.Tensor | None = None,
                 count: torch.Tensor | None = None):
    """Visibility-masked mean; invisible joints leave the denominator.

    The denominator is ``count`` if given, else :func:`visible_count` of
    ``mask`` (the global batch's), so under data parallelism the result is
    this rank's share: the sum over ranks is the global mean, and so are
    the summed gradients.  Without a mask it is this batch's plain mean.
    """
    if mask is None:
        return losses.mean()
    mask = mask.to(losses.dtype)
    if count is None:
        count = visible_count(mask)
    return (losses * mask).sum() / count
