"""Model factory (port of ``dsnt_pose2d_tpu/models/factory.py``, hourglass bases).

:class:`PoseModel` bundles the ``nn.Module`` with the config's loss and
decode functions, the same surface as the JAX package's ``PoseModel``.
Weights come from a seeded :class:`torch.Generator` with flax's default
initializers (LeCun-normal conv kernels, zero biases, unit BN scales), or
are converted from flax variables by :mod:`.from_jax`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

from ..device import DEFAULT_DEVICE, resolve_device
from ..utils.config import ModelConfig
from .heads import decode_coords, pose_loss
from .hourglass import HourglassNet

# flax's lecun_normal draws from a normal truncated at 2 std, rescaled by
# this factor so the variance is exactly 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


class PoseNet(nn.Module):
    """Backbone by config; returns raw heatmaps ``(S, B, J, H, W)`` in fp32."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if not cfg.base.startswith("hg"):
            raise NotImplementedError(
                f"base={cfg.base!r} is not ported yet (ROADMAP Queue 1)")
        if cfg.output_strat != "dsnt":
            raise NotImplementedError(
                f"output_strat={cfg.output_strat!r} is not ported yet")
        if cfg.remat:
            raise NotImplementedError(
                "remat=True is not ported yet (ROADMAP Queue 1 item 3)")
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        self.backbone = HourglassNet(
            num_stacks=int(cfg.base[2:]), num_joints=cfg.num_joints,
            features=cfg.hg_features, depth=cfg.hg_depth, dtype=dtype)

    def forward(self, images):
        return self.backbone(images)


@dataclass(frozen=True)
class PoseModel:
    """The module (on ``device``) + head functions for one config.

    :meth:`forward` takes flax's ``train`` switch: it puts the module in
    train mode (batch statistics, running statistics updated) or eval mode
    (running statistics) before running it.
    """

    net: PoseNet
    cfg: ModelConfig
    device: torch.device

    @property
    def input_size(self) -> int:
        """Side of the square model input (the JAX ``image_specs.size``)."""
        return self.cfg.resolved_input_size

    def forward(self, images, train: bool = False):
        if self.net.training != train:
            self.net.train(train)
        return self.net(images)

    def loss(self, heatmaps, target_coords, mask):
        return pose_loss(heatmaps, target_coords, mask, self.cfg)

    def decode(self, heatmaps):
        return decode_coords(heatmaps, self.cfg)


@torch.no_grad()
def init_weights(net: nn.Module, generator: torch.Generator):
    """flax-default initialization drawn from ``generator`` (CPU tensors)."""
    for mod in net.modules():
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.weight[0].numel()
            std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
            nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()


def build_pose_model(cfg: ModelConfig, device=DEFAULT_DEVICE, seed: int = 0,
                     state_dict: dict | None = None) -> PoseModel:
    """Build the model for ``cfg`` on ``device``, in eval mode.

    Weights are drawn from ``torch.Generator().manual_seed(seed)`` unless a
    ``state_dict`` (e.g. from :func:`.from_jax.hourglass_from_jax`) is given,
    which is loaded with ``strict=True``.
    """
    dev = resolve_device(device)
    net = PoseNet(cfg)
    if state_dict is None:
        init_weights(net, torch.Generator().manual_seed(seed))
    else:
        net.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state_dict.items()}, strict=True)
    net.to(dev).eval()
    return PoseModel(net=net, cfg=cfg, device=dev)


def build_mpii_pose_model(base: str = "hg1", dilate: int = 0, truncate: int = 0,
                          output_strat: str = "dsnt", preact: str = "softmax",
                          reg: str = "none", reg_coeff: float = 1.0,
                          hm_sigma: float = 1.0, device=DEFAULT_DEVICE,
                          seed: int = 0, **overrides: Any) -> PoseModel:
    """Build an MPII pose model (the reference's public builder surface).

    Extra keyword ``overrides`` map onto :class:`ModelConfig` fields.
    """
    cfg = ModelConfig(
        base=base, dilate=dilate, truncate=truncate, output_strat=output_strat,
        preact=preact, reg=reg, reg_coeff=reg_coeff, hm_sigma=hm_sigma,
        **overrides)
    return build_pose_model(cfg, device=device, seed=seed)
