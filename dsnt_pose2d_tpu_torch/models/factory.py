"""Model factory (port of ``dsnt_pose2d_tpu/models/factory.py``: the
hourglass, ResNet and ViT bases; and HRNet-W48, which the JAX package
lacks).

:class:`PoseModel` bundles the ``nn.Module`` with the config's loss and
decode functions, the same surface as the JAX package's ``PoseModel``.
Weights come from a seeded :class:`torch.Generator` with flax's default
initializers (LeCun-normal conv and dense kernels, zero biases, unit BN
and LayerNorm scales, the ViT's position embeddings normal with std 0.02,
the fc head's kernel normal with std 1e-3), or are converted from flax
variables by :mod:`.from_jax`.  ``cfg.remat`` reaches the hourglass and
the ViT; a ResNet ignores it, as in the JAX package, and so does HRNet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

from ..device import DEFAULT_DEVICE, resolve_device
from ..parallel import tp
from ..utils.config import ModelConfig
from .heads import PoseOutput, decode_coords, pose_loss
from .hourglass import HourglassNet
from .hrnet import HRNET_SPECS, HRNetPose
from .resnet import RESNET_SPECS, ResNetPose
from .vit import LayerNorm, ViTPose

# (embed dim, depth, heads); 16px patches, stride-8 heatmaps.
VIT_SPECS = {
    "vit_t16": (192, 4, 3),
    "vit_s16": (384, 12, 6),
    "vit_b16": (768, 12, 12),
}

# flax's lecun_normal draws from a normal truncated at 2 std, rescaled by
# this factor so the variance is exactly 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


class PoseNet(nn.Module):
    """Backbone by config (+ the fc strategy's per-joint linear head);
    returns a :class:`.heads.PoseOutput` of raw ``(S, B, J, H, W)`` fp32
    heatmaps (and ``(S, B, J, 2)`` fc coords)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        if cfg.base.startswith("hg"):
            self.backbone = HourglassNet(
                num_stacks=int(cfg.base[2:]), num_joints=cfg.num_joints,
                features=cfg.hg_features, depth=cfg.hg_depth, dtype=dtype,
                remat=cfg.remat)
        elif cfg.base in RESNET_SPECS:
            self.backbone = ResNetPose(
                arch=cfg.base, num_joints=cfg.num_joints, dilate=cfg.dilate,
                truncate=cfg.truncate, dtype=dtype)
        elif cfg.base in VIT_SPECS:
            dim, depth, heads = VIT_SPECS[cfg.base]
            self.backbone = ViTPose(
                num_joints=cfg.num_joints, dim=dim, depth=depth,
                num_heads=heads, input_size=cfg.resolved_input_size,
                dtype=dtype, remat=cfg.remat)
        elif cfg.base in HRNET_SPECS:
            self.backbone = HRNetPose(num_joints=cfg.num_joints, dtype=dtype,
                                      **HRNET_SPECS[cfg.base])
        else:
            raise ValueError(f"unknown base model {cfg.base!r}")
        self.fc_head_kernel = self.fc_head_bias = None
        if cfg.output_strat == "fc":
            side = self.backbone.output_side(cfg.resolved_input_size)
            # One (H*W -> 2) projection per joint, shared across stacks.
            self.fc_head_kernel = nn.Parameter(
                torch.zeros(cfg.num_joints, side * side, 2))
            self.fc_head_bias = nn.Parameter(torch.zeros(cfg.num_joints, 2))

    def forward(self, images) -> PoseOutput:
        raw = self.backbone(images)
        if self.fc_head_kernel is None:
            return PoseOutput(raw)
        s, b, j, h, w = raw.shape
        # The flat maps in fp32, as the JAX package takes them (an fp64
        # model's too), then in the head's own dtype.
        flat = raw.reshape(s, b, j, h * w).float().to(self.fc_head_kernel.dtype)
        if tp.shard_of(self.fc_head_kernel) is None:
            fc = torch.einsum("sbjp,jpc->sbjc", flat, self.fc_head_kernel)
            return PoseOutput(raw, fc + self.fc_head_bias)
        # Column-parallel: kernel and bias are sharded on the coordinate.
        fc = torch.einsum("sbjp,jpc->sbjc", tp.copy_to_model(flat),
                          self.fc_head_kernel) + self.fc_head_bias
        return PoseOutput(raw, tp.gather_features(fc, -1))


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

    @property
    def heatmap_size(self) -> int:
        """Output heatmap side implied by base/dilate/truncate (the JAX
        package's formula)."""
        size = self.cfg.resolved_input_size
        if self.cfg.base.startswith(("hg", "hrnet")):
            return size // 4
        if self.cfg.base.startswith("vit"):
            return size // 8
        return size // (32 // (2 ** (self.cfg.dilate + self.cfg.truncate)))

    def forward(self, images, train: bool = False) -> PoseOutput:
        if self.net.training != train:
            self.net.train(train)
        return self.net(images)

    def loss(self, output, target_coords, mask):
        return pose_loss(output, target_coords, mask, self.cfg)

    def decode(self, output):
        return decode_coords(output, self.cfg)


@torch.no_grad()
def init_weights(net: nn.Module, generator: torch.Generator):
    """flax-default initialization drawn from ``generator`` (CPU tensors),
    in module order, then the fc head: LeCun-normal conv and dense kernels
    (fan-in ``in_channels * kh * kw`` or ``in_features``; the ViT's ``qkv``
    too, whose flax kernel is ``(D, 3, H, hd)`` over fan-in ``D``), zero
    biases, unit/zero BN and LayerNorm affines, and the ViT's position
    embeddings normal with std 0.02 (not truncated)."""
    for mod in net.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
            nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, ViTPose):
            mod.pos_row.normal_(0.0, 0.02, generator=generator)
            mod.pos_col.normal_(0.0, 0.02, generator=generator)
    if getattr(net, "fc_head_kernel", None) is not None:
        net.fc_head_kernel.normal_(0.0, 1e-3, generator=generator)
        net.fc_head_bias.zero_()


def build_pose_model(cfg: ModelConfig, device=DEFAULT_DEVICE, seed: int = 0,
                     state_dict: dict | None = None) -> PoseModel:
    """Build the model for ``cfg`` on ``device``, in eval mode.

    Weights are drawn from ``torch.Generator().manual_seed(seed)`` unless a
    ``state_dict`` (e.g. from :func:`.from_jax.pose_net_from_jax`) is given,
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
