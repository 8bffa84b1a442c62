"""ResNet backbones with dilation and truncation as ``nn.Module``s
(port of ``dsnt_pose2d_tpu/models/resnet.py``).

ResNet-{18,34,50,101} with

- ``truncate N``: drop the last N stages (raises the heatmap resolution);
- ``dilate N``: trade the stride-2 downsampling of the last N remaining
  stages for dilation, by torchvision's ``replace_stride_with_dilation``
  rule: a converted stage's FIRST block keeps the dilation it had before the
  doubling, only its later blocks take the doubled one;

then a 1x1 conv to J joint score maps.  The submodules take the flax names
(``stem_conv``, ``stage{s}_block{b}.conv1``, ``bn_proj``, ``score``), so flax
variables map one to one (:mod:`.from_jax`), and torchvision's keys by
renaming (:mod:`.import_torch`).  Inputs are NHWC; padding is explicit and
symmetric (torch's convention, which the JAX package pins).  The bf16
convention is the hourglass's: convs under autocast, fp32 parameters and BN
statistics (:class:`.hourglass.BatchNorm`); the score is cast to fp32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from .hourglass import _AUTOCAST_DTYPES, BatchNorm

# (block, per-stage depths); stage s has 64 * 2^s planes (x4 out for bottleneck).
RESNET_SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
}


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, dilation=dilation,
                     padding=dilation * (k // 2), bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = _conv(in_ch, planes, 3, stride, dilation)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, 1, dilation)
        self.bn2 = BatchNorm(planes)
        self.proj = self.bn_proj = None
        if in_ch != planes or stride != 1:
            self.proj = _conv(in_ch, planes, 1, stride)
            self.bn_proj = BatchNorm(planes)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.proj is not None:
            x = self.bn_proj(self.proj(x))
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        out_ch = 4 * planes
        self.conv1 = _conv(in_ch, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation)
        self.bn2 = BatchNorm(planes)
        self.conv3 = _conv(planes, out_ch, 1)
        self.bn3 = BatchNorm(out_ch)
        self.proj = self.bn_proj = None
        if in_ch != out_ch or stride != 1:
            self.proj = _conv(in_ch, out_ch, 1, stride)
            self.bn_proj = BatchNorm(out_ch)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.proj is not None:
            x = self.bn_proj(self.proj(x))
        return F.relu(x + y)


def stage_plan(arch: str, dilate: int = 0, truncate: int = 0) -> list:
    """``[(stage, block, planes, stride, dilation), ...]`` of the blocks the
    JAX package's ``ResNetPose`` builds, in order."""
    _, depths = RESNET_SPECS[arch]
    num_stages = len(depths) - truncate
    if num_stages < 1:
        raise ValueError(f"truncate={truncate} removes every stage")
    plan, dilation = [], 1
    for stage in range(num_stages):
        stride = 1 if stage == 0 else 2
        prev_dilation = dilation
        if stage >= num_stages - dilate and stride == 2:
            stride = 1
            dilation *= 2
        for b in range(depths[stage]):
            plan.append((stage, b, 64 * 2 ** stage, stride if b == 0 else 1,
                         prev_dilation if b == 0 else dilation))
    return plan


class ResNetPose(nn.Module):
    """ResNet trunk + 1x1 score conv: NHWC images -> ``(1, B, J, H, W)``
    raw maps in fp32 whatever ``dtype`` (an fp64 trunk's too, as the JAX
    package casts them); a ResNet is one "stack", so the heads treat every
    backbone alike."""

    def __init__(self, arch: str = "resnet34", num_joints: int = 16,
                 dilate: int = 0, truncate: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kind, _ = RESNET_SPECS[arch]
        block = BasicBlock if kind == "basic" else BottleneckBlock
        self.dtype = dtype
        self.stem_conv = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.stem_bn = BatchNorm(64)
        self.plan = stage_plan(arch, dilate, truncate)
        in_ch = 64
        for stage, b, planes, stride, dilation in self.plan:
            self.add_module(f"stage{stage}_block{b}",
                            block(in_ch, planes, stride, dilation))
            in_ch = planes * block.expansion
        self.score = nn.Conv2d(in_ch, num_joints, 1)

    def output_side(self, side: int) -> int:
        """Side of the score maps for a square input of ``side`` px: the
        stem conv, the max-pool and each remaining stride-2 block give
        ``ceil(side / 2)``."""
        halvings = 2 + sum(1 for _, b, _, stride, _ in self.plan
                           if b == 0 and stride == 2)
        for _ in range(halvings):
            side = -(-side // 2)
        return side

    def _autocast(self, x):
        if self.dtype not in _AUTOCAST_DTYPES:
            return contextlib.nullcontext()
        return torch.autocast(x.device.type, dtype=self.dtype)

    def forward(self, images):
        x = images.permute(0, 3, 1, 2)
        with self._autocast(x):
            x = F.relu(self.stem_bn(self.stem_conv(x)))
            x = F.max_pool2d(x, 3, stride=2, padding=1)
            for stage, b, *_ in self.plan:
                x = getattr(self, f"stage{stage}_block{b}")(x)
            score = self.score(x)
        return score.to(torch.float32)[None]
