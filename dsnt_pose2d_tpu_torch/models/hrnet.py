"""HRNet pose backbone (Sun et al., "Deep High-Resolution Representation
Learning for Human Pose Estimation", CVPR 2019, arXiv:1902.09212) as
``nn.Module``s.

The network of the authors' ``pose_hrnet.py``: a stem of two 3x3 stride-2
convs (BN + ReLU each), stage 1 of post-activation bottlenecks, then
stages of :class:`HighResolutionModule` s whose parallel branches run at
1/4, 1/8, 1/16 and 1/32 of the input.  A transition into each stage adds
one branch, a 3x3 stride-2 conv (BN + ReLU) of the last branch; into stage
2 a 3x3 conv (BN + ReLU) also narrows stage 1's output to the first
branch's width.  A module runs each branch's :class:`.resnet.BasicBlock` s,
then its exchange unit: output ``i`` is ``ReLU(sum_j f_ij(x_j))``, with
``f_ii`` the identity, ``f_ij`` for ``j > i`` a 1x1 conv + BN then a
nearest upsample by ``2^(j-i)``, and for ``j < i`` a chain of ``i - j``
3x3 stride-2 convs, the first ``i - j - 1`` at ``x_j``'s width with BN +
ReLU, the last to output ``i``'s width with BN alone.  The last module
gives output 0 only, which a 1x1 conv with a bias scores.

The blocks are the ResNet's (:class:`.resnet.BasicBlock`,
:class:`.resnet.BottleneckBlock`), the BN is :class:`.hourglass.BatchNorm`
with the ReLU that follows it folded in, and the bf16 convention is the
ResNet's: convs under autocast, fp32 parameters and BN statistics, the
score cast to fp32.  ``cfg.remat`` does not reach it, as it does not reach
a ResNet.  Each exchange unit is one ``fuse`` span while a profiler
records (:mod:`..utils.spans`).

Submodule names: ``stem_conv1``, ``stem_bn1``, ``stem_conv2``,
``stem_bn2``, ``stage1_block{k}``, ``transition{s}_{b}`` (the conv and BN
that make branch ``b`` of stage ``s``), ``stage{s}_module{m}`` with its
``branch{b}_block{k}`` and ``fuse{i}_{j}.{k}`` (the ``k``-th conv and BN of
``f_ij``), and ``score``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.spans import span
from .hourglass import _AUTOCAST_DTYPES, BatchNorm, Conv2d
from .resnet import BasicBlock, BottleneckBlock

# The published HRNet-W48 (experiments/mpii/hrnet/w48_256x256_adam_lr1e-3.yaml):
# branch widths, BasicBlocks a branch, modules in stages 2-4; stage 1 is four
# bottlenecks of 64 planes.
HRNET_SPECS = {
    "hrnet_w48": {"widths": (48, 96, 192, 384), "blocks": 4, "modules": (1, 4, 3),
                  "stage1_blocks": 4},
}
STEM_WIDTH = 64


class ConvBN(nn.Module):
    """A conv (no bias, padding ``k // 2``) and its BN, with the ReLU after
    it folded into the BN when ``relu``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 relu: bool = False):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)
        self.bn = BatchNorm(cout, relu=relu)

    def forward(self, x):
        return self.bn(self.conv(x))


def fuse_term(widths, i: int, j: int) -> nn.Sequential:
    """``f_ij`` of the exchange unit, less the upsample of ``j > i``."""
    if j > i:
        return nn.Sequential(ConvBN(widths[j], widths[i], 1))
    last = i - j - 1
    return nn.Sequential(*(
        ConvBN(widths[j], widths[i] if k == last else widths[j], 3, stride=2,
               relu=k != last)
        for k in range(i - j)))


class HighResolutionModule(nn.Module):
    """``len(widths)`` parallel branches of ``blocks`` BasicBlocks each, then
    the exchange unit (outputs ``0 .. len(widths) - 1``, or output 0 alone
    where not ``multi_scale``)."""

    def __init__(self, widths, blocks: int, multi_scale: bool = True):
        super().__init__()
        self.branches = len(widths)
        self.outputs = self.branches if multi_scale else 1
        for b, w in enumerate(widths):
            for k in range(blocks):
                self.add_module(f"branch{b}_block{k}", BasicBlock(w, w))
        self.blocks = blocks
        for i in range(self.outputs):
            for j in range(self.branches):
                if j != i:
                    self.add_module(f"fuse{i}_{j}", fuse_term(widths, i, j))

    def _term(self, xs, i: int, j: int):
        if j == i:
            return xs[j]
        y = getattr(self, f"fuse{i}_{j}")(xs[j])
        if j > i:
            y = F.interpolate(y, scale_factor=2 ** (j - i), mode="nearest")
        return y

    def forward(self, xs: list) -> list:
        xs = list(xs)
        for b in range(self.branches):
            for k in range(self.blocks):
                xs[b] = getattr(self, f"branch{b}_block{k}")(xs[b])
        with span("fuse"):
            out = []
            for i in range(self.outputs):
                y = self._term(xs, i, 0)
                for j in range(1, self.branches):
                    y = y + self._term(xs, i, j)
                out.append(F.relu(y))
        return out


class HRNetPose(nn.Module):
    """HRNet + 1x1 score conv: NHWC images -> ``(1, B, J, S/4, S/4)`` raw
    maps in fp32 (one "stack", as a ResNet).

    ``widths`` are the branch widths, ``blocks`` the BasicBlocks a branch
    and ``modules`` the modules of stages 2, 3, ... (stage ``s`` has ``s``
    branches); :data:`HRNET_SPECS` holds the published plan.
    """

    def __init__(self, num_joints: int, widths, blocks: int, modules,
                 stage1_blocks: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        if len(widths) != len(modules) + 1:
            raise ValueError(f"{len(widths)} branch widths for {len(modules)} stages")
        self.dtype = dtype
        self.stem_conv1 = Conv2d(3, STEM_WIDTH, 3, stride=2, padding=1, bias=False)
        self.stem_bn1 = BatchNorm(STEM_WIDTH, relu=True)
        self.stem_conv2 = Conv2d(STEM_WIDTH, STEM_WIDTH, 3, stride=2, padding=1, bias=False)
        self.stem_bn2 = BatchNorm(STEM_WIDTH, relu=True)
        self.stage1_blocks = stage1_blocks
        in_ch = STEM_WIDTH
        for k in range(stage1_blocks):
            self.add_module(f"stage1_block{k}", BottleneckBlock(in_ch, STEM_WIDTH))
            in_ch = STEM_WIDTH * BottleneckBlock.expansion
        self.transition2_0 = ConvBN(in_ch, widths[0], 3, relu=True)
        self.modules_per_stage = tuple(modules)
        for s, count in enumerate(modules, start=2):
            prev = in_ch if s == 2 else widths[s - 2]
            self.add_module(f"transition{s}_{s - 1}",
                            ConvBN(prev, widths[s - 1], 3, stride=2, relu=True))
            for m in range(count):
                last = s == len(widths) and m == count - 1
                self.add_module(f"stage{s}_module{m}",
                                HighResolutionModule(widths[:s], blocks, not last))
        self.score = Conv2d(widths[0], num_joints, 1)

    def output_side(self, side: int) -> int:
        """Side of the score maps for a square input of ``side`` px: the
        two stride-2 stem convs give ``ceil(side / 2)`` each."""
        for _ in range(2):
            side = -(-side // 2)
        return side

    def _autocast(self, x):
        if self.dtype not in _AUTOCAST_DTYPES:
            return contextlib.nullcontext()
        return torch.autocast(x.device.type, dtype=self.dtype)

    def forward(self, images):
        x = images.permute(0, 3, 1, 2)
        with self._autocast(x):
            x = self.stem_bn1(self.stem_conv1(x))
            x = self.stem_bn2(self.stem_conv2(x))
            for k in range(self.stage1_blocks):
                x = getattr(self, f"stage1_block{k}")(x)
            xs = [self.transition2_0(x), self.transition2_1(x)]
            for s, count in enumerate(self.modules_per_stage, start=2):
                if s > 2:
                    # The new branch comes from the last module's last output.
                    xs.append(getattr(self, f"transition{s}_{s - 1}")(xs[-1]))
                for m in range(count):
                    xs = getattr(self, f"stage{s}_module{m}")(xs)
            score = self.score(xs[0])
        return score.to(torch.float32)[None]
