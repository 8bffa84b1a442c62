"""Plain fp32 PyTorch reference of HRNet-W48 as a pose backbone (Sun et al.,
"Deep High-Resolution Representation Learning for Human Pose Estimation",
CVPR 2019, arXiv:1902.09212; ``pose_hrnet.py`` and
``experiments/mpii/hrnet/w48_256x256_adam_lr1e-3.yaml`` of the authors'
``leoxiaobin/deep-high-resolution-net.pytorch``), the backbone module that a
configuration file names with ``"reference": "hrnet"``.

The network: a stem of two 3x3 stride-2 convs 3 -> 64 -> 64 (BN, ReLU
each); stage 1, four post-activation bottlenecks of 64 planes (256 out);
stages 2, 3 and 4 of 1, 4 and 3 :class:`HighResolutionModule` s with 2, 3
and 4 branches of widths 48, 96, 192 and 384 at 1/4, 1/8, 1/16 and 1/32 of
the input, each branch four BasicBlocks.  Into stage 2 a 3x3 conv 256 -> 48
and a 3x3 stride-2 conv 256 -> 96; into stages 3 and 4 a 3x3 stride-2 conv
from the last branch, 96 -> 192 and 192 -> 384 (BN, ReLU each).  A module's
exchange unit makes output ``i`` as ``ReLU(sum_j f_ij(x_j))``, summed
from ``j = 0`` up: ``f_ii`` the identity; ``f_ij`` for ``j > i`` a 1x1 conv
+ BN, then a nearest upsample by ``2^(j-i)``; for ``j < i`` ``i - j`` 3x3
stride-2 convs, the first ``i - j - 1`` at ``x_j``'s width with BN + ReLU,
the last to ``x_i``'s width with BN alone.  The last module of stage 4 gives
output 0 only, which a 1x1 conv with a bias scores into the 16 joints' maps
at a quarter of the input.

Departures from the source, as the port has them: flax's BatchNorm
(:class:`.model.BatchNorm`) for ``nn.BatchNorm2d``; the stage-1 bottleneck's
projection is named ``proj`` / ``bn_proj`` (the ResNet's), not
``downsample``; the final layer is named ``score``.  The submodules take
the port's names (``models/hrnet.py``), so one state dict loads into both.
Every layer runs in fp32 (TF32 off under :func:`.model.strict_fp32`),
built from :mod:`.model`'s ``Conv2d``, ``BatchNorm``, ``BasicBlock`` and
``BottleneckBlock``, which the fp8 control reaches; an exchange unit's
output is rounded to fp8 under it, as a residual block's is.

A model group whose base is not an HRNet's goes to :mod:`.model` (the
harness's CPU tests shrink every cell that is not an hourglass to a
ResNet-18 in place).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from . import model as M

# The published plan: branch widths, BasicBlocks a branch, modules in stages
# 2-4, bottlenecks in stage 1.
SPECS = {
    "hrnet_w48": {"widths": (48, 96, 192, 384), "blocks": 4, "modules": (1, 4, 3),
                  "stage1_blocks": 4},
}
STEM = 64


class ConvBN(nn.Module):
    """A conv (no bias, padding ``k // 2``), its BN, then a ReLU when
    ``relu``."""

    def __init__(self, cin, cout, k, stride=1, relu=False):
        super().__init__()
        self.conv = M.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)
        self.bn = M.BatchNorm(cout)
        self.relu = relu

    def forward(self, x):
        y = self.bn(self.conv(x))
        return F.relu(y) if self.relu else y


def fuse_term(widths, i, j):
    """``f_ij`` less the upsample of ``j > i``."""
    if j > i:
        return nn.Sequential(ConvBN(widths[j], widths[i], 1))
    last = i - j - 1
    return nn.Sequential(*(ConvBN(widths[j], widths[i] if k == last else widths[j], 3,
                                  stride=2, relu=k != last) for k in range(i - j)))


class HighResolutionModule(nn.Module):
    def __init__(self, widths, blocks, multi_scale=True):
        super().__init__()
        self.branches, self.blocks = len(widths), blocks
        self.outputs = self.branches if multi_scale else 1
        for b, w in enumerate(widths):
            for k in range(blocks):
                self.add_module(f"branch{b}_block{k}", M.BasicBlock(w, w))
        for i in range(self.outputs):
            for j in range(self.branches):
                if j != i:
                    self.add_module(f"fuse{i}_{j}", fuse_term(widths, i, j))

    def forward(self, xs):
        xs = list(xs)
        for b in range(self.branches):
            for k in range(self.blocks):
                xs[b] = getattr(self, f"branch{b}_block{k}")(xs[b])
        out = []
        for i in range(self.outputs):
            y = None
            for j in range(self.branches):
                if j == i:
                    t = xs[j]
                else:
                    t = getattr(self, f"fuse{i}_{j}")(xs[j])
                    if j > i:
                        t = F.interpolate(t, scale_factor=2 ** (j - i), mode="nearest")
                y = t if y is None else y + t
            out.append(M.fp8(F.relu(y)))
        return out


class HRNetPose(nn.Module):
    """NHWC images -> ``(1, B, J, S/4, S/4)`` raw score maps."""

    num_stacks = 1

    def __init__(self, num_joints, widths, blocks, modules, stage1_blocks):
        super().__init__()
        self.stem_conv1 = M.Conv2d(3, STEM, 3, stride=2, padding=1, bias=False)
        self.stem_bn1 = M.BatchNorm(STEM)
        self.stem_conv2 = M.Conv2d(STEM, STEM, 3, stride=2, padding=1, bias=False)
        self.stem_bn2 = M.BatchNorm(STEM)
        self.stage1_blocks = stage1_blocks
        in_ch = STEM
        for k in range(stage1_blocks):
            self.add_module(f"stage1_block{k}", M.BottleneckBlock(in_ch, STEM))
            in_ch = STEM * M.BottleneckBlock.expansion
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
        self.score = M.Conv2d(widths[0], num_joints, 1)

    def score_convs(self) -> list:
        return [self.score]

    def forward(self, images, remat: bool = False):
        x = images.permute(0, 3, 1, 2)
        x = F.relu(self.stem_bn1(self.stem_conv1(x)))
        x = F.relu(self.stem_bn2(self.stem_conv2(x)))
        for k in range(self.stage1_blocks):
            x = M.checkpointed(getattr(self, f"stage1_block{k}"), x, remat)
        xs = [self.transition2_0(x), self.transition2_1(x)]
        for s, count in enumerate(self.modules_per_stage, start=2):
            if s > 2:
                xs.append(getattr(self, f"transition{s}_{s - 1}")(xs[-1]))
            for m in range(count):
                xs = M.checkpointed(getattr(self, f"stage{s}_module{m}"), xs, remat)
        return self.score(xs[0])[None]


def _ours(model: dict) -> bool:
    return model["base"] in SPECS


def backbone(model: dict) -> nn.Module:
    if not _ours(model):
        return M.backbone(model)
    return HRNetPose(model.get("num_joints", 16), **SPECS[model["base"]])


def stacks(model: dict) -> int:
    return 1 if _ours(model) else M.stacks(model)


def heatmap_side(model: dict) -> int:
    """A quarter of the input: the stem's two stride-2 convs."""
    return M.input_size(model) // 4 if _ours(model) else M.heatmap_side(model)


# The conv and BN draws of ``inputs.make_weights`` cover every leaf, and each
# residual branch's last BN scale is set as the ResNet's: the BasicBlock's
# ``bn2``, the stage-1 bottleneck's ``bn3``.
init_weights_ = M.init_weights_
scale_residual_ = M.scale_residual_
