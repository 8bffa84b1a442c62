"""Plain fp32 PyTorch models that decide ``correct``: the stacked hourglass
(Newell et al., arXiv:1603.06937) and the dilated ResNet of the DSNT paper
(Nibali et al., arXiv:1801.07372), with flax's BatchNorm, and the layers
that other backbones' modules build on.

A frozen copy of the math of the port's ``models/hourglass.py`` and
``models/resnet.py`` with the same submodule names, so one state dict loads
into both.  No autocast, no kernels, no tensor or data parallelism: every
conv runs in fp32, and :func:`strict_fp32` keeps TF32 off around the
reference's work.

The backbone is a lookup (:func:`backbone_of`): a configuration file's
``"reference": "<name>"`` names ``posebench/reference/<name>.py``, and a
file without the key gets this module.  A backbone module provides
``backbone(model)`` (the ``nn.Module`` under the port's key layout, whose
``forward(images, remat=False)`` returns ``(S, B, J, H, W)`` fp32 maps
and whose ``score_convs()`` lists each stack's score conv),
``heatmap_side(model)``, ``stacks(model)``, ``init_weights_(net,
generator)`` (every leaf that the conv and BN draws of
``inputs.make_weights`` leave) and ``scale_residual_(net, scale)``;
``model`` is the configuration's ``model`` group.

Two switches serve the harness and its controls, not the comparison:

- :class:`BatchNorm` in ``calibrate`` mode normalises with the batch's
  statistics and writes them (mean, biased variance) into the running
  statistics, so that eval mode later normalises like a trained model;
- :func:`quantized` makes the network compute in fp8 (the lower-precision
  control, run under bf16 autocast as the program runs).
"""

from __future__ import annotations

import contextlib
import importlib
import sys

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

BN_EPS = 1e-5
TRUNC_STD = 0.87962566103423978   # std of a unit normal truncated at +-2


class _Mode:
    """Process-wide, so that autograd's threads (which recompute a
    checkpointed forward on the card) see it too."""

    quant = False


_MODE = _Mode()


@contextlib.contextmanager
def strict_fp32():
    """TF32 off for matmuls and convs inside the block."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    old = (mm.allow_tf32, cudnn.allow_tf32)
    mm.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = old


@contextlib.contextmanager
def quantized():
    """Inside the block the network computes in fp8: every conv's and
    dense layer's operands and every matrix product's, and the output of
    every conv, dense layer, product, norm and residual block, rounded to e4m3
    in the forward pass and its gradient to e5m2 in the backward pass (one
    scale a tensor each), the sums still accumulated in wider types, as fp8
    training does."""
    old = _MODE.quant
    _MODE.quant = True
    try:
        yield
    finally:
        _MODE.quant = old


def fake_quant(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` at one scale (its largest magnitude onto
    the format's largest finite value), in ``t``'s dtype."""
    scale = t.abs().amax().float().clamp_min(1e-30) / torch.finfo(dtype).max
    return ((t.float() / scale).to(dtype).float() * scale).to(t.dtype)


class _Fp8Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return fake_quant(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return fake_quant(g, torch.float8_e5m2)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp8 under :func:`quantized`, else ``x``."""
    return _Fp8Round.apply(x) if _MODE.quant else x


class Conv2d(nn.Conv2d):
    def forward(self, x):
        if not _MODE.quant:
            return super().forward(x)
        return fp8(self._conv_forward(fp8(x), fp8(self.weight), self.bias))


class Linear(nn.Linear):
    def forward(self, x):
        if not _MODE.quant:
            return super().forward(x)
        return fp8(F.linear(fp8(x), fp8(self.weight), self.bias))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``, on fp8 operands and rounded to fp8 under :func:`quantized`."""
    if not _MODE.quant:
        return torch.matmul(a, b)
    return fp8(torch.matmul(fp8(a), fp8(b)))


@torch.no_grad()
def lecun_normal_(layers: list, gen: torch.Generator):
    """Every layer's kernel LeCun-normal (variance 1 / fan-in, the fan-in
    being a kernel's size over one output), truncated at 2 standard
    deviations, from one draw."""
    sizes = [m.weight.numel() for m in layers]
    stds = torch.tensor([(1.0 / m.weight[0].numel()) ** 0.5 / TRUNC_STD for m in layers],
                        device=layers[0].weight.device)
    flat = torch.empty(sum(sizes), device=stds.device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    flat.mul_(torch.repeat_interleave(stds, torch.tensor(sizes, device=stds.device)))
    for m, part in zip(layers, flat.split(sizes)):
        m.weight.copy_(part.view_as(m.weight))


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW, computed
    in fp32 and returned in the input's dtype.

    Train mode: batch mean and the fast variance ``E[x^2] - E[x]^2``
    clamped at 0, ``(x - mean) * (scale * rsqrt(var + eps)) + bias``.  The
    running statistics are not moved (nothing compares them), except in
    ``calibrate`` mode, which writes the batch's own into them.  Eval mode:
    the running statistics."""

    calibrate = False

    def __init__(self, ch: int):
        super().__init__(ch, eps=BN_EPS)

    def forward(self, x):
        if not self.training:
            return fp8(super().forward(x))
        xf = x.float()
        dims = (0, 2, 3)
        mean = xf.mean(dim=dims)
        var = ((xf * xf).mean(dim=dims) - mean * mean).clamp_min(0.0)
        if self.calibrate:
            with torch.no_grad():
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return fp8(y.to(x.dtype))


def checkpointed(module, x, remat: bool):
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(module, x, use_reentrant=False)
    return module(x)


class Bottleneck(nn.Module):
    """Pre-activation bottleneck: BN-ReLU-1x1 -> BN-ReLU-3x3 -> BN-ReLU-1x1,
    ``2 * planes`` out, a 1x1 projection of the first BN-ReLU where the
    width changes."""

    def __init__(self, in_ch: int, planes: int):
        super().__init__()
        out_ch = 2 * planes
        self.bn1 = BatchNorm(in_ch)
        self.conv1 = Conv2d(in_ch, planes, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn3 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, out_ch, 1, bias=False)
        self.proj = Conv2d(in_ch, out_ch, 1, bias=False) if in_ch != out_ch else None

    def forward(self, x):
        y = F.relu(self.bn1(x))
        residual = x if self.proj is None else self.proj(y)
        y = self.conv1(y)
        y = self.conv2(F.relu(self.bn2(y)))
        y = self.conv3(F.relu(self.bn3(y)))
        return fp8(y + residual)


class Hourglass(nn.Module):
    def __init__(self, depth: int, features: int):
        super().__init__()
        self.depth = depth
        planes = features // 2
        for d in range(depth, 0, -1):
            for name in ("up1", "low1", "low3"):
                self.add_module(f"{name}_d{d}", Bottleneck(features, planes))
        self.add_module("low2_d1", Bottleneck(features, planes))

    def _level(self, x, d: int):
        up1 = getattr(self, f"up1_d{d}")(x)
        low = getattr(self, f"low1_d{d}")(F.max_pool2d(x, 2, 2))
        low = self._level(low, d - 1) if d > 1 else self.low2_d1(low)
        low = getattr(self, f"low3_d{d}")(low)
        return fp8(up1 + F.interpolate(low, scale_factor=2, mode="nearest"))

    def forward(self, x):
        return self._level(x, self.depth)


class HourglassNet(nn.Module):
    """NHWC images -> ``(stacks, B, J, S/4, S/4)`` raw score maps."""

    def __init__(self, num_stacks: int, num_joints: int, features: int,
                 depth: int):
        super().__init__()
        self.num_stacks = num_stacks
        planes = features // 2
        self.stem_conv = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.stem_bn = BatchNorm(64)
        self.stem_res1 = Bottleneck(64, 64)
        self.stem_res2 = Bottleneck(128, planes)
        self.stem_res3 = Bottleneck(features, planes)
        for i in range(num_stacks):
            self.add_module(f"hg{i}", Hourglass(depth, features))
            self.add_module(f"post_res{i}", Bottleneck(features, planes))
            self.add_module(f"fc{i}_conv", Conv2d(features, features, 1, bias=False))
            self.add_module(f"fc{i}_bn", BatchNorm(features))
            self.add_module(f"score{i}", Conv2d(features, num_joints, 1))
            if i < num_stacks - 1:
                self.add_module(f"fc_back{i}", Conv2d(features, features, 1))
                self.add_module(f"score_back{i}", Conv2d(num_joints, features, 1))

    def score_convs(self) -> list:
        return [getattr(self, f"score{i}") for i in range(self.num_stacks)]

    def forward(self, images, remat: bool = False):
        x = images.permute(0, 3, 1, 2)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = self.stem_res1(x)
        x = F.max_pool2d(x, 2, 2)
        x = self.stem_res3(self.stem_res2(x))
        scores = []
        for i in range(self.num_stacks):
            y = checkpointed(getattr(self, f"hg{i}"), x, remat)
            y = getattr(self, f"post_res{i}")(y)
            y = F.relu(getattr(self, f"fc{i}_bn")(getattr(self, f"fc{i}_conv")(y)))
            score = getattr(self, f"score{i}")(y)
            scores.append(score)
            if i < self.num_stacks - 1:
                x = (x + getattr(self, f"fc_back{i}")(y)
                     + getattr(self, f"score_back{i}")(score))
        return torch.stack(scores, dim=0)


RESNET_SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
}


def _conv(cin, cout, k, stride=1, dilation=1):
    return Conv2d(cin, cout, k, stride=stride, dilation=dilation,
                  padding=dilation * (k // 2), bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch, planes, stride=1, dilation=1):
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
        return fp8(F.relu(x + y))


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_ch, planes, stride=1, dilation=1):
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
        return fp8(F.relu(x + y))


def stage_plan(arch: str, dilate: int = 0, truncate: int = 0) -> list:
    """``[(stage, block, planes, stride, dilation)]``: torchvision's
    ``replace_stride_with_dilation`` rule over the stages kept."""
    _, depths = RESNET_SPECS[arch]
    num_stages = len(depths) - truncate
    plan, dilation = [], 1
    for stage in range(num_stages):
        stride = 1 if stage == 0 else 2
        prev = dilation
        if stage >= num_stages - dilate and stride == 2:
            stride, dilation = 1, dilation * 2
        for b in range(depths[stage]):
            plan.append((stage, b, 64 * 2 ** stage, stride if b == 0 else 1,
                         prev if b == 0 else dilation))
    return plan


class ResNetPose(nn.Module):
    """NHWC images -> ``(1, B, J, H, W)`` raw score maps."""

    num_stacks = 1

    def __init__(self, arch: str, num_joints: int, dilate: int, truncate: int):
        super().__init__()
        kind, _ = RESNET_SPECS[arch]
        block = BasicBlock if kind == "basic" else BottleneckBlock
        self.stem_conv = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.stem_bn = BatchNorm(64)
        self.plan = stage_plan(arch, dilate, truncate)
        in_ch = 64
        for stage, b, planes, stride, dilation in self.plan:
            self.add_module(f"stage{stage}_block{b}",
                            block(in_ch, planes, stride, dilation))
            in_ch = planes * block.expansion
        self.score = Conv2d(in_ch, num_joints, 1)

    def score_convs(self) -> list:
        return [self.score]

    def forward(self, images, remat: bool = False):
        x = images.permute(0, 3, 1, 2)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage, b, *_ in self.plan:
            x = checkpointed(getattr(self, f"stage{stage}_block{b}"), x, remat)
        return self.score(x)[None]


def _family(model: dict) -> str:
    if model["base"].startswith("hg"):
        return "hg"
    if model["base"] in RESNET_SPECS:
        return "resnet"
    raise ValueError(f"the reference has no backbone {model['base']!r}")


def backbone(model: dict) -> nn.Module:
    """The hourglass (``hg<stacks>``) or the ResNet (``RESNET_SPECS``) of
    ``model``."""
    joints = model.get("num_joints", 16)
    if _family(model) == "hg":
        return HourglassNet(stacks(model), joints, model.get("hg_features", 256),
                            model.get("hg_depth", 4))
    return ResNetPose(model["base"], joints, model.get("dilate", 0), model.get("truncate", 0))


def stacks(model: dict) -> int:
    return int(model["base"][2:]) if _family(model) == "hg" else 1


def heatmap_side(model: dict) -> int:
    size = input_size(model)
    if _family(model) == "hg":
        return size // 4
    return size // (32 // 2 ** (model.get("dilate", 0) + model.get("truncate", 0)))


def init_weights_(net: nn.Module, generator: torch.Generator):
    """Nothing: the conv and BN draws cover every leaf of these backbones."""


@torch.no_grad()
def scale_residual_(net: nn.Module, scale: float):
    """Each residual branch's last layer scaled by ``scale``: the hourglass
    bottleneck's last conv, the ResNet block's last BN scale (torchvision's
    ``zero_init_residual`` at ``scale`` 0)."""
    for m in net.modules():
        if isinstance(m, Bottleneck):
            m.conv3.weight.mul_(scale)
        elif isinstance(m, BottleneckBlock):
            m.bn3.weight.fill_(scale)
        elif isinstance(m, BasicBlock):
            m.bn2.weight.fill_(scale)


def backbone_of(cfg: dict):
    """The backbone module of the run configuration ``cfg``:
    ``posebench/reference/<cfg["reference"]>.py``, or this module where
    ``cfg`` names none."""
    name = cfg.get("reference")
    if name is None:
        return sys.modules[__name__]
    return importlib.import_module(f"{__package__}.{name}")


class PoseNet(nn.Module):
    """The backbone of a run configuration under the port's key layout
    (``backbone.<name>``)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.backbone = backbone_of(cfg).backbone(cfg["model"])

    def forward(self, images, remat: bool = False):
        return self.backbone(images, remat=remat)


def input_size(model: dict) -> int:
    if model.get("input_size"):
        return model["input_size"]
    return 256 if model["base"].startswith("hg") else 224


@contextlib.contextmanager
def calibrating(net: nn.Module):
    """BatchNorms write their batch statistics into the running ones."""
    bns = [m for m in net.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.calibrate = True
    try:
        yield
    finally:
        for m in bns:
            m.calibrate = False
