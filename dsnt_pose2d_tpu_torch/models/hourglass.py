"""Stacked-hourglass backbone (Newell et al., arXiv:1603.06937) as ``nn.Module``s.

Port of ``dsnt_pose2d_tpu/models/hourglass.py``: the same topology and the
same submodule names as the flax modules (``stem_conv``, ``hg0.up1_d4``,
``post_res0``, ...), so flax variables map onto the state dict one to one
(:mod:`.from_jax`).  Inputs are NHWC like the JAX package's; the convs run
NCHW inside.  With ``dtype=torch.bfloat16`` (or fp16) the convs run under
autocast while parameters and BN statistics stay fp32, as flax does; any
other dtype runs as it is (``HourglassNet(dtype=torch.float64).double()``
is the fp64 model of the parity tests).  :class:`BatchNorm` follows the
module's ``training`` flag, as flax's ``train`` argument.  With
``remat=True`` each hourglass stack runs under :func:`remat` in training,
as the JAX package's ``nn.remat(Hourglass)``.  The convs are
:class:`Conv2d`: column-parallel over the mesh's model axis once
:func:`..parallel.tp.shard_model_` has sharded their kernels.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..parallel import tp
from ..parallel.mesh import DATA_AXIS, all_reduce_sum, axis_size
from ..utils.spans import span

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.9     # flax's convention: the weight of the old statistic
_AUTOCAST_DTYPES = (torch.bfloat16, torch.float16)

# Set in the thread that recomputes a :func:`remat` scope's forward in the
# backward pass (autograd's device threads do that on the card).
_RECOMPUTE = threading.local()


@contextlib.contextmanager
def _recomputing():
    before = getattr(_RECOMPUTE, "on", False)
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = before


def _remat_contexts():
    return contextlib.nullcontext(), _recomputing()


def remat(module: nn.Module, *args):
    """``module(*args)`` with its activations recomputed in the backward
    pass instead of kept (flax's ``nn.remat``): non-reentrant
    ``torch.utils.checkpoint``, which restores the forward's autocast
    state in the recompute.  :class:`BatchNorm` moves its running
    statistics in the forward only, not again in the recompute, so they
    move once a step as flax's do.  Nothing in the scopes draws random
    numbers, so the RNG state is not stashed."""
    return torch.utils.checkpoint.checkpoint(
        module, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=_remat_contexts)


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW.

    Eval mode normalizes with the running statistics (stock
    ``BatchNorm2d``).  Train mode reproduces flax's ``_compute_stats`` and
    ``_normalize``: batch statistics in at least fp32 whatever the input
    dtype, the fast variance ``E[x^2] - E[x]^2`` clamped at 0,
    ``(x - mean) * (scale * rsqrt(var + eps)) + bias`` in that precision,
    cast back to the input's dtype; the running statistics move by
    ``r <- 0.9 r + 0.1 stat`` with the BIASED batch variance, where stock
    ``BatchNorm2d`` takes the unbiased one.  ``num_batches_tracked`` is not
    advanced (flax has no such counter).  When a :func:`remat` scope
    recomputes the forward in the backward pass, the running statistics do
    not move again.

    Over a data axis of D > 1 ranks the batch statistics are those of
    the global batch (the JAX package's BN under a ``data`` mesh): the
    per-channel sums of x and x^2 are summed over the data group by a
    differentiable all-reduce, whose backward sums the gradient there
    again.  The ranks of a model group hold the same whole activations and
    take no part in it.  A remat recompute issues the all-reduce again, in
    the same order on every rank.

    Each call, in either mode, is one ``bn`` span while a profiler records
    (:mod:`..utils.spans`).
    """

    def __init__(self, ch: int):
        super().__init__(ch, eps=_BN_EPS, momentum=1.0 - _BN_MOMENTUM)

    def forward(self, x):
        with span("bn"):
            if not self.training:
                return super().forward(x)
            return self._train_forward(x)

    def _train_forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = (0, 2, 3)
        ranks = axis_size(DATA_AXIS)
        if ranks > 1:
            # Global-batch statistics: one differentiable all-reduce of the
            # per-channel [sum x, sum x^2]; every data rank holds a batch of
            # the same shape, so the global count is the local one times D.
            n = xf.numel() // xf.shape[1] * ranks
            sums = all_reduce_sum(torch.cat([xf.sum(dim=dims),
                                             (xf * xf).sum(dim=dims)]),
                                  DATA_AXIS)
            mean, mean2 = (sums / n).chunk(2)
        else:
            mean = xf.mean(dim=dims)
            mean2 = (xf * xf).mean(dim=dims)
        var = (mean2 - mean * mean).clamp_min(0.0)
        if not getattr(_RECOMPUTE, "on", False):
            self._update_running(mean.detach(), var.detach())
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = ((xf - mean[:, None, None]) * mul[:, None, None]
             + self.bias[:, None, None])
        return y.to(x.dtype)

    @torch.no_grad()
    def _update_running(self, mean, var):
        m = _BN_MOMENTUM
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d``, column-parallel when its kernel is sharded
    (:func:`..parallel.tp.conv2d`)."""

    def forward(self, x):
        return tp.conv2d(self, x, self.weight, self.bias)


def _bn(ch: int) -> BatchNorm:
    return BatchNorm(ch)


class Bottleneck(nn.Module):
    """Pre-activation bottleneck: BN-ReLU-1x1 -> BN-ReLU-3x3 -> BN-ReLU-1x1.

    Output channels are ``2 * planes``; when the input width differs, the
    skip is a 1x1 projection of the first BN-ReLU's output.
    """

    def __init__(self, in_ch: int, planes: int):
        super().__init__()
        out_ch = 2 * planes
        self.bn1 = _bn(in_ch)
        self.conv1 = Conv2d(in_ch, planes, 1, bias=False)
        self.bn2 = _bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn3 = _bn(planes)
        self.conv3 = Conv2d(planes, out_ch, 1, bias=False)
        self.proj = (Conv2d(in_ch, out_ch, 1, bias=False)
                     if in_ch != out_ch else None)

    def forward(self, x):
        y = F.relu(self.bn1(x))
        residual = x if self.proj is None else self.proj(y)
        y = self.conv1(y)
        y = self.conv2(F.relu(self.bn2(y)))
        y = self.conv3(F.relu(self.bn3(y)))
        return y + residual


class Hourglass(nn.Module):
    """One recursive hourglass of ``depth`` levels over ``features`` channels."""

    def __init__(self, depth: int = 4, features: int = 256):
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
        return up1 + F.interpolate(low, scale_factor=2, mode="nearest")

    def forward(self, x):
        return self._level(x, self.depth)


class HourglassNet(nn.Module):
    """Stacked hourglass producing per-stack raw score maps.

    Input ``(B, S_in, S_in, 3)`` NHWC normalized images; output raw heatmaps
    ``(num_stacks, B, J, S_in / 4, S_in / 4)`` in
    ``promote_types(dtype, float32)``, as flax: fp32 for a bf16 backbone,
    fp64 for an fp64 one.
    """

    def __init__(self, num_stacks: int = 8, num_joints: int = 16,
                 features: int = 256, depth: int = 4,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.num_stacks = num_stacks
        self.dtype = dtype
        self.remat = remat
        planes = features // 2
        # Symmetric (3, 3) stem padding: the torch/Newell convention the JAX
        # package pins explicitly (MODEL_VERSION 2).
        self.stem_conv = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.stem_bn = _bn(64)
        self.stem_res1 = Bottleneck(64, 64)
        self.stem_res2 = Bottleneck(128, planes)
        self.stem_res3 = Bottleneck(features, planes)
        for i in range(num_stacks):
            self.add_module(f"hg{i}", Hourglass(depth, features))
            self.add_module(f"post_res{i}", Bottleneck(features, planes))
            self.add_module(f"fc{i}_conv", Conv2d(features, features, 1,
                                                   bias=False))
            self.add_module(f"fc{i}_bn", _bn(features))
            self.add_module(f"score{i}", Conv2d(features, num_joints, 1))
            if i < num_stacks - 1:
                self.add_module(f"fc_back{i}", Conv2d(features, features, 1))
                self.add_module(f"score_back{i}",
                                Conv2d(num_joints, features, 1))

    def output_side(self, side: int) -> int:
        """Side of the score maps for a square input of ``side`` px (the
        stride-2 stem conv, then a 2x2 max-pool)."""
        return -(-side // 2) // 2

    def _autocast(self, x):
        if self.dtype not in _AUTOCAST_DTYPES:
            return contextlib.nullcontext()
        return torch.autocast(x.device.type, dtype=self.dtype)

    def forward(self, images):
        x = images.permute(0, 3, 1, 2)
        with self._autocast(x):
            x = F.relu(self.stem_bn(self.stem_conv(x)))
            x = self.stem_res1(x)
            x = F.max_pool2d(x, 2, 2)
            x = self.stem_res3(self.stem_res2(x))
            scores = []
            checkpointed = self.remat and self.training and torch.is_grad_enabled()
            for i in range(self.num_stacks):
                hg = getattr(self, f"hg{i}")
                y = remat(hg, x) if checkpointed else hg(x)
                y = getattr(self, f"post_res{i}")(y)
                y = F.relu(getattr(self, f"fc{i}_bn")(
                    getattr(self, f"fc{i}_conv")(y)))
                score = getattr(self, f"score{i}")(y)
                scores.append(score)
                if i < self.num_stacks - 1:
                    x = (x + getattr(self, f"fc_back{i}")(y)
                         + getattr(self, f"score_back{i}")(score))
        out_dtype = torch.promote_types(self.dtype, torch.float32)
        return torch.stack(scores, dim=0).to(out_dtype)
