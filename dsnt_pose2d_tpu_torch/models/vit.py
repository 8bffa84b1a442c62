"""ViT backbone for DSNT pose estimation as ``nn.Module``s (port of
``dsnt_pose2d_tpu/models/vit.py``, BASELINE config #5's ViT-S/16).

A 16-px patch conv, learned row + column position embeddings, ``depth``
pre-norm transformer blocks, then the tokens back on their grid, a 1x1
projection, a 2x nearest upsample, a 3x3 refine conv and a 1x1 score conv:
heatmaps at stride 8 (56x56 at 448 px).  The submodules take the flax
names (``patch_embed``, ``pos_row``, ``pos_col``, ``block{i}.ln1/qkv/proj/
ln2/fc1/fc2``, ``ln_out``, ``up_proj``, ``refine``, ``score``), so flax
variables map one to one (:mod:`.from_jax`).  Inputs are NHWC.

The dtypes follow flax's: every conv and dense runs in the compute dtype
(``dtype``: bf16 on the card) with its fp32 parameters cast to it, the
residual stream is in the compute dtype, and the LayerNorms compute in
fp32 (flax's ``_compute_stats``/``_normalize``: the fast variance
``E[x^2] - E[x]^2`` clamped at 0, epsilon 1e-6).  Attention is the XLA
core of ``jax.nn.dot_product_attention``: fp32 logits of the upcast q and
k (TF32 off), scaled by ``1/sqrt(head_dim)``, an fp32 softmax, the
probabilities cast to the compute dtype and multiplied by v.  The output is
the score cast to fp32 whatever the dtype.  An fp64 model (``dtype=
torch.float64`` and ``.double()``) keeps fp64 in its LayerNorms and softmax
(at least fp32, as the hourglass's BN statistics), where the JAX package
pins them to fp32.

``remat=True`` recomputes each block's activations in the backward pass
(:func:`.hourglass.remat`) in training with grad enabled.  The convs and
denses are column-parallel over the mesh's model axis once
:func:`..parallel.tp.shard_model_` has sharded their kernels; the patch
conv then adds this rank's share of the position embeddings before its
features are gathered.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import strict_fp32
from ..parallel import tp
from .hourglass import remat as _remat

_LN_EPS = 1e-6      # flax's LayerNorm default (torch's is 1e-5)


def _at_least_fp32(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _gelu(x):
    """flax's ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)`` over the last axis: statistics
    and the output in at least fp32, whatever the input's dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        xf = x.to(_at_least_fp32(x.dtype))
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + _LN_EPS) * self.weight
        return (xf - mean) * mul + self.bias


class Dense(nn.Linear):
    """flax ``Dense(dtype=x.dtype)``: the parameters cast to the input's
    dtype (:func:`..parallel.tp.linear`)."""

    def forward(self, x):
        return tp.linear(self, x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class Conv(nn.Conv2d):
    """flax ``Conv(dtype=x.dtype)`` over NCHW: the parameters cast to the
    input's dtype (:func:`..parallel.tp.conv2d`)."""

    def forward(self, x):
        return tp.conv2d(self, x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def attention(q, k, v):
    """``jax.nn.dot_product_attention``'s XLA core over ``(B, N, H, hd)``
    q, k, v: logits in at least fp32 from the upcast q and k, the fp32
    softmax, the probabilities in v's dtype times v."""
    acc = _at_least_fp32(q.dtype)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # (B, H, N, hd)
    with strict_fp32():
        logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2))
    logits = logits * (1.0 / math.sqrt(q.shape[-1]))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v).transpose(1, 2)          # (B, N, H, hd)


class ViTBlock(nn.Module):
    """Pre-norm transformer block over ``(B, N, D)`` in the residual
    stream's dtype."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.ln1 = LayerNorm(dim)
        self.qkv = Dense(dim, 3 * dim)
        # flax's (D, 3, H, hd) DenseGeneral: its output features, for the
        # tensor-parallel layout (parallel.tp.leaf_layouts).
        self.qkv.flax_features = (3, num_heads, dim // num_heads)
        self.proj = Dense(dim, dim)
        self.ln2 = LayerNorm(dim)
        self.fc1 = Dense(dim, mlp_ratio * dim)
        self.fc2 = Dense(mlp_ratio * dim, dim)

    def forward(self, x):
        b, n, d = x.shape
        h = self.ln1(x).to(x.dtype)
        qkv = self.qkv(h).view(b, n, 3, self.num_heads, d // self.num_heads)
        attn = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        x = x + self.proj(attn.reshape(b, n, d))
        h = self.ln2(x).to(x.dtype)
        h = self.fc2(_gelu(self.fc1(h)))
        return x + h


class ViTPose(nn.Module):
    """ViT encoder + heatmap head: NHWC images -> ``(1, B, J, S/8, S/8)``
    raw maps in fp32."""

    def __init__(self, num_joints: int = 16, patch: int = 16, dim: int = 384,
                 depth: int = 12, num_heads: int = 6, input_size: int = 448,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.patch = patch
        self.dim = dim
        self.depth = depth
        self.dtype = dtype
        self.remat = remat
        # The position embeddings are per grid row and column, so the input
        # side is fixed when the module is made (flax shapes them at init).
        g = self.grid(input_size)
        # 16x16 stride-16 'SAME': no padding at sides divisible by 16.
        self.patch_embed = Conv(3, dim, patch, stride=patch)
        self.pos_row = nn.Parameter(torch.zeros(g, dim))
        self.pos_col = nn.Parameter(torch.zeros(g, dim))
        for i in range(depth):
            self.add_module(f"block{i}", ViTBlock(dim, num_heads))
        self.ln_out = LayerNorm(dim)
        self.up_proj = Conv(dim, dim // 2, 1)
        self.refine = Conv(dim // 2, dim // 2, 3, padding=1)
        self.score = Conv(dim // 2, num_joints, 1)

    def grid(self, side: int) -> int:
        """Patches along a side of ``side`` px; raises ``ValueError`` where
        the patch does not divide it, as the JAX package does."""
        if side % self.patch:
            raise ValueError(f"input {side} not divisible by patch {self.patch}")
        return side // self.patch

    def output_side(self, side: int) -> int:
        """Side of the score maps for a square input of ``side`` px: the
        patch grid upsampled 2x (``side // 8`` for 16-px patches)."""
        return 2 * self.grid(side)

    def forward(self, images):
        b, size = images.shape[:2]
        g = self.grid(size)
        if g != self.pos_row.shape[0]:
            raise ValueError(f"input {size} gives a {g}-patch grid, the position "
                             f"embeddings are for {self.pos_row.shape[0]}")
        dt = self.dtype
        x = images.permute(0, 3, 1, 2).to(dt)
        pos = (self.pos_row[:, None, :] + self.pos_col[None, :, :]).to(dt)
        pe = self.patch_embed
        if tp.shard_of(pe.weight) is None:
            x = pe(x).permute(0, 2, 3, 1) + pos                # (B, g, g, D)
        else:
            # Column-parallel (the position embeddings are sharded on D with
            # the patch kernel): this rank's features plus its share of the
            # embeddings, gathered, then the whole bias.
            x = pe._conv_forward(tp.copy_to_model(x), pe.weight.to(dt), None)
            x = tp.gather_features(x.permute(0, 2, 3, 1) + pos, -1)
            x = x + pe.bias.to(dt)
        x = x.reshape(b, g * g, self.dim)
        checkpointed = self.remat and self.training and torch.is_grad_enabled()
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            x = _remat(block, x) if checkpointed else block(x)
        x = self.ln_out(x).reshape(b, g, g, self.dim).to(dt)
        x = self.up_proj(x.permute(0, 3, 1, 2))
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        score = self.score(_gelu(self.refine(x)))
        return score.to(torch.float32)[None]
