"""Plain fp32 PyTorch reference of the port's ViT family (``vit_t16``,
``vit_s16``, ``vit_b16``: Dosovitskiy et al., arXiv:2010.11929, as a DSNT
pose backbone), the backbone module that a configuration file names with
``"reference": "vit"``.

The math of the port's ``models/vit.py``: a 16-px patch conv, learned row
and column position embeddings added to each patch's features, ``depth``
pre-norm blocks (flax's LayerNorm: statistics in fp32, the fast variance
``E[x^2] - E[x]^2`` clamped at 0, epsilon 1e-6; attention with fp32 logits
scaled by ``1/sqrt(head_dim)`` and an fp32 softmax; an MLP of 4x the width
with the tanh GELU), then ``ln_out``, the tokens back on their grid, a 1x1
``up_proj`` to half the width, a 2x nearest upsample, a 3x3 ``refine``
conv, the GELU and a 1x1 ``score`` conv: maps at stride 8.  The submodules
take the port's names, so one state dict loads into both.  Every layer
runs in fp32 (TF32 off under :func:`.model.strict_fp32`); the dense layers
and products are :class:`.model.Linear` and :func:`.model.matmul`, which
the fp8 control reaches.  A later backbone of this family imports these
layers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import model as M

# (width, depth, heads) of each base; 16-px patches.
SPECS = {
    "vit_t16": (192, 4, 3),
    "vit_s16": (384, 12, 6),
    "vit_b16": (768, 12, 12),
}
PATCH = 16
LN_EPS = 1e-6      # flax's LayerNorm default
POS_STD = 0.02


def gelu(x):
    """flax's ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis, computed and returned in
    fp32."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + LN_EPS) * self.weight
        return M.fp8((xf - mean) * mul + self.bias)


def attention(q, k, v):
    """Softmax attention over ``(B, N, H, hd)`` q, k, v: fp32 logits scaled
    by ``1/sqrt(hd)``, an fp32 softmax, the probabilities times v."""
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # (B, H, N, hd)
    logits = M.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    probs = torch.softmax(logits.float(), dim=-1)
    return M.matmul(probs, v).transpose(1, 2)              # (B, N, H, hd)


class Block(nn.Module):
    """Pre-norm transformer block over ``(B, N, D)``."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.heads = heads
        self.ln1 = LayerNorm(dim)
        self.qkv = M.Linear(dim, 3 * dim)
        self.proj = M.Linear(dim, dim)
        self.ln2 = LayerNorm(dim)
        self.fc1 = M.Linear(dim, mlp_ratio * dim)
        self.fc2 = M.Linear(mlp_ratio * dim, dim)

    def forward(self, x):
        b, n, d = x.shape
        qkv = self.qkv(self.ln1(x)).view(b, n, 3, self.heads, d // self.heads)
        attn = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        x = M.fp8(x + self.proj(attn.reshape(b, n, d)))
        return M.fp8(x + self.fc2(gelu(self.fc1(self.ln2(x)))))


class ViTPose(nn.Module):
    """NHWC images -> ``(1, B, J, S/8, S/8)`` raw score maps."""

    def __init__(self, num_joints: int, dim: int, depth: int, heads: int,
                 input_size: int):
        super().__init__()
        if input_size % PATCH:
            raise ValueError(f"input {input_size} not divisible by patch {PATCH}")
        self.dim, self.depth, self.grid = dim, depth, input_size // PATCH
        self.patch_embed = M.Conv2d(3, dim, PATCH, stride=PATCH)
        self.pos_row = nn.Parameter(torch.zeros(self.grid, dim))
        self.pos_col = nn.Parameter(torch.zeros(self.grid, dim))
        for i in range(depth):
            self.add_module(f"block{i}", Block(dim, heads))
        self.ln_out = LayerNorm(dim)
        self.up_proj = M.Conv2d(dim, dim // 2, 1)
        self.refine = M.Conv2d(dim // 2, dim // 2, 3, padding=1)
        self.score = M.Conv2d(dim // 2, num_joints, 1)

    def score_convs(self) -> list:
        return [self.score]

    def forward(self, images, remat: bool = False):
        b, g = images.shape[0], self.grid
        x = self.patch_embed(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x = x + (self.pos_row[:, None, :] + self.pos_col[None, :, :])
        x = x.reshape(b, g * g, self.dim)
        for i in range(self.depth):
            x = M.checkpointed(getattr(self, f"block{i}"), x, remat)
        x = self.ln_out(x).reshape(b, g, g, self.dim).permute(0, 3, 1, 2)
        x = F.interpolate(self.up_proj(x), scale_factor=2, mode="nearest")
        return self.score(gelu(self.refine(x))).float()[None]


def backbone(model: dict) -> nn.Module:
    dim, depth, heads = SPECS[model["base"]]
    return ViTPose(model.get("num_joints", 16), dim, depth, heads, M.input_size(model))


def stacks(model: dict) -> int:
    return 1


def heatmap_side(model: dict) -> int:
    """The patch grid upsampled 2x: ``side // 8``."""
    return 2 * (M.input_size(model) // PATCH)


@torch.no_grad()
def init_weights_(net: nn.Module, generator: torch.Generator):
    """flax's initializers for what the conv draws leave: each dense kernel
    LeCun-normal over its fan-in (the width D for ``qkv`` too, whose flax
    kernel is ``(D, 3, H, hd)``), truncated at 2 standard deviations, in
    one draw; zero dense biases; unit and zero LayerNorm affines; the
    position embeddings normal with std 0.02."""
    denses = [m for m in net.modules() if isinstance(m, nn.Linear)]
    M.lecun_normal_(denses, generator)
    for m in denses:
        m.bias.zero_()
    for m in net.modules():
        if isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, ViTPose):
            pos = torch.empty((2, *m.pos_row.shape), device=m.pos_row.device)
            pos.normal_(0.0, POS_STD, generator=generator)
            m.pos_row.copy_(pos[0])
            m.pos_col.copy_(pos[1])


@torch.no_grad()
def scale_residual_(net: nn.Module, scale: float):
    """Each block's two residual branches scaled by ``scale`` at their last
    layer: the attention's ``proj`` and the MLP's ``fc2``."""
    for m in net.modules():
        if isinstance(m, Block):
            m.proj.weight.mul_(scale)
            m.fc2.weight.mul_(scale)
