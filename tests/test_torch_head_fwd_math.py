"""The DSNT-head forward kernel's rewritten arithmetic, mirrored in torch on the CPU.

``ops/cuda/dsnt_head.cu::dsnt_head_fwd_kernel`` does not compute the head the
way the plain version does: each warp exponentiates against its own max and
the warps' sums are rescaled to the row's (a row of at most 256 values is
one warp, ``WarpRow``); the target Gaussian is separable
(``exp(-(dx^2 + dy^2)/2) = gx(x) gy(y)``, ``sum G = sum gx * sum gy``); the
logs of z and of the normalized Gaussian are taken from the logits, with
``log max(sum G, eps)``; and where the Gaussian has underflowed to 0, JS's
term is ``z log 2`` and KL's ``log(gn + eps)`` is ``log eps``.  The mirror
below repeats that arithmetic in fp32 torch ops, so that a flaw in it (the
``0 * inf`` of an unguarded ``log sum G``) shows here before the kernel
reaches a card.  It is held against ``fused_dsnt_head_reference`` at the
card tests' tolerance: coords atol 2e-6, reg rtol 1e-5 / atol 1e-5.
"""

import math

import numpy as np
import pytest
import torch

from dsnt_pose2d_tpu_torch.ops.coords import normalized_linspace
from dsnt_pose2d_tpu_torch.ops.cuda import (MAX_HW, PREACT_KINDS, REG_KINDS,
                                            fused_dsnt_head_reference)

EPS = 1e-24
WARPS, THREADS = 8, 256
WARP_ROW_MAX_HW = 256     # rows up to this size are one warp (WarpRow)


def layout_warps(h, w):
    """The warp of the row's threads that holds each element, in the layout
    the kernels give an ``h`` x ``w`` row: Map64's float4 number t + 256 k
    (thread t) for 64x64, one warp for rows of up to 256 values (WarpRow),
    element t + 256 k in thread t otherwise (Slots, AnyMap)."""
    i = torch.arange(h * w)
    if (h, w) == (64, 64):
        return i // 4 % THREADS // 32
    if h * w <= WARP_ROW_MAX_HW:
        return torch.zeros_like(i)
    return i % THREADS // 32


def kernel_forward(raw, t, sigma_px, reg, preact, threshold, guard=True,
                   log_z_guard=True):
    """``(coords, reg)`` as the forward kernel computes them, for ``(n, h, w)``
    fp32 heatmaps; ``guard=False`` takes ``log sum G`` unguarded, and
    ``log_z_guard=False`` takes ``log z`` from the logit where z is 0 too."""
    n, h, w = raw.shape
    hw = h * w
    v = raw.reshape(n, hw)
    i = torch.arange(hw)
    warp = layout_warps(h, w).expand(n, hw)
    keep = torch.ones_like(v, dtype=torch.bool)
    if preact == "thresholded_softmax":
        keep = v >= threshold
        keep |= ~keep.any(1, keepdim=True)
    m_w = torch.full((n, WARPS), -math.inf).scatter_reduce(
        1, warp, v.masked_fill(~keep, -math.inf), "amax")
    e = torch.where(keep, torch.exp(v - m_w.gather(1, warp)), 0.0)
    m = m_w.amax(1, keepdim=True)
    scale = torch.where(m_w == -math.inf, 0.0, torch.exp(m_w - m))

    def row_sum(x):      # per warp, then rescaled to the row's max
        return (torch.zeros((n, WARPS)).scatter_add(1, warp, x) * scale).sum(1)

    xs, ys = normalized_linspace(w), normalized_linspace(h)
    gx, gy = xs[i % w], ys[i // w]
    s = row_sum(e)
    coords = torch.stack([row_sum(e * gx) / s, row_sum(e * gy) / s], -1)
    if reg == "none":
        return coords, torch.zeros(n)
    if reg == "var":
        var = [row_sum(e * g * g) / s - c * c for g, c in ((gx, coords[:, 0]),
                                                         (gy, coords[:, 1]))]
        tv = [(2.0 * sigma_px / w) ** 2, (2.0 * sigma_px / h) ** 2]
        return coords, (var[0] - tv[0]) ** 2 + (var[1] - tv[1]) ** 2
    z = e * (scale.gather(1, warp) / s[:, None])
    d = [(xs - t[:, :1]) * (w / (2.0 * sigma_px)),
         (ys - t[:, 1:]) * (h / (2.0 * sigma_px))]
    lf = [(-0.5 * dd * dd).clamp_min(-1e30) for dd in d]
    f = [torch.exp(-0.5 * dd * dd) for dd in d]
    sum_g = f[0].sum(1, keepdim=True) * f[1].sum(1, keepdim=True)
    sg = sum_g.clamp_min(EPS)
    gn = f[0][:, i % w] * (1.0 / sg) * f[1][:, i // w]
    lz = log_z(v, m, s, z, log_z_guard)
    lg = lf[0][:, i % w] + lf[1][:, i // w] - torch.log(sg if guard else sum_g)
    if reg == "js":
        lm = torch.log(0.5 * (z + gn) + EPS)
        term = torch.where(gn == 0, z * math.log(2.0),
                           z * (lz - lm) + gn * (lg - lm))
        return coords, 0.5 * term.sum(1)
    if reg == "kl":
        lgn = torch.where(gn == 0, math.log(EPS), torch.log(gn + EPS))
        return coords, (z * (lz - lgn)).sum(1)
    return coords, ((z - gn) ** 2).sum(1) / hw


def log_z(v, m, s, z, guard=True):
    """log z from the logits, ``(v - m) - log s``; 0 where z is 0 (the
    kernels' ``log_z``), which a -inf logit would otherwise make -inf."""
    lz = (v - m) - torch.log(s)[:, None]
    return torch.where(z == 0, 0.0, lz) if guard else lz


def adversarial_rows(n, h, w, seed):
    """The card tests' adversarial rows (``test_torch_kernels.py``)."""
    rng = np.random.default_rng(seed)
    raw = (rng.normal(size=(n, h * w)) * 3).astype(np.float32)
    raw[0] = -50.0
    raw[0, (h * w) // 3] = 60.0      # one-hot: every other z is 0
    raw[1] *= 40.0                   # most z underflow
    raw[2] -= 100.0                  # all below the threshold: plain softmax
    t = rng.uniform(-0.8, 0.8, size=(n, 2)).astype(np.float32)
    t[0] = (50.0, 50.0)              # one-hot z and no Gaussian at all
    t[3] = (40.0, -35.0)             # sum G underflows, every gn is 0
    t[4] = (3.0, 0.0)                # sum G below eps
    t[5] = (1.32, 1.32)              # sum G underflows, the corner's gn > 0
    raw[6, [5, -1]] = -np.inf        # z = 0 from -inf logits, one at the target
    t[6] = ((2 * 5 + 1) / w - 1, 1 / h - 1)
    return (torch.from_numpy(raw.reshape(n, h, w)), torch.from_numpy(t))


@pytest.mark.parametrize("preact", PREACT_KINDS)
@pytest.mark.parametrize("reg", REG_KINDS)
@pytest.mark.parametrize("hw", [(64, 64), (7, 9), (128, MAX_HW // 128), (7, 7),
                                (14, 14), (16, 16), (28, 28), (56, 56)])
def test_kernel_arithmetic_matches_plain(hw, reg, preact):
    raw, t = adversarial_rows(12, *hw, seed=11)
    got_c, got_r = kernel_forward(raw, t, 1.0, reg, preact, 0.5)
    exp_c, exp_r = fused_dsnt_head_reference(raw, t, sigma_px=1.0, reg=reg,
                                             preact=preact, threshold=0.5)
    assert torch.isfinite(got_c).all() and torch.isfinite(got_r).all()
    torch.testing.assert_close(got_c, exp_c, atol=2e-6, rtol=0)
    if exp_r is not None:
        torch.testing.assert_close(got_r, exp_r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sigma", [0.7, 1.0, 2.5])
def test_kernel_arithmetic_matches_plain_on_random_rows(sigma):
    g = torch.Generator().manual_seed(3)
    raw = torch.randn((64, 64, 64), generator=g) * 4.0
    t = torch.rand((64, 2), generator=g) * 2.4 - 1.2
    for reg in ("js", "kl", "mse"):
        got = kernel_forward(raw, t, sigma, reg, "softmax", 0.0)[1]
        exp = fused_dsnt_head_reference(raw, t, sigma_px=sigma, reg=reg)[1]
        torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-5)


def test_unguarded_log_of_gauss_sum_is_not_finite():
    # The trap the guard closes: sum G underflows to 0 while the corner's
    # gn (normalized by max(sum G, eps)) stays > 0, so log(sum G) = -inf
    # makes that gn's log +inf.
    raw, t = adversarial_rows(12, 64, 64, seed=11)
    _, guarded = kernel_forward(raw, t, 1.0, "js", "softmax", 0.5)
    _, unguarded = kernel_forward(raw, t, 1.0, "js", "softmax", 0.5, guard=False)
    assert torch.isfinite(guarded).all()
    assert not torch.isfinite(unguarded[5])


@pytest.mark.parametrize("reg", ["js", "kl"])
def test_log_z_of_a_minus_inf_logit_needs_its_guard(reg):
    # Row 6 holds -inf logits: z = 0 there, and z * ((v - m) - log s) is
    # 0 * (-inf) = NaN unless log z is taken as 0 where z is 0.
    raw, t = adversarial_rows(12, 64, 64, seed=11)
    _, guarded = kernel_forward(raw, t, 1.0, reg, "softmax", 0.5)
    _, unguarded = kernel_forward(raw, t, 1.0, reg, "softmax", 0.5,
                                  log_z_guard=False)
    assert torch.isfinite(guarded).all()
    assert torch.isnan(unguarded[6])
