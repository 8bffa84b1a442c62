"""The DSNT-head backward kernel's rewritten arithmetic, mirrored in torch on the CPU.

For every row of up to 4,096 values (the ``Map64``, ``WarpRow`` and
``Slots`` layouts), ``ops/cuda/dsnt_head.cu``'s backward does not compute dh
the way the plain version does: each warp exponentiates against its own max
and the warps' sums are rescaled to the row's (a row of at most 256 values
is one warp); the
target Gaussian is separable (``sum G = sum gx * sum gy``) and normalized by
``max(sum G, eps)``; ``log(z + eps)`` is taken from the logit as
``(v - M) - log S``; ``z / (z + eps)`` and ``m2 / (m2 + eps)`` are taken as
1; and where the Gaussian has underflowed to 0, JS's derivative is
``0.5 ln 2`` and KL's ``log(gn + eps)`` is ``log eps``.  A row whose
``sum G`` is below 1 (its target off the grid) takes the Gaussian in the
contract's form, ``exp(log gx + log gy) / max(sum G, eps)``.  The mirror
below repeats that arithmetic in fp32 torch ops, so that a flaw in it shows
here before the kernel reaches a card.  It is held against
``fused_dsnt_head_bwd_reference`` at the card tests' tolerance for the
backward: rtol 1e-4, atol 5e-6 of the case's largest |dh|, at least 2e-6.
"""

import math

import pytest
import torch

from dsnt_pose2d_tpu_torch.ops.coords import normalized_linspace
from dsnt_pose2d_tpu_torch.ops.cuda import (PREACT_KINDS, REG_KINDS,
                                            fused_dsnt_head_bwd_reference)
from test_torch_head_fwd_math import WARPS, adversarial_rows, layout_warps, log_z

EPS = 1e-24


def kernel_backward(raw, t, gc, gr, sigma_px, reg, preact, threshold,
                    guard=True, separable_off_grid=False, log_z_guard=True):
    """dh as the backward kernel computes it for ``(n, h, w)`` fp32 heatmaps
    of up to 4,096 values (``gr`` None for reg none); ``guard=False``
    normalizes the
    Gaussian by ``1 / sum G`` unguarded, ``separable_off_grid=True``
    keeps the separable product on rows whose ``sum G`` is below 1, and
    ``log_z_guard=False`` takes ``log z`` from the logit where z is 0 too."""
    n, h, w = raw.shape
    hw = h * w
    assert hw <= 4096
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
    rs = 1.0 / s
    z = e * (scale.gather(1, warp) * rs[:, None])
    u = gc[:, :1] * gx + gc[:, 1:] * gy
    if reg == "var":
        mu_x, mu_y = row_sum(e * gx) * rs, row_sum(e * gy) * rs
        cvx = 2.0 * (row_sum(e * gx * gx) * rs - mu_x * mu_x
                     - (2.0 * sigma_px / w) ** 2)
        cvy = 2.0 * (row_sum(e * gy * gy) * rs - mu_y * mu_y
                     - (2.0 * sigma_px / h) ** 2)
        d = (cvx[:, None] * (gx * gx - 2.0 * mu_x[:, None] * gx)
             + cvy[:, None] * (gy * gy - 2.0 * mu_y[:, None] * gy))
    elif reg in ("js", "kl", "mse"):
        lf = [(-0.5 * dd * dd).clamp_min(-1e30) for dd in (
            (xs - t[:, :1]) * (w / (2.0 * sigma_px)),
            (ys - t[:, 1:]) * (h / (2.0 * sigma_px)))]
        f = [torch.exp(x) for x in lf]
        sum_g = f[0].sum(1, keepdim=True) * f[1].sum(1, keepdim=True)
        rg = 1.0 / (sum_g.clamp_min(EPS) if guard else sum_g)
        gn = f[0][:, i % w] * rg * f[1][:, i // w]
        if not separable_off_grid:
            contract = torch.exp(lf[0][:, i % w] + lf[1][:, i // w]) * rg
            gn = torch.where(rg > 1.0, contract, gn)
        lz = log_z(v, m, s, z, log_z_guard)
        if reg == "js":
            d = torch.where(gn == 0, 0.5 * math.log(2.0),
                            0.5 * (lz - torch.log(0.5 * (z + gn) + EPS)))
        elif reg == "kl":
            lgn = torch.where(gn == 0, math.log(EPS), torch.log(gn + EPS))
            d = lz - lgn + 1.0
        else:
            d = 2.0 * (z - gn) * (1.0 / hw)
    if reg != "none":
        u = u + gr[:, None] * d
    dot = (z * u).sum(1, keepdim=True)
    return (z * (u - dot)).reshape(n, h, w)


def assert_dh_close(got, exp):
    assert torch.isfinite(got).all()
    atol = max(2e-6, 5e-6 * exp.abs().max().item())
    torch.testing.assert_close(got, exp, atol=atol, rtol=1e-4)


def cotangents(n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, 2), generator=g), torch.randn((n,), generator=g)


# 64x64 (Map64), the resolution grid's 7x7 and 14x14 (WarpRow), 28x28
# (Slots<4>) and config #5's 56x56 (Slots<16>).
MAPS = [(64, 64), (7, 7), (14, 14), (28, 28), (56, 56)]


@pytest.mark.parametrize("preact", PREACT_KINDS)
@pytest.mark.parametrize("reg", REG_KINDS)
@pytest.mark.parametrize("hw", MAPS)
def test_bwd_arithmetic_matches_plain(hw, reg, preact):
    # The adversarial rows: one-hot, underflowing and all-below-threshold
    # rows, -inf logits, and targets whose sum G underflows or is below 1.
    raw, t = adversarial_rows(12, *hw, seed=11)
    gc, gr = cotangents(12, 3)
    gr = None if reg == "none" else gr
    got = kernel_backward(raw, t, gc, gr, 1.0, reg, preact, 0.5)
    exp = fused_dsnt_head_bwd_reference(raw, t, gc, gr, sigma_px=1.0, reg=reg,
                                        preact=preact, threshold=0.5)
    assert_dh_close(got, exp)


@pytest.mark.parametrize("sigma", [0.7, 1.0, 2.5])
@pytest.mark.parametrize("hw", MAPS)
def test_bwd_arithmetic_matches_plain_on_random_rows(hw, sigma):
    g = torch.Generator().manual_seed(5)
    raw = torch.randn((48, *hw), generator=g) * 3.0
    raw[0::7] *= 40.0          # peaked rows: probabilities underflow to 0
    t = torch.rand((48, 2), generator=g) * 2.4 - 1.2
    gc, gr = cotangents(48, 7)
    for reg in REG_KINDS:
        grr = None if reg == "none" else gr
        got = kernel_backward(raw, t, gc, grr, sigma, reg, "softmax", 0.0)
        exp = fused_dsnt_head_bwd_reference(raw, t, gc, grr, sigma_px=sigma,
                                            reg=reg)
        assert_dh_close(got, exp)


def test_unguarded_gauss_normalization_is_not_finite():
    # The trap the guard closes: sum G underflows to 0 (targets far off the
    # grid), so 1 / sum G is inf and gn = gx * inf * gy is inf or 0 * inf.
    raw, t = adversarial_rows(12, 64, 64, seed=11)
    gc, gr = cotangents(12, 3)
    guarded = kernel_backward(raw, t, gc, gr, 1.0, "js", "softmax", 0.5)
    unguarded = kernel_backward(raw, t, gc, gr, 1.0, "js", "softmax", 0.5,
                                guard=False)
    assert torch.isfinite(guarded).all()
    assert not torch.isfinite(unguarded[3]).all()
    assert not torch.isfinite(unguarded[5]).all()


def test_separable_gauss_off_grid_parts_from_plain():
    # Why a row with sum G < 1 takes the contract's form: 1 / sum G > 1
    # lifts the separable product where the contract's exp of the summed
    # exponents has underflowed (sigma 0.7 px, targets up to 6 px off the grid),
    # and KL's log(gn + eps) turns that into an error in dh far above the
    # tolerance.
    g = torch.Generator().manual_seed(5)
    raw = torch.randn((48, 64, 64), generator=g) * 3.0
    raw[0::7] *= 40.0
    t = torch.rand((48, 2), generator=g) * 2.4 - 1.2
    gc, gr = cotangents(48, 7)
    exp = fused_dsnt_head_bwd_reference(raw, t, gc, gr, sigma_px=0.7, reg="kl")
    assert_dh_close(kernel_backward(raw, t, gc, gr, 0.7, "kl", "softmax", 0.0),
                    exp)
    with pytest.raises(AssertionError, match="not close"):
        assert_dh_close(kernel_backward(raw, t, gc, gr, 0.7, "kl", "softmax",
                                        0.0, separable_off_grid=True), exp)


@pytest.mark.parametrize("reg", ["js", "kl"])
def test_log_z_of_a_minus_inf_logit_needs_its_guard(reg):
    # Row 6 holds -inf logits, one at its target: z = 0 there, and taking
    # log z from the logit gives d = -inf, z * u = 0 * (-inf) = NaN and a
    # NaN <z, u> in every dh of the row, unless log z is 0 where z is 0.
    raw, t = adversarial_rows(12, 64, 64, seed=11)
    gc, gr = cotangents(12, 3)
    guarded = kernel_backward(raw, t, gc, gr, 1.0, reg, "softmax", 0.5)
    unguarded = kernel_backward(raw, t, gc, gr, 1.0, reg, "softmax", 0.5,
                                log_z_guard=False)
    assert torch.isfinite(guarded).all()
    assert torch.isnan(unguarded[6]).all()
