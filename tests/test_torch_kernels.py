"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and ``nvcc`` (marker ``cuda``) and
skips without one.  The file imports neither JAX nor the JAX package, so on
a machine with a card it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerances: the DSNT head's coords atol 2e-6, its reg rtol 1e-5 / atol 1e-5
(the bar of ``tests/test_pallas.py`` for the TPU kernel against its oracle;
the kernel sums in another order than the plain version); the head's
backward dh rtol 1e-4 with atol 5e-6 of the largest |dh|, at least 2e-6:
dh = z (u - <z, u>) keeps a few fp32 ulps of |u|, which reaches ~1e2 where
KL's log(g + eps) meets a pixel far from the target; row_shift bitwise (both
round each product and the sum separately).
"""

import numpy as np
import pytest
import torch

from dsnt_pose2d_tpu_torch.ops.cuda import (MAX_HW, PREACT_KINDS, REG_KINDS,
                                            fused_dsnt_head,
                                            fused_dsnt_head_bwd_reference,
                                            fused_dsnt_head_reference,
                                            launch_counts, reset_launch_counts,
                                            shift_rows, shift_rows_reference)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _heads(shape, seed, device):
    rng = np.random.default_rng(seed)
    raw = (rng.normal(size=shape) * 3).astype(np.float32)
    flat = raw.reshape(-1, shape[-2] * shape[-1])
    flat[0] *= 40.0          # probabilities underflow to 0
    flat[1] -= 100.0         # every logit below any threshold: fallback
    t = rng.uniform(-0.8, 0.8, size=(*shape[:-2], 2)).astype(np.float32)
    return torch.from_numpy(raw).to(device), torch.from_numpy(t).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("preact", PREACT_KINDS)
@pytest.mark.parametrize("reg", REG_KINDS)
@pytest.mark.parametrize("shape", [(2, 3, 64, 64), (5, 7, 9)])
def test_head_kernel_matches_plain(cuda, shape, reg, preact):
    raw, t = _heads(shape, 31, cuda)
    got_c, got_r = fused_dsnt_head(raw, t, sigma_px=1.3, reg=reg,
                                   preact=preact, threshold=0.5)
    exp_c, exp_r = fused_dsnt_head_reference(raw, t, sigma_px=1.3, reg=reg,
                                             preact=preact, threshold=0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_c, exp_c, atol=2e-6, rtol=0)
    assert (got_r is None) == (exp_r is None)
    if exp_r is not None:
        torch.testing.assert_close(got_r, exp_r, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("reg", REG_KINDS)
def test_head_kernel_without_targets(cuda, reg):
    raw, _ = _heads((3, 16, 16), 5, cuda)
    got_c, got_r = fused_dsnt_head(raw, None, reg=reg)
    exp_c, exp_r = fused_dsnt_head_reference(raw, None, reg=reg)
    torch.testing.assert_close(got_c, exp_c, atol=2e-6, rtol=0)
    assert (got_r is None) == (exp_r is None) == (reg != "var")
    if exp_r is not None:
        torch.testing.assert_close(got_r, exp_r, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_head_kernel_counts_launches(cuda):
    raw, t = _heads((4, 8, 8), 2, cuda)
    reset_launch_counts()
    fused_dsnt_head(raw, t, reg="js")
    fused_dsnt_head_reference(raw, t, reg="js")
    assert launch_counts()["dsnt_head_fwd"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("preact", PREACT_KINDS)
@pytest.mark.parametrize("reg", REG_KINDS)
@pytest.mark.parametrize("shape", [(2, 3, 64, 64), (5, 7, 9)])
def test_head_bwd_kernel_matches_plain(cuda, shape, reg, preact):
    raw, t = _heads(shape, 37, cuda)
    g = torch.Generator().manual_seed(3)
    gc = torch.randn((*shape[:-2], 2), generator=g).to(cuda)
    gr = torch.randn(shape[:-2], generator=g).to(cuda)
    kw = dict(sigma_px=1.3, reg=reg, preact=preact, threshold=0.5)
    x = raw.clone().requires_grad_(True)
    coords, regv = fused_dsnt_head(x, t, **kw)
    reset_launch_counts()
    if regv is None:
        coords.backward(gc)
    else:
        torch.autograd.backward([coords, regv], [gc, gr])
    assert launch_counts()["dsnt_head_bwd"] == 1
    exp = fused_dsnt_head_bwd_reference(raw, t, gc,
                                        None if regv is None else gr, **kw)
    torch.cuda.synchronize()
    atol = max(2e-6, 5e-6 * exp.abs().max().item())
    torch.testing.assert_close(x.grad, exp, atol=atol, rtol=1e-4)


@pytest.mark.cuda
def test_head_kernel_refuses_grad_and_oversize(cuda):
    # The backward runs on the card (a zero map: uniform softmax, dh of the
    # x-coordinate is z (X - <z, X>)), and an oversized map is refused.
    raw = torch.zeros((2, 8, 8), device=cuda, requires_grad=True)
    coords, _ = fused_dsnt_head(raw, None, reg="none")
    coords[..., 0].sum().backward()
    xs = (2 * torch.arange(8, device=cuda) + 1) / 8 - 1
    torch.testing.assert_close(raw.grad, (xs / 64).expand(2, 8, 8),
                               atol=1e-7, rtol=0)
    side = int(MAX_HW ** 0.5) + 1
    with pytest.raises(ValueError, match="exceeds"):
        fused_dsnt_head(torch.zeros((1, side, side), device=cuda), None)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 328, 210, 1), (300, 1176, 1158, 3),
                                   (70, 786, 768, 3)])
def test_row_shift_kernel_bitwise(cuda, shape):
    r, length, out, stride = shape
    rng = np.random.default_rng(r)
    rows = torch.from_numpy(rng.uniform(size=(r, length)).astype(np.float32))
    starts = torch.from_numpy(
        rng.integers(0, length - out - stride + 1, size=(r,)).astype(np.int32))
    fracs = torch.from_numpy(rng.uniform(size=(r,)).astype(np.float32))
    rows, starts, fracs = rows.to(cuda), starts.to(cuda), fracs.to(cuda)
    reset_launch_counts()
    got = shift_rows(rows, starts, fracs, out, stride=stride)
    exp = shift_rows_reference(rows, starts, fracs, out, stride=stride)
    torch.cuda.synchronize()
    assert torch.equal(got, exp)
    assert launch_counts()["row_shift"] == 1


@pytest.mark.cuda
def test_row_shift_kernel_masks_out_of_row_taps(cuda):
    rows = torch.arange(1.0, 11.0, device=cuda).reshape(2, 5)
    starts = torch.tensor([-1, 3], dtype=torch.int32, device=cuda)
    fracs = torch.tensor([0.5, 0.5], device=cuda)
    got = shift_rows(rows, starts, fracs, 3)
    assert torch.equal(got, shift_rows_reference(rows, starts, fracs, 3))
