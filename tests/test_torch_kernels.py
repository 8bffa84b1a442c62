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
round each product and the sum separately); the calibration kernels: copy
bitwise (one fp32 add), exp rtol 1e-6 (full-precision expf against
torch.exp), softmax rtol 2e-6 / atol 1e-9 (4096 terms summed in another
order than torch.softmax).  Last, ViT-T/16's train and eval steps at
config #5's 448 px against the same steps on the kernels' plain versions,
at ``chip_smoke.py``'s train and serve tolerances, and its train step with
remat against the one without.  Train-mode BatchNorm's four kernels
against the plain composition at the main path's shapes, with the
tolerances stated at ``test_bn_kernel_matches_plain``; bitwise across runs;
two launches forward and two backward.
"""

import re

import numpy as np
import pytest
import torch

from dsnt_pose2d_tpu_torch.ops.cuda import (MAX_HW, PREACT_KINDS, REG_KINDS, calib,
                                            fused_dsnt_head,
                                            fused_dsnt_head_bwd,
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


# 64x64 (hourglass at 256 px: Map64), 56x56 (ResNet-50 and ViT-S/16 2x at
# 448 px: Slots<16>), 7x7, 14x14 and 28x28 (the resolution grid's maps:
# WarpRow, WarpRow, Slots<4>), 8x8 to 32x32 (the same ResNets at 256 px),
# and each layout's edges: 16x16 = 256 and 1x257 (WarpRow | Slots<4>),
# 32x32 = 1,024 and 5x205 = 1,025 (Slots<4> | Slots<16>), 32x128 = 4,096
# and 17x241 = 4,097 (Slots<16> | AnyMap, StagedRow).  Row counts that are
# no multiple of WarpRow's four rows a block leave its last block part full.
HEAD_SHAPES = [(2, 3, 64, 64), (5, 7, 9), (2, 3, 56, 56), (4, 8, 8),
               (4, 16, 16), (4, 32, 32), (3, 5, 7, 7), (3, 14, 14),
               (2, 5, 28, 28), (3, 1, 257), (3, 5, 205), (2, 32, 128),
               (3, 17, 241)]


@pytest.mark.cuda
@pytest.mark.parametrize("preact", PREACT_KINDS)
@pytest.mark.parametrize("reg", REG_KINDS)
@pytest.mark.parametrize("shape", HEAD_SHAPES)
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
@pytest.mark.parametrize("shape", HEAD_SHAPES)
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
@pytest.mark.parametrize("reg", REG_KINDS)
def test_head_bwd_kernel_deterministic_at_56(cuda, reg):
    # The ResNet-50 2x main path's rows (512 of 56x56): two launches on the
    # same inputs give the same bits.
    raw, t = _heads((32, 16, 56, 56), 41, cuda)
    g = torch.Generator().manual_seed(4)
    gc = torch.randn((32, 16, 2), generator=g).to(cuda)
    gr = torch.randn((32, 16), generator=g).to(cuda)
    kw = dict(sigma_px=1.0, reg=reg, preact="softmax")
    a = fused_dsnt_head_bwd(raw, t, gc, gr, **kw)
    b = fused_dsnt_head_bwd(raw, t, gc, gr, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


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


def _shift_inputs(r, length, out, stride, seed, device):
    rng = np.random.default_rng(seed)
    rows = rng.uniform(size=(r, length)).astype(np.float32)
    starts = rng.integers(0, length - out - stride + 1, size=(r,))
    starts[:8] = np.arange(8) % (length - out - stride + 1)  # every residue mod 4
    fracs = rng.uniform(size=(r,)).astype(np.float32)
    return (torch.from_numpy(rows).to(device),
            torch.from_numpy(starts.astype(np.int32)).to(device),
            torch.from_numpy(fracs).to(device))


# Output rows of every length mod 4 (rows start at every 16-byte phase of the
# flat output), the strides the shear warp uses (1: gray, 3: RGB) and one the
# kernel's vector path does not take (2); 37 rows is no multiple of the rows
# a block holds.
@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("out", [96, 97, 98, 99])
def test_row_shift_kernel_bitwise_layouts(cuda, out, stride):
    rows, starts, fracs = _shift_inputs(37, out + 13, out, stride, out, cuda)
    got = shift_rows(rows, starts, fracs, out, stride=stride)
    exp = shift_rows_reference(rows, starts, fracs, out, stride=stride)
    torch.cuda.synchronize()
    assert torch.equal(got, exp)


# The main path's four calls: the train step's two passes, then the eval
# step's (hg8, batch 32, 384-px canvases, RGB rows).
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(12288, 3864, 2502), (8192, 1680, 768),
                                   (12288, 1176, 1158), (8192, 786, 768)])
def test_row_shift_kernel_bitwise_main_path_shapes(cuda, shape):
    r, length, out = shape
    rows, starts, fracs = _shift_inputs(r, length, out, 3, length, cuda)
    starts = starts - starts % 3       # whole RGB pixels, as the warp gives
    got = shift_rows(rows, starts, fracs, out, stride=3)
    exp = shift_rows_reference(rows, starts, fracs, out, stride=3)
    torch.cuda.synchronize()
    assert torch.equal(got, exp)


# The ResNet-50 2x main path's four calls (batch 32, 448-px input from
# 672-px canvases): the train step's two passes, then the eval step's.
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(21504, 6744, 4374), (14336, 2928, 1344),
                                   (21504, 2040, 2022), (14336, 1362, 1344)])
def test_row_shift_kernel_bitwise_448px_shapes(cuda, shape):
    r, length, out = shape
    rows, starts, fracs = _shift_inputs(r, length, out, 3, length, cuda)
    starts = starts - starts % 3
    got = shift_rows(rows, starts, fracs, out, stride=3)
    exp = shift_rows_reference(rows, starts, fracs, out, stride=3)
    torch.cuda.synchronize()
    assert torch.equal(got, exp)


@pytest.mark.cuda
def test_row_shift_kernel_unaligned_rows(cuda):
    # A base off the 16-byte grid takes the scalar path: still bitwise.
    rows, starts, fracs = _shift_inputs(41, 300, 250, 3, 1, cuda)
    flat = torch.empty(41 * 300 + 1, device=cuda)
    shifted = flat[1:].view(41, 300)
    shifted.copy_(rows)
    got = shift_rows(shifted, starts, fracs, 250, stride=3)
    torch.cuda.synchronize()
    assert torch.equal(got, shift_rows_reference(rows, starts, fracs, 250,
                                                 stride=3))


def _adversarial_heads(n, h, w, seed, device):
    """Rows where the kernel's rewritten arithmetic could part from the plain
    version: z underflowing (one-hot), every logit below the threshold, and
    targets so far off the grid that the Gaussian's sum underflows, and
    -inf logits."""
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
    return (torch.from_numpy(raw.reshape(n, h, w)).to(device),
            torch.from_numpy(t).to(device))


ADVERSARIAL_CASES = ["64x64", "64x64_unaligned", "7x9", "max_hw", "7x7",
                     "14x14", "16x16", "1x257", "28x28", "32x32", "5x205",
                     "56x56", "32x128", "17x241"]


def _adversarial_case(case, device):
    """The adversarial rows in the map and alignment of ``case``."""
    h, w = ((128, MAX_HW // 128) if case == "max_hw"
            else tuple(map(int, case.removesuffix("_unaligned").split("x"))))
    raw, t = _adversarial_heads(21, h, w, 11, device)
    if case == "64x64_unaligned":
        flat = torch.empty(raw.numel() + 1, device=device)
        flat[1:].copy_(raw.reshape(-1))
        raw = flat[1:].view(raw.shape)
    return raw, t


def _assert_dh_close(got, exp):
    assert torch.isfinite(got).all()
    atol = max(2e-6, 5e-6 * exp.abs().max().item())
    torch.testing.assert_close(got, exp, atol=atol, rtol=1e-4)


# The 64x64 layout, 64x64 at a base off the 16-byte grid (Slots<16>), a
# MAX_HW map (AnyMap), the resolution grid's and config #5's maps, and each
# layout's edges (HEAD_SHAPES).
@pytest.mark.cuda
@pytest.mark.parametrize("preact", PREACT_KINDS)
@pytest.mark.parametrize("reg", REG_KINDS)
@pytest.mark.parametrize("case", ADVERSARIAL_CASES)
def test_head_kernel_adversarial_rows(cuda, case, reg, preact):
    raw, t = _adversarial_case(case, cuda)
    kw = dict(sigma_px=1.0, reg=reg, preact=preact, threshold=0.5)
    got_c, got_r = fused_dsnt_head(raw, t, **kw)
    exp_c, exp_r = fused_dsnt_head_reference(raw, t, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got_c).all()
    torch.testing.assert_close(got_c, exp_c, atol=2e-6, rtol=0)
    if exp_r is not None:
        assert torch.isfinite(got_r).all()
        torch.testing.assert_close(got_r, exp_r, rtol=1e-5, atol=1e-5)


# The backward on the same rows: Map64 takes the aligned 64x64 case,
# WarpRow and Slots<S> the others up to 4,096 values, StagedRow the larger.
@pytest.mark.cuda
@pytest.mark.parametrize("preact", PREACT_KINDS)
@pytest.mark.parametrize("reg", REG_KINDS)
@pytest.mark.parametrize("case", ADVERSARIAL_CASES)
def test_head_bwd_kernel_adversarial_rows(cuda, case, reg, preact):
    raw, t = _adversarial_case(case, cuda)
    g = torch.Generator().manual_seed(3)
    gc = torch.randn((raw.shape[0], 2), generator=g).to(cuda)
    gr = torch.randn((raw.shape[0],), generator=g).to(cuda)
    gr = None if reg == "none" else gr
    kw = dict(sigma_px=1.0, reg=reg, preact=preact, threshold=0.5)
    reset_launch_counts()
    got = fused_dsnt_head_bwd(raw, t, gc, gr, **kw)
    assert launch_counts()["dsnt_head_bwd"] == 1
    exp = fused_dsnt_head_bwd_reference(raw, t, gc, gr, **kw)
    torch.cuda.synchronize()
    _assert_dh_close(got, exp)


# Targets off the grid at sigma 0.7 px: rows whose sum G < 1 take the
# contract's form of the Gaussian, in Map64, WarpRow and Slots<S>.
@pytest.mark.cuda
@pytest.mark.parametrize("reg", ["js", "kl", "mse"])
@pytest.mark.parametrize("shape", [(256, 64, 64), (512, 7, 7), (512, 14, 14),
                                   (512, 28, 28), (512, 56, 56)])
def test_head_bwd_kernel_off_grid_targets(cuda, reg, shape):
    n = shape[0]
    g = torch.Generator().manual_seed(5)
    raw = (torch.randn(shape, generator=g) * 3.0).to(cuda)
    t = (torch.rand((n, 2), generator=g) * 2.4 - 1.2).to(cuda)
    gc = torch.randn((n, 2), generator=g).to(cuda)
    gr = torch.randn((n,), generator=g).to(cuda)
    got = fused_dsnt_head_bwd(raw, t, gc, gr, sigma_px=0.7, reg=reg)
    exp = fused_dsnt_head_bwd_reference(raw, t, gc, gr, sigma_px=0.7, reg=reg)
    torch.cuda.synchronize()
    _assert_dh_close(got, exp)


# Sums in a fixed order: two launches on the same inputs give the same
# bits, in every layout: Map64, WarpRow (an odd row count too), Slots<4>,
# Slots<16> and StagedRow.
DETERMINISM_SHAPES = [(1024, 64, 64), (300, 7, 9), (512, 7, 7), (301, 14, 14),
                      (512, 28, 28), (300, 32, 128), (40, 17, 241)]


@pytest.mark.cuda
@pytest.mark.parametrize("reg", REG_KINDS)
@pytest.mark.parametrize("shape", DETERMINISM_SHAPES)
def test_head_bwd_kernel_deterministic(cuda, shape, reg):
    raw, t = _heads(shape, 41, cuda)
    g = torch.Generator().manual_seed(4)
    gc = torch.randn((shape[0], 2), generator=g).to(cuda)
    gr = None if reg == "none" else torch.randn((shape[0],), generator=g).to(cuda)
    kw = dict(sigma_px=1.0, reg=reg, preact="thresholded_softmax", threshold=0.5)
    first = fused_dsnt_head_bwd(raw, t, gc, gr, **kw)
    second = fused_dsnt_head_bwd(raw, t, gc, gr, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("reg", REG_KINDS)
@pytest.mark.parametrize("shape", DETERMINISM_SHAPES)
def test_head_kernel_deterministic(cuda, shape, reg):
    raw, t = _heads(shape, 43, cuda)
    kw = dict(sigma_px=1.0, reg=reg, preact="thresholded_softmax", threshold=0.5)
    first = fused_dsnt_head(raw, t, **kw)
    second = fused_dsnt_head(raw, t, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    if first[1] is not None:
        assert torch.equal(first[1], second[1])


CALIB_TOL = {"copy": None, "exp": dict(rtol=1e-6, atol=0.0),
             "smax": dict(rtol=2e-6, atol=1e-9)}


# The bench's shape, a row count that is no multiple of a block's rows, and
# arrays whose last block is ragged in exp's blocks of 256 float4 and the
# copy's of 1024 (6, 257 and 9509 float4).
CALIB_SHAPES = [(8192, 4096), (130, 4096), (37, 1028), (3, 8), (1, 1028)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(CALIB_TOL))
@pytest.mark.parametrize("shape", CALIB_SHAPES)
def test_calib_kernel_matches_plain(cuda, shape, kind):
    rng = np.random.default_rng(shape[0])
    x = torch.from_numpy((rng.normal(size=shape) * 3).astype(np.float32)).to(cuda)
    s = torch.full((1,), 0.37, device=cuda)
    reset_launch_counts()
    got = getattr(calib, f"calib_{kind}")(x, s)
    exp = getattr(calib, f"calib_{kind}_reference")(x, s)
    torch.cuda.synchronize()
    assert launch_counts()[f"calib_{kind}"] == 1
    if CALIB_TOL[kind] is None:
        assert torch.equal(got, exp)
    else:
        torch.testing.assert_close(got, exp, **CALIB_TOL[kind])


@pytest.mark.cuda
def test_calib_kernel_refuses_misaligned_rows(cuda):
    x = torch.zeros((4, 12), device=cuda)[:, 1:9].contiguous()
    s = torch.zeros((1,), device=cuda)
    assert calib.calib_copy(x, s).shape == (4, 8)
    with pytest.raises(ValueError, match="16-byte"):
        calib.calib_copy(torch.zeros(33, device=cuda)[1:].view(4, 8), s)


# -- the eval CLI's paths: flip and multi-scale eval --------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.9, 1.1])
def test_row_shift_kernel_bitwise_at_eval_scales(cuda, scale, monkeypatch):
    # The two row_shift calls of the eval preprocess at a crop scale other
    # than 1 (flagship: batch 32, 384-px canvases, 256-px input).  The shear
    # warp's extents depend on the canvas, the input and the shear bound
    # only, so the shapes are those of scale 1; the second pass's rows are
    # the scaled image's.  Held bitwise on the path's inputs and on random
    # fracs (eval has no shear: its fracs are 0).
    from dsnt_pose2d_tpu_torch.data import augment
    from dsnt_pose2d_tpu_torch.data.synthetic import make_synthetic_mpii
    from dsnt_pose2d_tpu_torch.utils.config import DataConfig

    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in make_synthetic_mpii(32, 384, seed=0).items()}
    calls, kernel = [], augment.shift_rows

    def record(rows, starts, fracs, out, stride=1):
        calls.append((rows.clone(), starts.clone(), fracs.clone(), out, stride))
        return kernel(rows, starts, fracs, out, stride)

    monkeypatch.setattr(augment, "shift_rows", record)
    with torch.inference_mode():
        augment.preprocess_batch(
            batch["canvases"], batch["coords_px"], batch["mask"],
            batch["head_length"], batch["canvas_from_orig"], DataConfig(), 256,
            canvas_margin=batch["canvas_margin"], eval_scale=scale)
    assert [(tuple(c[0].shape), c[3], c[4]) for c in calls] == [
        ((12288, 1176), 1158, 3), ((8192, 786), 768, 3)]
    rng = torch.Generator().manual_seed(int(scale * 10))
    for rows, starts, fracs, out, stride in calls:
        random_fracs = torch.rand(fracs.shape, generator=rng).to(cuda)
        for f in (fracs, random_fracs):
            got = shift_rows(rows, starts, f, out, stride=stride)
            exp = shift_rows_reference(rows, starts, f, out, stride=stride)
            torch.cuda.synchronize()
            assert torch.equal(got, exp)


@pytest.mark.cuda
@pytest.mark.parametrize("reg", ["none", "js"])
def test_head_kernel_on_a_flipped_batch(cuda, reg):
    # The flip pass's heatmaps: the kernel against its plain version on a
    # batch mirrored along its width, and the mirror's x against -x of the
    # unmirrored batch (the pixel-center grid is symmetric).
    raw, t = _heads((32, 16, 64, 64), 7, cuda)
    flipped = raw.flip(-1)
    t_f = torch.stack([-t[..., 0], t[..., 1]], dim=-1)
    got_c, got_r = fused_dsnt_head(flipped, t_f, sigma_px=1.0, reg=reg)
    exp_c, exp_r = fused_dsnt_head_reference(flipped, t_f, sigma_px=1.0, reg=reg)
    c, r = fused_dsnt_head(raw, t, sigma_px=1.0, reg=reg)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_c, exp_c, atol=2e-6, rtol=0)
    torch.testing.assert_close(got_c, torch.stack([-c[..., 0], c[..., 1]], -1),
                               atol=2e-6, rtol=0)
    if reg == "none":
        assert got_r is exp_r is r is None
    else:
        torch.testing.assert_close(got_r, exp_r, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got_r, r, rtol=1e-5, atol=1e-5)


# -- the ViT path (BASELINE config #5's head and warp shapes, ViT-T/16) ------


def _plain_path(monkeypatch):
    """The head's autograd Function on its plain forward and backward, and
    the shear warp on row_shift's plain version."""
    from dsnt_pose2d_tpu_torch.data import augment
    from dsnt_pose2d_tpu_torch.ops.cuda import dsnt_head

    def plain_bwd(raw2, t2, g_coords, g_reg, h, w, *args):
        return fused_dsnt_head_bwd_reference(
            raw2.view(-1, h, w), t2, g_coords, g_reg, *args).reshape(-1, h * w)

    monkeypatch.setattr(dsnt_head, "_launch_fwd", dsnt_head._plain_fwd)
    monkeypatch.setattr(dsnt_head, "_launch_bwd", plain_bwd)
    monkeypatch.setattr(augment, "shift_rows", shift_rows_reference)


def _vit_t16(device, remat=False):
    """ViT-T/16 with config #5's head (448 px, 56x56 maps, dsnt, no
    regularizer, bf16) from seed 0, its config and a batch of 4 synthetic
    672-px canvases."""
    from dsnt_pose2d_tpu_torch.data.synthetic import make_synthetic_mpii
    from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
    from dsnt_pose2d_tpu_torch.utils.config import Config, ModelConfig

    cfg = Config(model=ModelConfig(base="vit_t16", reg="none", remat=remat))
    model = build_pose_model(cfg.model, device=device, seed=0)
    assert model.heatmap_size == 56
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in make_synthetic_mpii(4, 672, seed=0).items()}
    return cfg, model, batch


@pytest.mark.cuda
def test_vit_t16_train_step_matches_plain_path(cuda, monkeypatch):
    # Train-row tolerances of chip_smoke.py: loss rel 1e-5, grad norm rel
    # 1e-2 (cuDNN's and cuBLAS's bf16 backward sum in no fixed order).
    from dsnt_pose2d_tpu_torch.train.loop import make_train_fn

    cfg, model, batch = _vit_t16(cuda)
    start = {k: v.clone() for k, v in model.net.state_dict().items()}
    reset_launch_counts()
    got = make_train_fn(model, cfg, device=cuda)(batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert (counts["dsnt_head_fwd"], counts["dsnt_head_bwd"], counts["row_shift"]) == (1, 1, 2)
    _, plain, _ = _vit_t16(cuda)
    plain.net.load_state_dict(start)
    _plain_path(monkeypatch)
    reset_launch_counts()
    exp = make_train_fn(plain, cfg, device=cuda)(batch)
    torch.cuda.synchronize()
    assert not any(launch_counts().values())
    assert abs(got["loss"].item() - exp["loss"].item()) <= 1e-5 * abs(exp["loss"].item())
    assert abs(got["grad_norm"].item() - exp["grad_norm"].item()) <= (
        1e-2 * exp["grad_norm"].item())


@pytest.mark.cuda
def test_vit_t16_eval_step_matches_plain_path(cuda, monkeypatch):
    # Serve-row tolerances: loss rel 1e-5, pred_orig within 0.01 px.
    from dsnt_pose2d_tpu_torch.train.loop import make_eval_fn

    cfg, model, batch = _vit_t16(cuda)
    step = make_eval_fn(model, cfg, device=cuda)
    reset_launch_counts()
    got = step(batch)
    torch.cuda.synchronize()
    # The head twice (the loss, the decode), row_shift twice (the warp).
    assert (launch_counts()["dsnt_head_fwd"], launch_counts()["row_shift"]) == (2, 2)
    _plain_path(monkeypatch)
    exp = step(batch)
    assert abs(got["loss"].item() - exp["loss"].item()) <= 1e-5 * abs(exp["loss"].item())
    assert (got["pred_orig"] - exp["pred_orig"]).abs().max().item() <= 1e-2
    assert torch.equal(got["pckh_correct"], exp["pckh_correct"])


@pytest.mark.cuda
def test_vit_t16_remat_step_matches_no_remat(cuda, monkeypatch):
    # The same weights and draws with each block recomputed in the
    # backward pass: the same loss, and grad norms within the train row's
    # 1e-2.
    from dsnt_pose2d_tpu_torch.train.loop import make_train_fn

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    out = {}
    for remat in (False, True):
        cfg, model, batch = _vit_t16(cuda, remat)
        out[remat] = make_train_fn(model, cfg, device=cuda)(batch)
    assert torch.equal(out[True]["loss"], out[False]["loss"])
    assert abs(out[True]["grad_norm"].item() - out[False]["grad_norm"].item()) <= (
        1e-2 * out[False]["grad_norm"].item())


# -- train-mode BatchNorm (+ReLU) ---------------------------------------------

# The main path's shapes: hg8 at batch 32 (256 and 128 channels, maps 64x64
# down to 4x4), ResNet-50 2x (the stem's 64 x 224x224, the last stage's 2048
# x 56x56), the resolution grid's 7x7 and 28x28, and HRNet-W48's four
# branches (48 x 64x64 down to 384 x 8x8); each in both layouts
# the convs hand it: NCHW on the train step (its images reach the stem conv
# transposed in memory), channels-last from an NHWC image batch.
BN_SHAPES = [(32, 256, 64, 64), (32, 128, 64, 64), (32, 256, 32, 32),
             (32, 256, 16, 16), (32, 256, 8, 8), (32, 256, 4, 4),
             (32, 64, 224, 224), (32, 2048, 56, 56), (32, 512, 7, 7),
             (32, 256, 28, 28), (32, 48, 64, 64), (32, 96, 32, 32),
             (32, 192, 16, 16), (32, 384, 8, 8)]
BN_LAYOUTS = {"channels_last": torch.channels_last, "nchw": torch.contiguous_format}


def _bn_inputs(shape, dtype, memory_format, seed, device):
    """x with a per-channel scale s in [0.5, 2] and offset ~ N(0, (s/2)^2)
    (E[x^2] - E[x]^2 cancels in part, as in a trained net, with E[x]^2 / var
    at most ~2 at 3 sigma), one constant channel (the variance's clamp), an
    upstream gradient, and fp32 parameters and running statistics."""
    g = torch.Generator(device=device).manual_seed(seed)
    n, c, h, w = shape
    x = torch.randn(shape, generator=g, device=device)
    s = torch.rand(c, 1, 1, generator=g, device=device) * 1.5 + 0.5
    x = (x + torch.randn(c, 1, 1, generator=g, device=device) * 0.5) * s
    x[:, 1] = 0.75
    x = x.to(dtype).contiguous(memory_format=memory_format)
    dy = torch.randn(shape, generator=g, device=device).to(dtype).contiguous(
        memory_format=memory_format)
    params = [torch.rand(c, generator=g, device=device) + 0.5,
              torch.randn(c, generator=g, device=device) * 0.1,
              torch.randn(c, generator=g, device=device),
              torch.rand(c, generator=g, device=device) + 0.5]
    return x, dy, params


def _bn_run(fn, x, dy, params, relu, grad_mask=None):
    """y, the running statistics and (dx, dweight, dbias) of one call of
    ``fn`` from copies of the parameters; ``grad_mask`` multiplies dy."""
    w, b, rm, rv = (p.clone() for p in params)
    w.requires_grad_(True)
    b.requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    y = fn(xg, w, b, rm, rv, relu=relu)
    y.backward(dy if grad_mask is None else dy * grad_mask)
    return y.detach(), rm, rv, xg.grad, w.grad, b.grad


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", sorted(BN_LAYOUTS))
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_bn_kernel_matches_plain(cuda, shape, layout, dtype, relu):
    # Tolerances.  The kernels and the plain composition sum each channel's
    # n values in fp32 in other orders, which moves a sum by ~1e-6 of the
    # sum of its terms' magnitudes (held at 1e-4 for sums of up to 1.6 M
    # terms); the fast variance E[x^2] - E[x]^2 carries that to var and
    # rstd scaled by E[x^2] / var (~3 here), and y and dx by as much,
    # relative (1e-5 of a value, 1e-4 of the largest).  In bf16, y and dx
    # are then rounded: a value near a rounding boundary lands one ulp
    # apart, up to 2**-7 of it at the bottom of a binade.  The plain
    # path's ReLU mask is taken from the kernel's output, so an element
    # whose y lies within a rounding error of 0 is masked alike.
    from dsnt_pose2d_tpu_torch.ops.cuda import batch_norm as bn

    x, dy, params = _bn_inputs(shape, dtype, BN_LAYOUTS[layout], 7, cuda)
    reset_launch_counts()
    got = _bn_run(bn.batch_norm_train, x, dy, params, relu)
    torch.cuda.synchronize()
    assert (launch_counts()["bn_fwd"], launch_counts()["bn_bwd"]) == (1, 1)
    mask = (got[0] > 0).to(dtype) if relu else None
    exp = _bn_run(bn.batch_norm_train_reference, x, dy, params, False, mask)
    if relu:
        exp = (torch.relu(exp[0]), *exp[1:])
    assert got[0].stride() == x.stride() and got[3].stride() == x.stride()
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    for name, a, e in (("y", got[0], exp[0]), ("dx", got[3], exp[3])):
        a, e = a.float(), e.float()
        err = (a - e).abs()
        lim = ulp * e.abs() + 1e-4 * e.abs().max()
        assert (err <= lim).all(), (name, err.max().item(), (err > lim).sum().item())
    xf = x.double()
    n = xf.numel() // shape[1]
    dims = (0, 2, 3)
    mean = xf.mean(dims)
    var = ((xf * xf).mean(dims) - mean * mean).clamp_min(0)
    old = [p.double() for p in params[2:]]
    scale = [(xf.abs().sum(dims) / n).clamp_min(1e-30),
             ((xf * xf).sum(dims) / n).clamp_min(1e-30)]
    for k, (r, stat) in enumerate(zip(got[1:3], (mean, var))):
        want = 0.9 * old[k] + 0.1 * stat
        assert ((r.double() - want).abs() <= 1e-4 * 0.1 * scale[k] + 1e-6 * want.abs()).all()
    g = dy.double() * (mask.double() if relu else 1.0)
    rstd = torch.rsqrt(var + 1e-5)
    xhat = (xf - mean[:, None, None]) * rstd[:, None, None]
    for a, e, terms in ((got[5], exp[5], g.abs().sum(dims)),
                        (got[4], exp[4], (g * xhat).abs().sum(dims))):
        assert ((a.double() - e.double()).abs() <= 1e-4 * terms + 1e-6).all()


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(32, 256, 64, 64), (32, 64, 224, 224), (32, 2048, 56, 56)])
def test_bn_kernel_bitwise_repeat(cuda, shape, relu):
    # Cross-block sums are added in a fixed order (no float atomics).
    from dsnt_pose2d_tpu_torch.ops.cuda import batch_norm as bn

    x, dy, params = _bn_inputs(shape, torch.bfloat16, torch.channels_last, 3, cuda)
    first = _bn_run(bn.batch_norm_train, x, dy, params, relu)
    again = _bn_run(bn.batch_norm_train, x, dy, params, relu)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 256, 64, 64), (32, 256, 4, 4), (32, 2048, 56, 56)])
@pytest.mark.parametrize("layout", sorted(BN_LAYOUTS))
def test_bn_kernel_launches_two_and_two(cuda, shape, layout):
    # Two kernels forward (statistics, normalise) and two backward (the
    # gradient's sums, dx), and no other device work but the counters'
    # one-time fill.
    from torch.profiler import ProfilerActivity, profile

    from dsnt_pose2d_tpu_torch.ops.cuda import batch_norm as bn

    x, dy, params = _bn_inputs(shape, torch.bfloat16, BN_LAYOUTS[layout], 5, cuda)
    _bn_run(bn.batch_norm_train, x, dy, params, True)     # the counters exist
    w, b, rm, rv = (p.clone() for p in params)
    w.requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = bn.batch_norm_train(xg, w, b, rm, rv, relu=True)
        y.backward(dy)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names, "the profiler saw no device activity"
    kernels = [n for n in names if not n.startswith(("Memcpy", "Memset"))]
    want = ["bn_stats_kernel", "bn_fwd_kernel", "bn_dstats_kernel", "bn_bwd_kernel"]
    assert [[k for k in want if re.search(rf"\b{k}\b", n)] for n in kernels] == [
        [k] for k in want], kernels


@pytest.mark.cuda
def test_bn_kernel_refuses_what_it_does_not_take(cuda):
    from dsnt_pose2d_tpu_torch.ops.cuda import batch_norm as bn

    c = 4
    params = [torch.ones(c, device=cuda), torch.zeros(c, device=cuda),
              torch.zeros(c, device=cuda), torch.ones(c, device=cuda)]
    with pytest.raises(ValueError, match="fp32, bf16 or fp16"):
        bn.batch_norm_train(torch.ones(2, c, 3, 3, dtype=torch.float64, device=cuda),
                            *[p.double() for p in params])
    with pytest.raises(ValueError, match="fp32"):
        bn.batch_norm_train(torch.ones(2, c, 3, 3, device=cuda), params[0].double(),
                            *params[1:])
    with pytest.raises(ValueError, match=r"\(N, C, H, W\)"):
        bn.batch_norm_train(torch.ones(2, c, 9, device=cuda), *params)
