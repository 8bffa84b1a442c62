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
order than torch.softmax).
"""

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


# 64x64 (hourglass at 256 px), 56x56 (ResNet-50 dilate 2 at 448 px: the
# forward's AnyMap, the backward's StagedRow), and 8x8 to 32x32 (the
# resolution ablation's ResNet maps at 256 px).
HEAD_SHAPES = [(2, 3, 64, 64), (5, 7, 9), (2, 3, 56, 56), (4, 8, 8),
               (4, 16, 16), (4, 32, 32)]


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


ADVERSARIAL_CASES = ["64x64", "64x64_unaligned", "7x9", "max_hw"]


def _adversarial_case(case, device):
    """The adversarial rows in the map and alignment of ``case``."""
    h, w = {"64x64": (64, 64), "64x64_unaligned": (64, 64), "7x9": (7, 9),
            "max_hw": (128, MAX_HW // 128)}[case]
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


# The 64x64 layout, 64x64 at a base off the 16-byte grid, a small and a
# MAX_HW generic map.
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


# The backward on the same rows: Map64 takes the aligned 64x64 case, the
# staged-row layout the others.
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
# contract's form of the Gaussian in the 64x64 layout.
@pytest.mark.cuda
@pytest.mark.parametrize("reg", ["js", "kl", "mse"])
def test_head_bwd_kernel_off_grid_targets(cuda, reg):
    g = torch.Generator().manual_seed(5)
    raw = (torch.randn((256, 64, 64), generator=g) * 3.0).to(cuda)
    t = (torch.rand((256, 2), generator=g) * 2.4 - 1.2).to(cuda)
    gc = torch.randn((256, 2), generator=g).to(cuda)
    gr = torch.randn((256,), generator=g).to(cuda)
    got = fused_dsnt_head_bwd(raw, t, gc, gr, sigma_px=0.7, reg=reg)
    exp = fused_dsnt_head_bwd_reference(raw, t, gc, gr, sigma_px=0.7, reg=reg)
    torch.cuda.synchronize()
    _assert_dh_close(got, exp)


# Sums in a fixed order: two launches on the same inputs give the same bits.
@pytest.mark.cuda
@pytest.mark.parametrize("reg", REG_KINDS)
@pytest.mark.parametrize("shape", [(1024, 64, 64), (300, 7, 9)])
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
