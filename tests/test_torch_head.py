"""The port's fused DSNT head and row shift against the JAX package.

CPU: ``fused_dsnt_head_reference`` / ``shift_rows_reference`` (what CPU
tensors run) against the JAX Pallas kernels in interpret mode, at the JAX
package's own bars (``tests/test_pallas.py``): coords atol 2e-6, reg rtol
1e-5 / atol 1e-5, row shift atol 1e-6.  The dsnt head strategy
(``pose_loss``/``decode_coords``) is held against the JAX one on both its
kernel and plain paths.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsnt_pose2d_tpu.models.heads import PoseOutput
from dsnt_pose2d_tpu.models.heads import decode_coords as j_decode
from dsnt_pose2d_tpu.models.heads import pose_loss as j_pose_loss
from dsnt_pose2d_tpu.ops.pallas import fused_dsnt_head as j_fused
from dsnt_pose2d_tpu.ops.pallas.row_shift import shift_rows as j_shift_rows
from dsnt_pose2d_tpu.utils.config import ModelConfig as JModelConfig
from dsnt_pose2d_tpu_torch.models import heads as t_heads
from dsnt_pose2d_tpu_torch.ops.cuda import (fused_dsnt_head,
                                            fused_dsnt_head_reference,
                                            launch_counts, reset_launch_counts,
                                            shift_rows, shift_rows_reference)
from dsnt_pose2d_tpu_torch.utils.config import ModelConfig as TModelConfig

REGS = ["none", "js", "kl", "mse", "var"]
PREACTS = ["softmax", "thresholded_softmax"]


def _heads_data(shape=(3, 4, 16, 16), seed=7):
    rng = np.random.default_rng(seed)
    raw = (rng.normal(size=shape) * 3).astype(np.float32)
    raw.reshape(-1, shape[-2] * shape[-1])[0] *= 40.0   # underflowing row
    t = rng.uniform(-0.8, 0.8, size=(*shape[:-2], 2)).astype(np.float32)
    return raw, t


def _compare_head(raw, t, reg, preact, sigma=1.0, threshold=0.0):
    tt = None if t is None else torch.from_numpy(t)
    jt = None if t is None else jnp.asarray(t)
    got_c, got_r = fused_dsnt_head_reference(
        torch.from_numpy(raw), tt, sigma_px=sigma, reg=reg, preact=preact,
        threshold=threshold)
    exp_c, exp_r = j_fused(jnp.asarray(raw), jt, sigma_px=sigma, reg=reg,
                           preact=preact, threshold=threshold)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(exp_c), atol=2e-6)
    assert (got_r is None) == (exp_r is None)
    if exp_r is not None:
        np.testing.assert_allclose(got_r.numpy(), np.asarray(exp_r),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("preact", PREACTS)
@pytest.mark.parametrize("reg", REGS)
def test_head_reference_matches_jax(reg, preact):
    raw, t = _heads_data()
    _compare_head(raw, t, reg, preact)


@pytest.mark.parametrize("reg", REGS)
def test_head_reference_no_targets(reg):
    raw, _ = _heads_data(seed=8)
    _compare_head(raw, None, reg, "softmax")


@pytest.mark.parametrize("reg", ["js", "var"])
def test_head_reference_nonaligned(reg):
    raw, t = _heads_data(shape=(5, 7, 9), seed=3)
    _compare_head(raw, t, reg, "softmax", sigma=0.7)


@pytest.mark.parametrize("threshold", [-1.0, 0.5, 50.0])
def test_head_reference_threshold(threshold):
    # 50 is above every logit but the scaled row's: most rows fall back.
    raw, t = _heads_data(seed=9)
    _compare_head(raw, t, "js", "thresholded_softmax", threshold=threshold)


def test_head_cpu_tensor_runs_plain_version():
    raw, t = _heads_data(seed=10)
    reset_launch_counts()
    got = fused_dsnt_head(torch.from_numpy(raw), torch.from_numpy(t), reg="kl")
    exp = fused_dsnt_head_reference(torch.from_numpy(raw), torch.from_numpy(t),
                                    reg="kl")
    assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])
    assert not any(launch_counts().values()), launch_counts()


def test_head_rejects_bad_modes():
    raw = torch.zeros((2, 4, 4))
    with pytest.raises(ValueError, match="not fused"):
        fused_dsnt_head(raw, None, reg="js", preact="relu")
    with pytest.raises(ValueError, match="unknown reg"):
        fused_dsnt_head(raw, None, reg="l2")


@pytest.mark.parametrize("shape", [(64, 328, 210), (48, 146, 64),
                                   (256, 1288, 836), (16, 512, 300)])
@pytest.mark.parametrize("impl", ["vec", "legacy"])
def test_shift_rows_reference_matches_jax(shape, impl):
    r, length, out = shape
    rng = np.random.default_rng(r + length)
    rows = rng.uniform(size=(r, length)).astype(np.float32)
    starts = rng.integers(0, length - out - 1, size=(r,)).astype(np.int32)
    fracs = rng.uniform(size=(r,)).astype(np.float32)
    got = shift_rows_reference(torch.from_numpy(rows), torch.from_numpy(starts),
                               torch.from_numpy(fracs), out, impl=impl)
    exp = j_shift_rows(jnp.asarray(rows), jnp.asarray(starts),
                       jnp.asarray(fracs), out, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-6)


def test_shift_rows_reference_strided_matches_jax():
    r, lpx, outpx, c = 24, 50, 30, 3
    rng = np.random.default_rng(9)
    rows = rng.uniform(size=(r, lpx * c)).astype(np.float32)
    starts = (rng.integers(0, lpx - outpx - 1, size=(r,)) * c).astype(np.int32)
    fracs = rng.uniform(size=(r,)).astype(np.float32)
    got = shift_rows(torch.from_numpy(rows), torch.from_numpy(starts),
                     torch.from_numpy(fracs), outpx * c, stride=c)
    exp = j_shift_rows(jnp.asarray(rows), jnp.asarray(starts),
                       jnp.asarray(fracs), outpx * c, stride=c)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-6)


def test_shift_rows_reference_masks_out_of_row_taps():
    rows = torch.arange(1.0, 11.0).reshape(2, 5)
    out = shift_rows_reference(rows, torch.tensor([-1, 3], dtype=torch.int32),
                               torch.tensor([0.5, 0.5]), 3)
    np.testing.assert_allclose(out.numpy(), [[0.5, 1.5, 2.5], [9.5, 5.0, 0.0]])


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("reg", ["js", "var", "none"])
def test_pose_loss_and_decode_match_jax(use_pallas, reg):
    rng = np.random.default_rng(23)
    raw = (rng.normal(size=(2, 3, 4, 8, 8)) * 3).astype(np.float32)
    t = rng.uniform(-0.5, 0.5, size=(3, 4, 2)).astype(np.float32)
    mask = (rng.uniform(size=(3, 4)) > 0.3).astype(np.float32)
    kw = dict(base="hg2", reg=reg, reg_coeff=0.7, use_pallas=use_pallas)
    jl, jaux = j_pose_loss(PoseOutput(heatmaps=jnp.asarray(raw)),
                           jnp.asarray(t), jnp.asarray(mask), JModelConfig(**kw))
    tl, taux = t_heads.pose_loss(t_heads.PoseOutput(torch.from_numpy(raw)),
                                 torch.from_numpy(t), torch.from_numpy(mask),
                                 TModelConfig(**kw))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6)
    for k in ("coords", "euclidean", "reg"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]),
                                   rtol=1e-5, atol=2e-6)
    jc = j_decode(PoseOutput(heatmaps=jnp.asarray(raw)), JModelConfig(**kw))
    tc = t_heads.decode_coords(t_heads.PoseOutput(torch.from_numpy(raw)),
                               TModelConfig(**kw))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)


def test_cuda_head_gate_warns_on_bypass():
    with pytest.warns(UserWarning, match="not fused"):
        assert not t_heads.use_cuda_head(TModelConfig(preact="relu",
                                                      use_pallas=True))
    assert t_heads.use_cuda_head(TModelConfig(preact="thresholded_softmax"))
    assert not t_heads.use_cuda_head(TModelConfig(use_pallas=False))
