"""The fused DSNT head's backward against the JAX package.

CPU tensors run the port's ``torch.autograd.Function`` through its plain
forward and plain backward (``fused_dsnt_head_bwd_reference``); that is
held against ``jax.vjp`` of the JAX ``fused_dsnt_head`` (its Pallas kernels
in interpret mode, as ``tests/test_pallas.py`` runs them), with random
cotangents for coords and reg, for every reg x preact at 64 rows of 64x64
and at a non-aligned 9 rows of 7x9.  Row 0 is scaled so its probabilities
underflow to 0 and row 1 lies wholly below the threshold (the thresholded
softmax's fallback).  The plain backward is also held against
``torch.autograd`` of ``fused_dsnt_head_reference``.

Tolerance: atol 2e-6 + rtol 1e-4 on dh.  dh = z (u - <z, u>) with |u| of
order 1-10 and z <= 1; both sides compute it in fp32 in different orders
(the JAX kernel pads rows to 128 lanes, the reductions differ), so a few
ulps of |u| survive where z is near 1.  The CUDA kernel is held against the
same plain backward on the card (``tests/test_torch_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsnt_pose2d_tpu.ops.pallas import fused_dsnt_head as j_fused
from dsnt_pose2d_tpu_torch.ops.cuda import (PREACT_KINDS, REG_KINDS,
                                            fused_dsnt_head,
                                            fused_dsnt_head_bwd,
                                            fused_dsnt_head_bwd_reference,
                                            fused_dsnt_head_reference,
                                            launch_counts, reset_launch_counts)

SHAPES = [(64, 64, 64), (9, 7, 9)]
THRESHOLD, SIGMA = 0.5, 1.0
TOL = dict(atol=2e-6, rtol=1e-4)


def _data(n, h, w, seed):
    rng = np.random.default_rng(seed)
    raw = (rng.normal(size=(n, h, w)) * 3).astype(np.float32)
    raw[0] *= 40.0           # probabilities underflow to 0
    raw[1] -= 100.0          # every logit below the threshold: fallback
    t = rng.uniform(-0.8, 0.8, size=(n, 2)).astype(np.float32)
    gc = rng.normal(size=(n, 2)).astype(np.float32)
    gr = rng.normal(size=(n,)).astype(np.float32)
    return raw, t, gc, gr


def _jax_dh(raw, t, gc, gr, reg, preact):
    def f(r):
        return j_fused(r, jnp.asarray(t), sigma_px=SIGMA, reg=reg,
                       preact=preact, threshold=THRESHOLD)

    _, vjp = jax.vjp(f, jnp.asarray(raw))
    (dh,) = vjp((jnp.asarray(gc), None if reg == "none" else jnp.asarray(gr)))
    return np.asarray(dh)


def _port_dh(fn, raw, t, gc, gr, reg, preact, use=("coords", "reg")):
    x = torch.from_numpy(raw).requires_grad_(True)
    coords, regv = fn(x, torch.from_numpy(t), sigma_px=SIGMA, reg=reg,
                      preact=preact, threshold=THRESHOLD)
    outs, cts = [], []
    if "coords" in use:
        outs.append(coords)
        cts.append(torch.from_numpy(gc))
    if "reg" in use and regv is not None:
        outs.append(regv)
        cts.append(torch.from_numpy(gr))
    torch.autograd.backward(outs, cts)
    return x.grad.numpy()


@pytest.mark.parametrize("preact", PREACT_KINDS)
@pytest.mark.parametrize("reg", REG_KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_head_vjp_matches_jax(shape, reg, preact):
    raw, t, gc, gr = _data(*shape, seed=sum(shape))
    reset_launch_counts()
    got = _port_dh(fused_dsnt_head, raw, t, gc, gr, reg, preact)
    assert not any(launch_counts().values()), launch_counts()
    np.testing.assert_allclose(got, _jax_dh(raw, t, gc, gr, reg, preact), **TOL)


@pytest.mark.parametrize("preact", PREACT_KINDS)
@pytest.mark.parametrize("reg", REG_KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_bwd_matches_autograd(shape, reg, preact):
    raw, t, gc, gr = _data(*shape, seed=sum(shape) + 1)
    exp = _port_dh(fused_dsnt_head_reference, raw, t, gc, gr, reg, preact)
    got = fused_dsnt_head_bwd_reference(
        torch.from_numpy(raw), torch.from_numpy(t), torch.from_numpy(gc),
        None if reg == "none" else torch.from_numpy(gr), sigma_px=SIGMA,
        reg=reg, preact=preact, threshold=THRESHOLD)
    assert got.dtype == torch.float32 and got.shape == raw.shape
    np.testing.assert_allclose(got.numpy(), exp, **TOL)


@pytest.mark.parametrize("use", [("coords",), ("reg",)])
@pytest.mark.parametrize("reg", ["js", "var"])
def test_head_vjp_one_output_used(reg, use):
    # Only one output reaches the loss: the other's cotangent is None.
    raw, t, gc, gr = _data(6, 8, 8, seed=4)
    got = _port_dh(fused_dsnt_head, raw, t, gc, gr, reg, "softmax", use)
    exp = _port_dh(fused_dsnt_head_reference, raw, t, gc, gr, reg, "softmax",
                   use)
    np.testing.assert_allclose(got, exp, **TOL)


def test_head_function_saves_only_raw_and_targets():
    raw, t, _, _ = _data(4, 8, 8, seed=5)
    x = torch.from_numpy(raw).requires_grad_(True)
    coords, _ = fused_dsnt_head(x, torch.from_numpy(t), reg="js")
    node = coords.grad_fn.next_functions[0][0]     # past the reshape
    assert type(node).__name__ == "_FusedDsntHeadBackward"
    saved = node.saved_tensors
    assert [tuple(s.shape) for s in saved] == [(4, 64), (4, 2)]
    assert all(s.dtype == torch.float32 for s in saved)


def test_bwd_wrapper_cpu_tensor_runs_plain_version():
    raw, t, gc, gr = _data(5, 7, 9, seed=6)
    args = [torch.from_numpy(a) for a in (raw, t, gc, gr)]
    reset_launch_counts()
    got = fused_dsnt_head_bwd(*args, reg="kl", preact="thresholded_softmax",
                              threshold=THRESHOLD)
    exp = fused_dsnt_head_bwd_reference(*args, reg="kl",
                                        preact="thresholded_softmax",
                                        threshold=THRESHOLD)
    assert torch.equal(got, exp)
    assert launch_counts()["dsnt_head_bwd"] == 0
