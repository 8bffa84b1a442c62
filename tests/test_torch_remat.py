"""Remat (``models/hourglass.py::remat``): each hourglass stack and each
ViT block recomputed in the backward pass in training.

On the CPU the port with remat is held BITWISE to the port without it in
fp64 (loss, every gradient, and the BN running statistics after one and
after two steps: the recompute must not move them a second time), and in
bf16, where the recompute must run under the forward's autocast; then the
port's hourglass with remat against flax's ``nn.remat`` hourglass, one fp64
train step at ``tests/test_torch_train_step.py``'s tolerances (loss rtol
1e-8, grads rtol 1e-6, parameters and BN statistics rtol 1e-10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsnt_pose2d_tpu import ops as jops
from dsnt_pose2d_tpu_torch import ops as tops
from dsnt_pose2d_tpu_torch.models import hourglass
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
from dsnt_pose2d_tpu_torch.train.state import make_optimizer
from dsnt_pose2d_tpu_torch.utils.config import ModelConfig, OptimConfig
from port_helpers import fp64_train_step

J, SIZE = 16, 64
# hg2 with depth-2 hourglasses: 60 BNs (stem 10, each stack 25).
MODELS = {"hg2": dict(base="hg2", hg_features=16, hg_depth=2),
          "vit_t16": dict(base="vit_t16")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _loss(heatmaps, t, mask):
    coords = tops.dsnt(tops.flat_softmax(heatmaps.double()))
    per_joint = tops.euclidean_losses(coords, t[None].expand_as(coords))
    m = mask[None].expand_as(per_joint)
    return ((per_joint * m).sum(dim=(1, 2)) / m.sum(dim=(1, 2)).clamp_min(1.0)).sum()


def _run(name, remat, dtype, steps, seed=0):
    """``steps`` RMSProp train steps of the port's model with or without
    remat, from the seed's weights, on the seed's batches; the loss, the
    gradients and the BN running statistics after each step."""
    kw = dict(MODELS[name], input_size=SIZE, remat=remat,
              dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    model = build_pose_model(ModelConfig(**kw), device="cpu", seed=seed)
    net = model.net
    if dtype == torch.float64:
        net.double()
        net.backbone.dtype = torch.float64
    net.train()
    opt = make_optimizer(net.parameters(), OptimConfig(lr=1e-3))
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        x = torch.from_numpy(rng.normal(size=(2, SIZE, SIZE, 3)) * 0.5).to(
            torch.float64 if dtype == torch.float64 else torch.float32)
        t = torch.from_numpy(rng.uniform(-0.7, 0.7, size=(2, J, 2)))
        mask = torch.from_numpy((rng.uniform(size=(2, J)) > 0.2).astype(np.float64))
        loss = _loss(net(x).heatmaps, t, mask)
        opt.zero_grad()
        loss.backward()
        grads = {n: p.grad.clone() for n, p in net.named_parameters()}
        opt.step()
        stats = {k: v.clone() for k, v in net.state_dict().items() if "running" in k}
        out.append((loss.detach().clone(), grads, stats))
    return out


def _assert_bitwise(a, b):
    for (loss_a, grads_a, stats_a), (loss_b, grads_b, stats_b) in zip(a, b):
        assert torch.equal(loss_a, loss_b)
        assert grads_a.keys() == grads_b.keys()
        for k in grads_a:
            assert torch.equal(grads_a[k], grads_b[k]), k
        assert stats_a.keys() == stats_b.keys()
        for k in stats_a:
            assert torch.equal(stats_a[k], stats_b[k]), k


@pytest.mark.parametrize("name", list(MODELS))
def test_remat_is_bitwise_fp64(name):
    on, off = _run(name, True, torch.float64, 2), _run(name, False, torch.float64, 2)
    _assert_bitwise(on, off)
    stats = on[0][2]
    if name == "hg2":
        # The statistics moved (from mean 0, var 1), once a step as without
        # remat, after one and after two steps.
        key = "backbone.hg0.up1_d2.bn1.running_mean"
        assert len(stats) == 2 * 60 and not torch.equal(on[0][2][key], on[1][2][key])
        assert all(not torch.all(v == (1.0 if k.endswith("var") else 0.0))
                   for k, v in stats.items())
    else:
        assert not stats


def test_remat_bf16_keeps_autocast_in_the_recompute():
    # Non-reentrant checkpointing restores the forward's autocast in the
    # recompute: a recompute in fp32 would give other saved tensors (and
    # the checkpoint's metadata check would fail).
    _assert_bitwise(_run("hg2", True, torch.bfloat16, 1),
                    _run("hg2", False, torch.bfloat16, 1))


def test_remat_recomputes_and_moves_bn_once(monkeypatch):
    calls = {"forward": 0, "update": 0}
    forward, train_bn = hourglass.BatchNorm.forward, hourglass.bn_ops.batch_norm_train

    def counting_forward(self, x):
        calls["forward"] += 1
        return forward(self, x)

    def counting_train_bn(*args, update_running=True, **kw):
        calls["update"] += update_running
        return train_bn(*args, update_running=update_running, **kw)

    monkeypatch.setattr(hourglass.BatchNorm, "forward", counting_forward)
    monkeypatch.setattr(hourglass.bn_ops, "batch_norm_train", counting_train_bn)
    counts = {}
    for remat in (False, True):
        calls.update(forward=0, update=0)
        _run("hg2", remat, torch.float64, 1)
        counts[remat] = dict(calls)
    # Each stack's BNs run again in the backward pass, and move nothing there.
    assert counts[True]["forward"] > counts[False]["forward"]
    assert counts[True]["update"] == counts[False]["update"] == counts[False]["forward"]


def _jax_dsnt(output, t, mask, cfg):
    coords = jops.dsnt(jops.flat_softmax(output.heatmaps))
    per_joint = jops.euclidean_losses(coords, jnp.broadcast_to(t[None], coords.shape))
    m = jnp.broadcast_to(mask[None], per_joint.shape)
    return jnp.sum(jnp.sum(per_joint * m, axis=(1, 2))
                   / jnp.maximum(jnp.sum(m, axis=(1, 2)), 1.0)), {}


def _port_dsnt(output, t, mask, cfg):
    return _loss(output.heatmaps, t, mask), {}


@pytest.fixture(scope="module")
def remat_step():
    return fp64_train_step(dict(MODELS["hg2"], input_size=SIZE, remat=True),
                           (_jax_dsnt, _port_dsnt))


def test_hourglass_remat_step_matches_flax_remat(remat_step):
    got, exp = remat_step
    np.testing.assert_allclose(got.loss, exp.loss, rtol=1e-8)
    gmax = max(np.abs(exp.grads[n]).max() for n in got.grads)
    assert set(got.grads) <= set(exp.grads) and len(got.grads) > 100
    for name, g in got.grads.items():
        np.testing.assert_allclose(g, exp.grads[name], rtol=1e-6,
                                   atol=1e-9 * gmax, err_msg=name)


def test_hourglass_remat_step_params_and_stats_match_flax(remat_step):
    got, exp = remat_step
    for name in got.grads:
        np.testing.assert_allclose(got.after[name], exp.after[name],
                                   rtol=1e-10, atol=2e-9, err_msg=name)
    keys = [k for k in exp.after if "running" in k]
    assert len(keys) == 2 * 60
    for k in keys:
        np.testing.assert_allclose(got.after[k], exp.after[k], rtol=1e-10,
                                   atol=1e-12, err_msg=k)
