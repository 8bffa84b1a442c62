"""Parts of the port's train step against the JAX package, on the CPU.

**Train-mode BN.**  The port's hourglass in train mode against flax
``apply(train=True, mutable=["batch_stats"])`` on the same weights and
images: heatmaps and the updated batch statistics.  fp64 (``jax.enable_x64``)
is the test of the semantics (fast variance, biased running-variance
update, momentum 0.9): heatmaps and statistics agree to 1e-10.  In fp32 the
train-mode BN of a 2-stack net amplifies accumulation-order noise (a
channel whose mean is large against its spread loses digits in
E[x^2] - E[x]^2), measured 5.7e-3 on heatmaps of magnitude 5.4, running
means 1.8e-4, running variances 2.2e-3 relative; held at 2e-3 of the
heatmaps' largest magnitude, 1e-3 and 1e-2.  bf16: each framework's bf16
heatmaps are ~1.5 from its own fp32 ones (train-mode BN renormalises the
bf16 rounding at every layer), so the port's distance from fp32 is held at
twice JAX's own, and the cross-framework distance at JAX's own; so are the
running statistics (largest distance over all BN layers).

**Optimizer.**  ``make_optimizer`` against the JAX package's optax chain on
identical fp32 gradients over 6 steps, with the step decay crossing two
drop boundaries, the clip on both sides of its threshold and weight decay:
parameters rtol 1e-6 / atol 1e-7 (the two round the learning rate and the
update's product in another order, one fp32 ulp per step), pre-clip global
norms rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dsnt_pose2d_tpu.models.hourglass import HourglassNet as JHourglassNet
from dsnt_pose2d_tpu.train.state import make_lr_schedule as j_make_lr_schedule
from dsnt_pose2d_tpu.train.state import make_optimizer as j_make_optimizer
from dsnt_pose2d_tpu.utils.config import OptimConfig as JOptimConfig
from dsnt_pose2d_tpu_torch.models.from_jax import hourglass_from_jax
from dsnt_pose2d_tpu_torch.models.hourglass import HourglassNet
from dsnt_pose2d_tpu_torch.train.state import (make_lr_schedule,
                                               make_optimizer)
from dsnt_pose2d_tpu_torch.utils.config import OptimConfig
from port_helpers import perturb

STACKS, FEATS, J, SIZE = 2, 32, 16, 64
DTYPES = {"float64": (jnp.float64, torch.float64),
          "float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(11)
    return (rng.normal(size=(4, SIZE, SIZE, 3)) * 0.5).astype(np.float32)


def _stats(state: dict) -> dict:
    return {k: np.asarray(v, np.float64) for k, v in state.items()
            if k.endswith(("running_mean", "running_var"))}


def _train_forward(dtype: str, images, variables=None):
    """(flax heatmaps, flax updated stats, port heatmaps, port updated stats)."""
    dj, dt = DTYPES[dtype]
    x = images.astype(np.float64) if dtype == "float64" else images
    flax_model = JHourglassNet(num_stacks=STACKS, num_joints=J, features=FEATS,
                               dtype=dj)
    if variables is None:
        variables = perturb(flax_model.init(jax.random.PRNGKey(3),
                                            jnp.asarray(x), train=False))
        if dtype == "float64":
            variables = jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), variables)
    hm_j, mutated = flax_model.apply(variables, jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
    stats_j = _stats(hourglass_from_jax(
        {"params": variables["params"], "batch_stats": mutated["batch_stats"]},
        STACKS))
    net = HourglassNet(num_stacks=STACKS, num_joints=J, features=FEATS, dtype=dt)
    if dtype == "float64":
        net = net.double()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in
                         hourglass_from_jax(variables, STACKS).items()},
                        strict=True)
    net.train()
    with torch.no_grad():
        hm_t = net(torch.from_numpy(x)).numpy()
    return np.asarray(hm_j), stats_j, hm_t, _stats(net.state_dict()), variables


def test_train_mode_bn_fp64_matches_flax(images):
    with jax.enable_x64(True):
        hm_j, st_j, hm_t, st_t, _ = _train_forward("float64", images)
    assert hm_t.dtype == hm_j.dtype == np.float64
    np.testing.assert_allclose(hm_t, hm_j, rtol=1e-10, atol=1e-10)
    assert st_t.keys() == st_j.keys() and len(st_t) > 100
    for k in st_j:
        np.testing.assert_allclose(st_t[k], st_j[k], rtol=1e-10, atol=1e-12,
                                   err_msg=k)


def test_train_mode_bn_fp32_matches_flax(images):
    hm_j, st_j, hm_t, st_t, _ = _train_forward("float32", images)
    np.testing.assert_allclose(hm_t, hm_j, rtol=0,
                               atol=2e-3 * np.abs(hm_j).max())
    for k in st_j:
        if k.endswith("running_mean"):
            np.testing.assert_allclose(st_t[k], st_j[k], rtol=0, atol=1e-3,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(st_t[k], st_j[k], rtol=1e-2, err_msg=k)


def test_train_mode_bn_bf16_matches_flax(images):
    hm_j, st_j, hm_t, st_t, variables = _train_forward("bfloat16", images)
    assert hm_t.dtype == hm_j.dtype == np.float32
    hm_j32, st_j32, hm_t32, st_t32, _ = _train_forward("float32", images,
                                                       variables)
    jax_err = np.abs(hm_j - hm_j32).max()
    assert np.abs(hm_t - hm_t32).max() <= 2 * jax_err
    assert np.abs(hm_t - hm_j).max() <= jax_err
    for kind in ("running_mean", "running_var"):
        keys = [k for k in st_j if k.endswith(kind)]
        jax_st_err = max(np.abs(st_j[k] - st_j32[k]).max() for k in keys)
        port_st_err = max(np.abs(st_t[k] - st_t32[k]).max() for k in keys)
        assert port_st_err <= 2 * jax_st_err, kind


@pytest.mark.parametrize("schedule", ["step", "constant", "cosine"])
def test_lr_schedule_matches_optax(schedule):
    kw = dict(schedule=schedule, lr=2.5e-4, lr_drop_epochs=(60, 90))
    got = make_lr_schedule(OptimConfig(**kw), steps_per_epoch=10, epochs=120)
    exp = j_make_lr_schedule(JOptimConfig(**kw), steps_per_epoch=10, epochs=120)
    # optax evaluates in fp32: one fp32 ulp of lr (3e-11) where cos ~ -1.
    for step in (0, 1, 599, 600, 601, 899, 900, 1199, 1200, 5000):
        np.testing.assert_allclose(got(step), float(exp(step)), rtol=1e-6,
                                   atol=3e-11, err_msg=str(step))


GRAD_SCALES = (30.0, 0.05, 3.0, 0.01, 10.0, 0.5)   # around the clip norm 1


@pytest.mark.parametrize("kw", [
    dict(),                                                   # the flagship's
    dict(grad_clip_norm=1.0, weight_decay=1e-3),
    dict(momentum=0.9, schedule="constant"),
    dict(optimizer="adam", lr=1e-3, grad_clip_norm=1.0, weight_decay=1e-4),
    dict(optimizer="sgd", lr=1e-2, momentum=0.9, schedule="cosine"),
], ids=["rmsprop", "rmsprop-clip-wd", "rmsprop-momentum", "adam-clip-wd",
        "sgd-momentum-cosine"])
def test_optimizer_trajectory_matches_optax(kw):
    kw = {"lr_drop_epochs": (1, 2), **kw}     # drops at steps 2 and 4
    rng = np.random.default_rng(3)
    shapes = {"w": (3, 4), "b": (4,), "k": (2, 2, 3)}
    p0 = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    tx = j_make_optimizer(JOptimConfig(**kw), steps_per_epoch=2, epochs=3)
    params_j = jax.tree_util.tree_map(jnp.asarray, p0)
    opt_state = tx.init(params_j)
    params_t = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
                for n, v in p0.items()}
    chain = make_optimizer(params_t.values(), OptimConfig(**kw),
                           steps_per_epoch=2, epochs=3)
    for scale in GRAD_SCALES:
        grads = {n: (rng.normal(size=s) * scale / 4).astype(np.float32)
                 for n, s in shapes.items()}
        gj = jax.tree_util.tree_map(jnp.asarray, grads)
        updates, opt_state = tx.update(gj, opt_state, params_j)
        params_j = optax.apply_updates(params_j, updates)
        for n, p in params_t.items():
            p.grad = torch.from_numpy(grads[n].copy())
        norm = chain.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(gj)),
                                   rtol=1e-6)
        for n, p in params_t.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params_j[n]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{n} at {scale}")
    assert chain.count == len(GRAD_SCALES)


def test_rmsprop_momentum_under_changing_lr_is_refused():
    # No longer refused: RMSProp with momentum traces the lr-scaled update,
    # as optax does (held in fp64 in tests/test_torch_optim_momentum.py).
    from dsnt_pose2d_tpu_torch.train.state import RMSpropTrace

    p = torch.nn.Parameter(torch.zeros(2))
    chain = make_optimizer([p], OptimConfig(momentum=0.9, schedule="step"))
    assert isinstance(chain.optimizer, RMSpropTrace)
