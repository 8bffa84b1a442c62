"""RMSProp with momentum: the port's optimizer chain against optax's.

``optax.rmsprop(..., momentum=m)`` traces the lr-scaled update, so under a
schedule that changes the learning rate its trajectory parts from torch's
RMSprop (which traces the unscaled one).  The port's
:class:`~dsnt_pose2d_tpu_torch.train.state.RMSpropTrace` follows optax:

- in fp64, the JAX package's ``make_optimizer`` and the port's chain give
  the same parameters within 1e-12 over 6 steps of a ``step`` schedule whose
  drop falls at step 3, with weight decay and the clip each on and off;
- under ``schedule="constant"`` it agrees with ``torch.optim.RMSprop`` too;
- a checkpoint saved mid-run and restored into a fresh train step resumes
  bitwise, across the schedule's drop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dsnt_pose2d_tpu.train.state import make_optimizer as j_make_optimizer
from dsnt_pose2d_tpu.utils.config import OptimConfig as JOptimConfig
from dsnt_pose2d_tpu_torch.data.synthetic import make_synthetic_mpii
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
from dsnt_pose2d_tpu_torch.train import checkpoint as tckpt
from dsnt_pose2d_tpu_torch.train.loop import make_train_fn
from dsnt_pose2d_tpu_torch.train.state import (OptimizerChain, RMSpropTrace,
                                               make_lr_schedule, make_optimizer)
from dsnt_pose2d_tpu_torch.utils import config as tconfig
from dsnt_pose2d_tpu_torch.utils.config import OptimConfig

torch.set_num_threads(1)

SHAPES = {"w": (3, 4), "b": (4,), "k": (2, 2, 3)}
GRAD_SCALES = (30.0, 0.05, 3.0, 0.01, 10.0, 0.5)   # around the clip norm 1
MOMENTUM = dict(momentum=0.9, lr=1e-2, lr_drop_epochs=(3,), lr_drop_factor=0.1)


def _grads(rng):
    return [{n: rng.normal(size=s) * scale / 4 for n, s in SHAPES.items()}
            for scale in GRAD_SCALES]


def _port_trajectory(p0, grads, chain_of):
    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for n, v in p0.items()}
    chain = chain_of(list(params.values()))
    out = []
    for g in grads:
        for n, p in params.items():
            p.grad = torch.from_numpy(g[n].copy())
        chain.step()
        out.append({n: p.detach().numpy().copy() for n, p in params.items()})
    return chain, out


@pytest.mark.parametrize("schedule", ["step", "constant"])
@pytest.mark.parametrize("clip", [0.0, 1.0], ids=["noclip", "clip"])
@pytest.mark.parametrize("wd", [0.0, 1e-2], ids=["nowd", "wd"])
def test_rmsprop_momentum_matches_optax_in_fp64(schedule, clip, wd):
    kw = dict(MOMENTUM, schedule=schedule, grad_clip_norm=clip,
              weight_decay=wd)
    rng = np.random.default_rng(5)
    p0 = {n: rng.normal(size=s) for n, s in SHAPES.items()}
    grads = _grads(rng)
    with jax.enable_x64(True):
        tx = j_make_optimizer(JOptimConfig(**kw), steps_per_epoch=1, epochs=6)
        params_j = jax.tree_util.tree_map(jnp.asarray, p0)
        opt_state = tx.init(params_j)
        expected = []
        for g in grads:
            updates, opt_state = tx.update(
                jax.tree_util.tree_map(jnp.asarray, g), opt_state, params_j)
            params_j = optax.apply_updates(params_j, updates)
            expected.append({n: np.asarray(v) for n, v in params_j.items()})
        assert params_j["w"].dtype == jnp.float64

    chain, got = _port_trajectory(p0, grads, lambda ps: make_optimizer(
        ps, OptimConfig(**kw), steps_per_epoch=1, epochs=6))
    assert isinstance(chain.optimizer, RMSpropTrace)
    lrs = [make_lr_schedule(OptimConfig(**kw), 1, 6)(s) for s in range(6)]
    assert (lrs[2] > lrs[3]) == (schedule == "step")   # the drop, inside 6 steps
    for t, (g, e) in enumerate(zip(got, expected)):
        for n in SHAPES:
            np.testing.assert_allclose(g[n], e[n], rtol=0, atol=1e-12,
                                       err_msg=f"{n} after step {t + 1}")
    assert chain.count == len(GRAD_SCALES)


@pytest.mark.parametrize("clip", [0.0, 1.0], ids=["noclip", "clip"])
@pytest.mark.parametrize("wd", [0.0, 1e-2], ids=["nowd", "wd"])
def test_rmsprop_momentum_constant_lr_agrees_with_torch_rmsprop(clip, wd):
    cfg = OptimConfig(**MOMENTUM, schedule="constant", grad_clip_norm=clip,
                      weight_decay=wd)
    rng = np.random.default_rng(6)
    p0 = {n: rng.normal(size=s) for n, s in SHAPES.items()}
    grads = _grads(rng)
    _, got = _port_trajectory(p0, grads, lambda ps: make_optimizer(ps, cfg))

    def torch_chain(ps):
        opt = torch.optim.RMSprop(ps, lr=cfg.lr, alpha=cfg.rmsprop_decay,
                                  eps=cfg.eps, momentum=cfg.momentum,
                                  weight_decay=cfg.weight_decay)
        return OptimizerChain(ps, opt, lambda step: cfg.lr, cfg.grad_clip_norm)

    _, expected = _port_trajectory(p0, grads, torch_chain)
    for g, e in zip(got, expected):
        for n in SHAPES:
            np.testing.assert_allclose(g[n], e[n], rtol=0, atol=1e-12)


CFG = tconfig.Config(
    model=tconfig.ModelConfig(base="hg1", hg_features=16, hg_depth=2,
                              input_size=32, dtype="float32", reg="js",
                              use_pallas=False),
    optim=tconfig.OptimConfig(lr=2e-3, momentum=0.9, lr_drop_epochs=(1,),
                              schedule="step"),
    train=tconfig.TrainConfig(batch_size=4, seed=7, epochs=2))


def _step(seed):
    model = build_pose_model(CFG.model, device="cpu", seed=seed)
    return make_train_fn(model, CFG, device="cpu", steps_per_epoch=2)


def test_momentum_state_resumes_bitwise_from_a_checkpoint(tmp_path):
    batches = [make_synthetic_mpii(4, 48, seed=s) for s in range(4)]
    run = _step(seed=0)
    assert isinstance(run.state.optimizer.optimizer, RMSpropTrace)
    for b in batches[:1]:
        run(b)
    mgr = tckpt.CheckpointManager(str(tmp_path), CFG)
    mgr.save_step(run.state, epoch=0, step_in_epoch=1)

    resumed = _step(seed=1)
    state, meta = mgr.restore_latest(resumed.state)
    assert state is resumed.state and meta["step"] == 1
    opt_a = run.state.optimizer.optimizer.state_dict()["state"]
    opt_b = resumed.state.optimizer.optimizer.state_dict()["state"]
    assert len(opt_a) > 10 and all(
        set(v) == {"square_avg", "momentum_buffer"} for v in opt_b.values())
    # Steps 2-4 cross the schedule's drop (at count 2).
    for b in batches[1:]:
        assert torch.equal(run(b)["loss"], resumed(b)["loss"])
    sa, sb = run.state.model.net.state_dict(), resumed.state.model.net.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    opt_a = run.state.optimizer.optimizer.state_dict()["state"]
    opt_b = resumed.state.optimizer.optimizer.state_dict()["state"]
    for i in opt_a:
        for k, v in opt_a[i].items():
            assert torch.equal(v, opt_b[i][k]), (i, k)
    assert run.state.optimizer.count == resumed.state.optimizer.count == 4
    assert resumed.state.optimizer.optimizer.param_groups[0]["lr"] == \
        pytest.approx(2e-4)
