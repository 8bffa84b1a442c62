"""The port's whole train step against the JAX package, on the CPU.

**fp64** (``jax.enable_x64``), on identical images, targets and mask: the
port's train-mode hourglass + the plain ops loss (DSNT + JS, per-stack masked
mean, summed) + backward + ``make_optimizer``'s RMSProp step, against flax +
the jnp ops + the JAX package's optax chain.  Tolerances as
``tests/test_train_parity_torch.py``: loss rtol 1e-8; every gradient rtol
1e-6 with atol 1e-9 of the largest gradient; batch statistics rtol 1e-10.
Updated parameters rtol 1e-10 / atol 2e-9: RMSProp's first update is
lr g / (0.1 |g| + eps), so where |g| is of order eps (the score-conv
biases, whose true gradient is 0) the 1e-12 gradient residue moves the
parameter by up to lr / eps times as much (measured 3.8e-10).

**fp32**, the port's ``make_train_fn`` step against the JAX package's
``_build_step_bodies(...)[0]``: hg2, 32 features, 64-px input, 96-px
synthetic canvases, batch 4, fused head on both sides (JAX: Pallas in
interpret mode; port: the autograd Function's plain versions), shear warp
with rotation, flip and jitter, the same weights, batch and draws.  Loss,
``euclidean`` and ``reg`` rtol 1e-4 (8 conv layers deep of fp32 sums in
different orders, as ``tests/test_torch_slice.py``; measured 4e-6).  Batch
statistics: running means atol 1e-3, variances rtol 1e-2, the fp32 noise of
train-mode BN measured in ``tests/test_torch_train.py``.

``grad_norm``: the JAX package's fp32 gradients on this step are 13-15%
short of their fp64 values on the stem and on hg0's pooled branches (global
norm 75.87 against 87.35 in fp64), with a cosine of 0.998 per leaf.  The
shortfall comes from flax's BN batch statistics in fp32: the fixture
recomputes the step's gradients with only those statistics in fp64, and the
global norm becomes 87.87.  The port's fp32 norm (87.57; torch's CPU
reductions sum pairwise) is held against that one at rtol 2e-2, and the
step's own metric against the recomputed fp32 norm at rtol 1e-4.

Updated parameters: RMSProp's first update is ~ -10 lr sign(g) wherever
|g| >> eps, so a parameter whose gradient sign is rounding noise may differ
by 20 lr.  Leaves whose gradient is 0 in exact arithmetic are left out; on
the rest, each leaf's norm of change is held at rtol 3% (measured <= 1.4%)
and 95% of the elements within 5% of a full step (measured 98.3%).
The exact update is held in fp64.
"""

import contextlib
from types import SimpleNamespace

import flax.linen.normalization as flax_norm
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dsnt_pose2d_tpu import ops as jops
from dsnt_pose2d_tpu.data.synthetic import make_synthetic_mpii as j_synth
from dsnt_pose2d_tpu.models.factory import build_pose_model as j_build
from dsnt_pose2d_tpu.models.hourglass import HourglassNet as JHourglassNet
from dsnt_pose2d_tpu.train import loop as jloop
from dsnt_pose2d_tpu.train.state import TrainState as JTrainState
from dsnt_pose2d_tpu.train.state import make_optimizer as j_make_optimizer
from dsnt_pose2d_tpu.utils import config as jconfig
from dsnt_pose2d_tpu_torch import ops as tops
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
from dsnt_pose2d_tpu_torch.models.from_jax import hourglass_from_jax
from dsnt_pose2d_tpu_torch.models.hourglass import HourglassNet
from dsnt_pose2d_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
from dsnt_pose2d_tpu_torch.train.loop import make_train_fn
from dsnt_pose2d_tpu_torch.train.state import make_optimizer
from dsnt_pose2d_tpu_torch.utils import config as tconfig
from port_helpers import jax_train_draws, perturb

STACKS, FEATS, J, SIZE, BATCH, SIGMA = 2, 32, 16, 64, 4, 1.0


def _masked_stack_sum(per_joint, mask):
    return ((per_joint * mask).sum(dim=(1, 2))
            / mask.sum(dim=(1, 2)).clamp_min(1.0)).sum()


@pytest.fixture(scope="module")
def fp64_step():
    rng = np.random.default_rng(31)
    x = rng.normal(size=(BATCH, SIZE, SIZE, 3)) * 0.5
    t = rng.uniform(-0.7, 0.7, size=(BATCH, J, 2))
    mask = (rng.uniform(size=(BATCH, J)) > 0.2).astype(np.float64)
    with jax.enable_x64(True):
        flax_model = JHourglassNet(num_stacks=STACKS, num_joints=J,
                                   features=FEATS, dtype=jnp.float64)
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            perturb(flax_model.init(jax.random.PRNGKey(7), jnp.asarray(x),
                                    train=False)))
        params, stats = variables["params"], variables["batch_stats"]

        def loss_fn(p):
            out, mutated = flax_model.apply(
                {"params": p, "batch_stats": stats}, jnp.asarray(x),
                train=True, mutable=["batch_stats"])
            z = jops.flat_softmax(out)
            coords = jops.dsnt(z)
            tb = jnp.broadcast_to(jnp.asarray(t)[None], coords.shape)
            per_joint = (jops.euclidean_losses(coords, tb)
                         + jops.js_reg_losses(z, tb, SIGMA))
            m = jnp.broadcast_to(jnp.asarray(mask)[None], per_joint.shape)
            loss = jnp.sum(jnp.sum(per_joint * m, axis=(1, 2))
                           / jnp.maximum(jnp.sum(m, axis=(1, 2)), 1.0))
            return loss, mutated["batch_stats"]

        (loss_j, stats_j), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
        tx = j_make_optimizer(jconfig.OptimConfig())
        updates, _ = tx.update(grads, tx.init(params), params)
        params_j = optax.apply_updates(params, updates)
        exp = SimpleNamespace(
            loss=float(loss_j),
            grads=hourglass_from_jax({"params": grads, "batch_stats": stats},
                                     STACKS),
            after=hourglass_from_jax({"params": params_j,
                                      "batch_stats": stats_j}, STACKS))

    net = HourglassNet(num_stacks=STACKS, num_joints=J, features=FEATS,
                       dtype=torch.float64).double()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in
                         hourglass_from_jax(variables, STACKS).items()},
                        strict=True)
    net.train()
    opt = make_optimizer(net.parameters(), tconfig.OptimConfig())
    z = tops.flat_softmax(net(torch.from_numpy(x)))
    coords = tops.dsnt(z)
    tt = torch.from_numpy(t)[None].expand_as(coords)
    per_joint = tops.euclidean_losses(coords, tt) + tops.js_reg_losses(z, tt, SIGMA)
    loss_t = _masked_stack_sum(per_joint, torch.from_numpy(mask)[None].expand_as(per_joint))
    opt.zero_grad()
    loss_t.backward()
    grads_t = {n: p.grad.numpy().copy() for n, p in net.named_parameters()}
    opt.step()
    got = SimpleNamespace(loss=loss_t.item(), grads=grads_t,
                          after={k: v.numpy() for k, v in net.state_dict().items()})
    return got, exp


def test_fp64_step_loss(fp64_step):
    got, exp = fp64_step
    np.testing.assert_allclose(got.loss, exp.loss, rtol=1e-8)


def test_fp64_step_every_grad(fp64_step):
    got, exp = fp64_step
    gmax = max(np.abs(exp.grads[n]).max() for n in got.grads)
    assert len(got.grads) > 50
    for name, g in got.grads.items():
        np.testing.assert_allclose(g, exp.grads[name], rtol=1e-6,
                                   atol=1e-9 * gmax, err_msg=name)


def test_fp64_step_updated_params(fp64_step):
    got, exp = fp64_step
    for name in got.grads:
        np.testing.assert_allclose(got.after[name], exp.after[name],
                                   rtol=1e-10, atol=2e-9, err_msg=name)


def test_fp64_step_batch_stats(fp64_step):
    got, exp = fp64_step
    keys = [k for k in exp.after if "running" in k]
    assert len(keys) > 100
    for k in keys:
        np.testing.assert_allclose(got.after[k], exp.after[k], rtol=1e-10,
                                   atol=1e-12, err_msg=k)


MODEL_KW = dict(base="hg2", hg_features=FEATS, input_size=SIZE, dtype="float32",
                reg="js", use_pallas=True)


@contextlib.contextmanager
def _bn_statistics_in_fp64():
    """flax's train-mode BatchNorm with its batch mean and variance computed
    in fp64 (under ``jax.enable_x64``) and cast back to the input's dtype;
    everything else in the network stays as it was."""
    base = flax_norm._compute_stats

    def stats(x, axes, dtype, *args, **kwargs):
        mean, var = base(x.astype(jnp.float64), axes, jnp.float64, *args, **kwargs)
        return mean.astype(x.dtype), var.astype(x.dtype)

    flax_norm._compute_stats = stats
    try:
        yield
    finally:
        flax_norm._compute_stats = base


@pytest.fixture(scope="module")
def fp32_step():
    jcfg = jconfig.Config(model=jconfig.ModelConfig(**MODEL_KW),
                          data=jconfig.DataConfig(warp_method="shear"))
    tcfg = tconfig.config_from_json(jconfig.config_to_json(jcfg))
    jmodel = j_build(jcfg.model)
    variables = perturb(jmodel.init_variables(jax.random.PRNGKey(0)))
    batch = j_synth(BATCH, 96, seed=3)
    tx = j_make_optimizer(jcfg.optim, 1, jcfg.train.epochs)
    key = jax.random.PRNGKey(5)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                        batch_stats=variables["batch_stats"],
                        opt_state=tx.init(variables["params"]), rng=key)
    train_step = jloop._build_step_bodies(jmodel, jcfg)[0]
    new_state, metrics = jax.jit(train_step)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    exp_stats = hourglass_from_jax(
        {"params": new_state.params, "batch_stats": new_state.batch_stats},
        STACKS)

    # The step's gradients recomputed by the JAX package (plain head: the
    # Pallas head agrees to 2e-6 here), with flax's BN statistics in fp32 as
    # the step computes them, and in fp64.
    plain = j_build(jconfig.ModelConfig(**{**MODEL_KW, "use_pallas": False}))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    pre = jloop._build_eval_body(plain, jcfg)[0](jax.random.fold_in(key, 0),
                                                 jbatch, True)

    def loss_fn(params):
        out, _ = plain.module.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            pre["images"], train=True, mutable=["batch_stats"])
        return plain.loss(out, pre["coords"], pre["mask"])[0]

    norm_fp32 = float(optax.global_norm(jax.jit(jax.grad(loss_fn))(
        variables["params"])))
    with jax.enable_x64(True), _bn_statistics_in_fp64():
        norm_bn64 = float(optax.global_norm(jax.jit(jax.grad(loss_fn))(
            variables["params"])))

    draws = jax_train_draws(jax.random.fold_in(key, 0), BATCH, jcfg.data)
    assert 0 < draws["flip"].sum() < BATCH and np.all(draws["rot"] != 0)
    start = hourglass_from_jax(variables, STACKS)
    model = build_pose_model(tcfg.model, device="cpu", state_dict=start)
    step = make_train_fn(model, tcfg, device="cpu")
    reset_launch_counts()
    got = step(batch, draws={k: None if v is None else torch.from_numpy(v)
                             for k, v in draws.items()})
    return SimpleNamespace(got=got, exp=jax.device_get(metrics),
                           exp_stats=exp_stats, model=model, step=step,
                           launches=launch_counts(), start=start,
                           jax_norm_fp32=norm_fp32, jax_norm_bn64=norm_bn64,
                           lr=jcfg.optim.lr)


@pytest.mark.parametrize("key", ["loss", "euclidean", "reg"])
def test_fp32_step_loss_and_aux(fp32_step, key):
    got = fp32_step.got[key]
    assert got.shape == () and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), fp32_step.exp[key], rtol=1e-4)


def test_fp32_step_grad_norm(fp32_step):
    s = fp32_step
    # The step's metric is the global norm of the gradients as the JAX
    # package computes them (BN statistics in fp32) ...
    np.testing.assert_allclose(s.exp["grad_norm"], s.jax_norm_fp32, rtol=1e-4)
    # ... and the port's is that of the same gradients with flax's BN
    # statistics in fp64.
    np.testing.assert_allclose(s.got["grad_norm"].numpy(), s.jax_norm_bn64,
                               rtol=2e-2)


# Biases whose gradient is 0 in exact arithmetic: a score map's softmax is
# blind to a constant logit offset, and what fc_back/score_back add to the
# next stack's input reaches the loss only through train-mode BNs, which
# remove a constant offset.  Their fp32 gradient is rounding noise.
ZERO_GRAD_BIASES = ("score0.bias", "score1.bias", "fc_back0.bias",
                    "score_back0.bias")


def test_fp32_step_updated_params(fp32_step):
    # RMSProp's first update is -lr g / (0.1 |g| + eps), about -10 lr sign(g)
    # wherever |g| >> eps.  Every other leaf must have stepped as JAX's did:
    # the norm of its change within 3% (a leaf left out, or a wrong lr, fails
    # here), and 95% of all elements within 5% of a full step of JAX's
    # (a wrong sign fails here).
    s = fp32_step
    after = s.model.net.state_dict()
    full = 10 * s.lr
    agree = total = 0
    for name, _ in s.model.net.named_parameters():
        got = after[name].numpy() - s.start[name]
        exp = s.exp_stats[name] - s.start[name]
        if name.endswith(ZERO_GRAD_BIASES):
            continue
        np.testing.assert_allclose(np.linalg.norm(got), np.linalg.norm(exp),
                                   rtol=3e-2, err_msg=name)
        agree += int((np.abs(got - exp) <= 0.05 * full).sum())
        total += got.size
    assert total > 150_000
    assert agree / total >= 0.95, agree / total


def test_fp32_step_batch_stats(fp32_step):
    state = fp32_step.model.net.state_dict()
    keys = [k for k in fp32_step.exp_stats if "running" in k]
    assert len(keys) > 100
    for k in keys:
        got, exp = state[k].numpy(), fp32_step.exp_stats[k]
        if k.endswith("running_mean"):
            np.testing.assert_allclose(got, exp, rtol=0, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_allclose(got, exp, rtol=1e-2, err_msg=k)


def test_fp32_step_advances_state_on_plain_versions(fp32_step):
    # CPU tensors: the plain versions ran, no kernel launched; one optimizer
    # step was taken and the module was left in train mode.
    state = fp32_step.step.state
    assert fp32_step.launches == {"dsnt_head_fwd": 0, "dsnt_head_bwd": 0,
                                  "row_shift": 0}
    assert state.step == 1 and state.optimizer.count == 1
    assert fp32_step.model.net.training
