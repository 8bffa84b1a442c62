"""A JAX ``TrainState`` into the port (``train/from_jax.py``,
``tools/jax_ckpt_to_torch.py``), on the CPU.

**(a) fp64 resumed step.** For each optimizer the JAX package makes
(rmsprop, rmsprop with momentum 0.9, adam, sgd with momentum 0.9), with the
clip and weight decay on and off: a JAX state after 2 fp64 steps (hg1 at
16 features, depth 2, 32 px; JS; a ``step`` schedule whose drop falls at
count 2, so the resumed step's learning rate reads the converted count) is
saved and restored through the JAX package's ``CheckpointManager``,
converted by ``state_payload_from_jax`` and loaded into the port's train
state by ``load_payload_``.  One more step on both sides, on the same
batch: the parameters, every optimizer moment and the BN statistics agree
within rtol 1e-10, with an atol of 1e-10 of the largest value of the
tensor (a parameter or BN statistic) or of the moment over all parameters:
the score conv's bias has a gradient of 0 in exact arithmetic (the softmax
ignores a constant logit), so its fp64 gradient and moments are rounding
noise (its ``square_avg`` ~1e-36, against ~1e-2 for the others).  The
loss is the plain ops' DSNT + JS in fp64 on both sides (``pose_loss``
takes the maps in fp32 in both packages).

**(c) Full width, bitwise.** ``jax.eval_shape`` templates of hg8 at 256
features, ResNet-50 dilated twice, ViT-S/16 and ResNet-18 with the fc head,
filled from a seeded numpy generator (RMSProp's ``nu`` set to twice each
parameter), saved through orbax, converted by the script and loaded with
``load_state_dict(strict=True)`` into the port's full-width model: every
weight equals ``pose_net_from_jax`` of the same variables bitwise, and
every ``square_avg`` equals twice its parameter bitwise (a missed or wrong
transpose of a moment breaks the equality, square kernels included).
No forward pass.

**(d) Errors**: an unknown optax state, a set of states another optimizer
makes, a run with no checkpoints and a missing ``config.json`` each raise,
naming the cause.
"""

import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dsnt_pose2d_tpu import ops as jops
from dsnt_pose2d_tpu.models.factory import build_pose_model as j_build
from dsnt_pose2d_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from dsnt_pose2d_tpu.train.state import TrainState as JTrainState
from dsnt_pose2d_tpu.train.state import create_train_state as j_create_train_state
from dsnt_pose2d_tpu.train.state import make_optimizer as j_make_optimizer
from dsnt_pose2d_tpu.utils import config as jconfig
from dsnt_pose2d_tpu_torch import ops as tops
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
from dsnt_pose2d_tpu_torch.models.from_jax import pose_net_from_jax
from dsnt_pose2d_tpu_torch.train import from_jax
from dsnt_pose2d_tpu_torch.train.checkpoint import (STATE_FILENAME, load_payload_,
                                                    state_payload)
from dsnt_pose2d_tpu_torch.train.state import create_train_state
from dsnt_pose2d_tpu_torch.utils import config as tconfig
from port_helpers import jax_backbone, perturb

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import jax_ckpt_to_torch  # noqa: E402

torch.set_num_threads(1)

# -- (a) --------------------------------------------------------------------

MODEL = dict(base="hg1", hg_features=16, hg_depth=2, input_size=32,
             dtype="float32", reg="js", use_pallas=False)
BATCH, STEPS_PER_EPOCH, EPOCHS = 2, 2, 3
OPTIMIZERS = {"rmsprop": {}, "rmsprop_momentum": {"momentum": 0.9},
              "adam": {"optimizer": "adam"},
              "sgd_momentum": {"optimizer": "sgd", "momentum": 0.9, "lr": 1e-2}}
EXTRAS = {"plain": {}, "clip_wd": {"grad_clip_norm": 1.0, "weight_decay": 1e-2}}
CASES = [(o, e) for o in OPTIMIZERS for e in EXTRAS]


def _jcfg(optimizer: str, extra: str):
    optim = {"lr": 1e-3, "lr_drop_epochs": (1,), "lr_drop_factor": 0.1,
             **OPTIMIZERS[optimizer], **EXTRAS[extra]}
    return jconfig.Config(model=jconfig.ModelConfig(**MODEL),
                          optim=jconfig.OptimConfig(**optim),
                          train=jconfig.TrainConfig(epochs=EPOCHS, seed=3))


def _batches(n):
    rng = np.random.default_rng(11)
    return [(rng.normal(size=(BATCH, 32, 32, 3)) * 0.5,
             rng.uniform(-0.7, 0.7, size=(BATCH, 16, 2)),
             (rng.uniform(size=(BATCH, 16)) > 0.2).astype(np.float64))
            for _ in range(n)]


@pytest.fixture(scope="module")
def jax_grad():
    """The fp64 loss and gradient of the bare flax hg1 (in train mode, with
    its new BN statistics), jitted once for every case."""
    cfg = _jcfg("rmsprop", "plain")
    with jax.enable_x64(True):
        backbone = jax_backbone("hg1", 16, jnp.float64, 16, depth=2)

        def loss_fn(params, stats, x, t, mask):
            raw, mutated = backbone.apply(
                {"params": params["backbone"], "batch_stats": stats["backbone"]},
                x, train=True, mutable=["batch_stats"])
            return _jax_loss(raw, t, mask, cfg.model.hm_sigma), {
                "backbone": mutated["batch_stats"]}

        yield jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _jax_loss(raw, t, mask, sigma):
    """DSNT + JS over the stacks, each stack's masked mean summed, in the
    maps' dtype (``pose_loss`` takes the maps in fp32)."""
    z = jops.flat_softmax(raw)
    coords = jops.dsnt(z)
    tb = jnp.broadcast_to(t[None], coords.shape)
    per_joint = jops.euclidean_losses(coords, tb) + jops.js_reg_losses(z, tb, sigma)
    m = jnp.broadcast_to(mask[None], per_joint.shape)
    return jnp.sum(jnp.sum(per_joint * m, axis=(1, 2))
                   / jnp.maximum(jnp.sum(m, axis=(1, 2)), 1.0))


def _port_loss(raw, t, mask, sigma):
    z = tops.flat_softmax(raw)
    coords = tops.dsnt(z)
    tb = t[None].expand_as(coords)
    per_joint = tops.euclidean_losses(coords, tb) + tops.js_reg_losses(z, tb, sigma)
    m = mask[None].expand_as(per_joint)
    return ((per_joint * m).sum(dim=(1, 2))
            / m.sum(dim=(1, 2)).clamp_min(1.0)).sum()


def _fp64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else np.asarray(a), tree)


def _jax_step(grad_fn, tx, state, batch):
    x, t, mask = (jnp.asarray(a) for a in batch)
    (_, stats), grads = grad_fn(state.params, state.batch_stats, x, t, mask)
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    return state.replace(step=state.step + 1,
                         params=optax.apply_updates(state.params, updates),
                         batch_stats=stats, opt_state=opt_state)


def _port_state(tcfg, payload):
    model = build_pose_model(tcfg.model, device="cpu")
    state = create_train_state(model, tcfg, steps_per_epoch=STEPS_PER_EPOCH)
    model.net.double()
    model.net.backbone.dtype = torch.float64
    load_payload_(state, payload)
    return state


def _port_step(state, tcfg, batch):
    x, t, mask = (torch.from_numpy(a) for a in batch)
    net = state.model.net
    net.train()
    loss = _port_loss(net(x).heatmaps, t, mask, tcfg.model.hm_sigma)
    state.optimizer.zero_grad()
    loss.backward()
    state.optimizer.step()
    state.step += 1


_RESUMED = {}


@pytest.fixture(scope="module")
def resumed(jax_grad, tmp_path_factory):
    """Per case: ``(port payload, JAX payload)`` after the resumed step."""

    def run(optimizer, extra):
        key = (optimizer, extra)
        if key in _RESUMED:
            return _RESUMED[key]
        jcfg = _jcfg(optimizer, extra)
        tcfg = tconfig.config_from_json(jconfig.config_to_json(jcfg))
        batches = _batches(3)
        with jax.enable_x64(True):
            jmodel = j_build(jcfg.model)
            init = jax.jit(lambda k: j_create_train_state(
                jmodel, jcfg.optim, k, steps_per_epoch=STEPS_PER_EPOCH,
                epochs=EPOCHS))(jax.random.PRNGKey(3))
            state = _fp64(jax.device_get(init))
            state = state.replace(params=perturb(state.params, seed=1),
                                  batch_stats=perturb(state.batch_stats, seed=1))
            tx = j_make_optimizer(jcfg.optim, STEPS_PER_EPOCH, EPOCHS)
            for batch in batches[:2]:
                state = _jax_step(jax_grad, tx, state, batch)
            out = tmp_path_factory.mktemp(f"{optimizer}_{extra}")
            mgr = JCheckpointManager(str(out), jcfg)
            mgr.save(0, state)
            mgr.wait()
            template = jax.tree_util.tree_map(jnp.asarray, state)
            restored, _ = mgr.restore(template, epoch=0)
            mgr.close()
            restored = jax.device_get(restored)
            assert restored.params["backbone"]["stem_conv"]["kernel"].dtype == np.float64
            payload, note = from_jax.state_payload_from_jax(restored, tcfg)
            after = jax.device_get(_jax_step(jax_grad, tx, state, batches[2]))
            expected, _ = from_jax.state_payload_from_jax(after, tcfg)
        assert note == from_jax.DRAWS_NOTE
        port = _port_state(tcfg, payload)
        assert (port.step, port.optimizer.count) == (2, 2)
        assert port.optimizer.schedule(2) == pytest.approx(1e-4 if optimizer != "sgd_momentum" else 1e-3)
        _port_step(port, tcfg, batches[2])
        _RESUMED[key] = (state_payload(port), expected)
        return _RESUMED[key]

    return run


def _close(got, exp, what):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    scale = float(np.abs(exp).max()) if exp.size else 0.0
    np.testing.assert_allclose(got, exp, rtol=1e-10, atol=1e-10 * scale,
                               err_msg=what)


@pytest.mark.parametrize("optimizer,extra", CASES)
def test_resumed_step_params_and_bn_statistics(resumed, optimizer, extra):
    got, exp = resumed(optimizer, extra)
    assert set(got["model"]) == set(exp["model"])
    checked = 0
    for k, v in exp["model"].items():
        if k.endswith("num_batches_tracked"):
            continue
        _close(got["model"][k], v, k)
        checked += 1
    assert checked > 60
    assert (got["step"], got["count"]) == (exp["step"], exp["count"]) == (3, 3)


@pytest.mark.parametrize("optimizer,extra", CASES)
def test_resumed_step_every_optimizer_moment(resumed, optimizer, extra):
    got, exp = resumed(optimizer, extra)
    got, exp = got["optimizer"]["state"], exp["optimizer"]["state"]
    assert set(got) == set(exp) and len(got) > 40
    want = {"rmsprop": {"step", "square_avg"},
            "rmsprop_momentum": {"square_avg", "momentum_buffer"},
            "adam": {"step", "exp_avg", "exp_avg_sq"},
            "sgd_momentum": {"momentum_buffer"}}[optimizer]
    scale = {k: max(float(st[k].abs().max()) for st in exp.values())
             for k in want - {"step"}}
    for i, st in exp.items():
        assert set(got[i]) == set(st) == want, i
        for k, v in st.items():
            if k == "step":
                assert float(got[i][k]) == float(v) == 3.0
            else:
                np.testing.assert_allclose(got[i][k].numpy(), v.numpy(),
                                           rtol=1e-10, atol=1e-10 * scale[k],
                                           err_msg=f"{i}.{k}")


# -- (c) ----------------------------------------------------------------------

FULL_WIDTH = {
    "hg8_256": dict(base="hg8"),
    "resnet50_dilate2": dict(base="resnet50", dilate=2),
    "vit_s16": dict(base="vit_s16"),
    "resnet18_fc": dict(base="resnet18", output_strat="fc"),
}


def _filled_state(jcfg, seed):
    """The ``TrainState`` of ``jcfg`` from ``jax.eval_shape``, every leaf
    drawn from a seeded numpy generator; RMSProp's ``nu`` is twice each
    parameter, its count and the step 7."""
    model = j_build(jcfg.model)
    shapes = jax.eval_shape(lambda k: j_create_train_state(model, jcfg.optim, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(s):
        if np.issubdtype(s.dtype, np.floating):
            return rng.normal(size=s.shape).astype(s.dtype)
        return np.zeros(s.shape, s.dtype)

    params = jax.tree_util.tree_map(fill, shapes.params)
    stats = jax.tree_util.tree_map(
        lambda s: rng.uniform(0.5, 1.5, s.shape).astype(s.dtype), shapes.batch_stats)
    def opt(st):
        name = type(st).__name__
        if name == "ScaleByRmsState":
            return st._replace(nu=jax.tree_util.tree_map(lambda p: p * 2, params))
        if name == "ScaleByScheduleState":
            return st._replace(count=np.asarray(7, np.int32))
        assert name == "EmptyState", name
        return st

    opt_state = tuple(opt(st) for st in shapes.opt_state)
    assert [type(st).__name__ for st in opt_state][:2] == [
        "ScaleByRmsState", "ScaleByScheduleState"]
    return JTrainState(step=np.asarray(7, np.int32), params=params,
                       batch_stats=stats, opt_state=opt_state,
                       rng=np.zeros(shapes.rng.shape, shapes.rng.dtype))


@pytest.mark.parametrize("name", sorted(FULL_WIDTH))
def test_full_width_state_converts_bitwise(name, tmp_path, capsys):
    jcfg = jconfig.Config(model=jconfig.ModelConfig(**FULL_WIDTH[name]))
    tcfg = tconfig.config_from_json(jconfig.config_to_json(jcfg))
    state = _filled_state(jcfg, seed=len(name))
    run = tmp_path / "jax"
    mgr = JCheckpointManager(str(run), jcfg)
    mgr.save(0, jax.tree_util.tree_map(jnp.asarray, state))
    mgr.wait()
    mgr.close()
    records = jax_ckpt_to_torch.convert(str(run), str(tmp_path / "port"))
    assert [(r["store"], r["key"]) for r in records] == [("ckpt", 0)]
    payload = torch.load(tmp_path / "port" / "ckpt" / "0" / STATE_FILENAME,
                         weights_only=True)
    expected = pose_net_from_jax({"params": state.params,
                                  "batch_stats": state.batch_stats}, jcfg.model)
    model = build_pose_model(tcfg.model, device="cpu", state_dict=payload["model"])
    got = model.net.state_dict()
    assert set(got) == set(expected)
    for k, v in expected.items():
        assert torch.equal(got[k], torch.from_numpy(np.asarray(v))), k
    tstate = create_train_state(model, tcfg)
    load_payload_(tstate, payload)
    assert (tstate.step, tstate.optimizer.count) == (7, 7)
    params = list(model.net.parameters())
    opt = tstate.optimizer.optimizer
    assert len(opt.state) == len(params) > 50
    for p in params:
        assert torch.equal(opt.state[p]["square_avg"], p.detach() * 2)
        assert float(opt.state[p]["step"]) == 7.0


# -- (d) ----------------------------------------------------------------------


def _tiny_state(optim):
    jcfg = jconfig.Config(model=jconfig.ModelConfig(**MODEL),
                          optim=jconfig.OptimConfig(**optim))
    jmodel = j_build(jcfg.model)
    state = jax.device_get(jax.jit(lambda k: j_create_train_state(
        jmodel, jcfg.optim, k))(jax.random.PRNGKey(0)))
    return state, tconfig.config_from_json(jconfig.config_to_json(jcfg))


def test_unknown_optimizer_state_raises():
    state, tcfg = _tiny_state({})
    # optax's rmsprop with bias correction keeps a count beside nu: a state
    # the JAX package never makes.
    odd = optax.scale_by_rms(bias_correction=True).init(state.params)
    with pytest.raises(ValueError, match="unknown optimizer state "
                                         "ScaleByRmsWithCountState"):
        from_jax.state_payload_from_jax(
            state.replace(opt_state=(odd, state.opt_state[1])), tcfg)
    with pytest.raises(ValueError, match="unknown optimizer state of type dict"):
        from_jax.state_payload_from_jax(state.replace(opt_state={"nu": 0}), tcfg)


def test_states_of_another_optimizer_raise():
    state, _ = _tiny_state({"optimizer": "adam"})
    _, tcfg = _tiny_state({})
    with pytest.raises(ValueError, match="'rmsprop' .* holds .*ScaleByRmsState"
                                         ".* the checkpoint has .*ScaleByAdamState"):
        from_jax.state_payload_from_jax(state, tcfg)


def test_run_without_checkpoints_raises(tmp_path):
    jcfg = jconfig.Config(model=jconfig.ModelConfig(**MODEL))
    JCheckpointManager(str(tmp_path / "run"), jcfg).close()
    with pytest.raises(FileNotFoundError, match="no checkpoints in .*run"):
        jax_ckpt_to_torch.convert(str(tmp_path / "run"), str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()


def test_missing_config_raises(tmp_path):
    (tmp_path / "run" / "ckpt").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="no config.json in .*run"):
        jax_ckpt_to_torch.convert(str(tmp_path / "run"), str(tmp_path / "out"))
    with pytest.raises(ValueError, match="lies in the source"):
        jax_ckpt_to_torch.convert(str(tmp_path / "run"), str(tmp_path / "run" / "x"))
    assert sorted(os.listdir(tmp_path / "run")) == ["ckpt"]
