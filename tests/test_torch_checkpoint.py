"""The port's checkpoints (``torch.save`` files in the JAX package's layout)
against the JAX package's orbax ``CheckpointManager``.

- A save and restore round trip into a fresh template: every tensor of the
  model's and the optimizer's ``state_dict``, ``OptimizerChain.count``, the
  step and the seed come back bit for bit, and the next step of both states
  is bitwise equal.
- The stores' retention (``max_to_keep``, the best slot surviving it, the
  step store) and ``restore``'s fallback give the same directories and the
  same restored epochs as the JAX package on the same sequence of saves;
  ``restore_latest`` picks the same store, ties included.
- ``load_config`` warns as the JAX package does.
- A checkpoint of weights converted with ``models/from_jax.py`` restores
  into a fresh port model with an identical ``state_dict``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsnt_pose2d_tpu.models.factory import build_pose_model as j_build
from dsnt_pose2d_tpu.train import checkpoint as jckpt
from dsnt_pose2d_tpu.train.state import create_train_state as j_create_state
from dsnt_pose2d_tpu.utils import config as jconfig
from dsnt_pose2d_tpu_torch.data.synthetic import make_synthetic_mpii
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
from dsnt_pose2d_tpu_torch.models.from_jax import hourglass_from_jax
from dsnt_pose2d_tpu_torch.train import checkpoint as tckpt
from dsnt_pose2d_tpu_torch.train.loop import make_train_fn
from dsnt_pose2d_tpu_torch.utils import config as tconfig
from port_helpers import perturb

JCFG = jconfig.Config(
    model=jconfig.ModelConfig(base="hg1", hg_features=16, hg_depth=2,
                              input_size=32, dtype="float32", reg="js",
                              use_pallas=False),
    optim=jconfig.OptimConfig(lr=2e-3, lr_drop_epochs=(1,), schedule="step"),
    train=jconfig.TrainConfig(batch_size=4, seed=7, epochs=2))
TCFG = tconfig.config_from_json(jconfig.config_to_json(JCFG))


def _step(seed=0, state_dict=None, cfg=TCFG):
    model = build_pose_model(cfg.model, device="cpu", seed=seed,
                             state_dict=state_dict)
    return make_train_fn(model, cfg, device="cpu", steps_per_epoch=2)


def _batch(seed):
    return make_synthetic_mpii(4, 48, seed=seed)


def _assert_states_equal(a, b):
    sa, sb = a.model.net.state_dict(), b.model.net.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.optimizer.state_dict(), b.optimizer.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert list(oa["state"]) == list(ob["state"]) and len(oa["state"]) > 50
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert (a.optimizer.count, a.step, a.seed) == (b.optimizer.count, b.step, b.seed)


def test_round_trip_into_a_fresh_template(tmp_path):
    step = _step(seed=0)
    for s in range(3):
        step(_batch(s))
    assert step.state.step == step.state.optimizer.count == 3
    mgr = tckpt.CheckpointManager(str(tmp_path), TCFG)
    mgr.save(1, step.state, metrics={"val_pckh": 0.25})

    fresh = _step(seed=1)
    fresh.state.seed = 99
    state, meta = mgr.restore(fresh.state)
    assert state is fresh.state
    assert meta == {"epoch": 1, "step": 3, "step_in_epoch": 0,
                    "metrics": {"val_pckh": 0.25}}
    _assert_states_equal(step.state, fresh.state)
    # Past the schedule's boundary (epoch 1 = step 2): the restored count
    # sets the same learning rate, so the next steps stay bitwise equal.
    for s in (3, 4):
        a, b = step(_batch(s)), fresh(_batch(s))
        assert torch.equal(a["loss"], b["loss"])
    _assert_states_equal(step.state, fresh.state)
    assert fresh.state.optimizer.optimizer.param_groups[0]["lr"] == pytest.approx(2e-4)


def test_checkpoint_files_load_weights_only(tmp_path):
    step = _step()
    step(_batch(0))
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save_step(step.state, epoch=0, step_in_epoch=1)
    d = tmp_path / "ckpt_step" / "1"
    assert sorted(os.listdir(d)) == [tckpt.META_FILENAME, tckpt.STATE_FILENAME]
    payload = torch.load(d / tckpt.STATE_FILENAME, weights_only=True)
    assert set(payload) == {"model", "optimizer", "count", "step", "seed"}
    assert all(v.device.type == "cpu" for v in payload["model"].values())
    assert json.loads((d / tckpt.META_FILENAME).read_text()) == {
        "epoch": 0, "step": 1, "step_in_epoch": 1, "metrics": {}}


def _listing(root):
    return {store: sorted(os.listdir(os.path.join(root, store)), key=int)
            for store in ("ckpt", "ckpt_best", "ckpt_step")}


@pytest.fixture(scope="module")
def jax_state():
    model = j_build(JCFG.model)
    return j_create_state(model, JCFG.optim, jax.random.PRNGKey(0), batch_size=2)


def test_retention_and_best_fallback_match_jax(tmp_path, jax_state, capsys):
    # tests/test_train.py::test_restore_falls_back_when_best_collected, in
    # both packages, plus three step saves into the two-slot step store.
    tstate = _step().state
    out = {}
    for name, mod, state in (("jax", jckpt, jax_state), ("torch", tckpt, tstate)):
        root = str(tmp_path / name)
        mgr = mod.CheckpointManager(root, JCFG, max_to_keep=2)
        for epoch in range(4):
            mgr.save(epoch, state, is_best=(epoch == 0),
                     metrics={"val_pckh": 0.5})
        for s in (5, 6, 7):
            if name == "jax":
                st = state.replace(step=jnp.asarray(s, jnp.int32))
            else:
                st, st.step = state, s
            mgr.save_step(st, epoch=3, step_in_epoch=s - 4)
        mgr.wait()
        assert mgr.best_epoch() == 0
        _, best_meta = mgr.restore(state, epoch=mgr.best_epoch())
        capsys.readouterr()
        _, fallback_meta = mgr.restore(state, epoch=1)
        out[name] = (_listing(root), best_meta["epoch"], fallback_meta["epoch"],
                     capsys.readouterr().err.replace(str(tmp_path / name), ""),
                     mgr.best_metrics())
        mgr.close()
    assert out["torch"] == out["jax"]
    assert out["torch"][:3] == ({"ckpt": ["2", "3"], "ckpt_best": ["0"],
                                 "ckpt_step": ["6", "7"]}, 0, 3)


@pytest.mark.parametrize("epoch_step, step_key, winner", [
    (4, 2, "epoch"), (4, 6, "step"), (4, 4, "epoch")],
    ids=["epoch_newer", "step_newer", "tie"])
def test_restore_latest_picks_the_store_jax_picks(tmp_path, jax_state,
                                                  epoch_step, step_key, winner):
    tstate = _step().state
    got = {}
    for name, mod, state in (("jax", jckpt, jax_state), ("torch", tckpt, tstate)):
        mgr = mod.CheckpointManager(str(tmp_path / name), JCFG)
        for store, s in (("epoch", epoch_step), ("step", step_key)):
            if name == "jax":
                st = state.replace(step=jnp.asarray(s, jnp.int32))
            else:
                st, st.step = state, s
            if store == "epoch":
                mgr.save(0, st)
            else:
                mgr.save_step(st, epoch=1, step_in_epoch=1)
        mgr.wait()
        restored, meta = mgr.restore_latest(state)
        step = (int(restored.step) if name == "jax" else restored.step)
        got[name] = (meta["epoch"], meta.get("step"), meta["step_in_epoch"], step)
        mgr.close()
    assert got["torch"] == got["jax"]
    exp_step = epoch_step if winner == "epoch" else step_key
    assert got["torch"] == ((0, exp_step, 0, exp_step) if winner == "epoch"
                            else (1, exp_step, 1, exp_step))


def test_restore_of_an_empty_dir(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path))
    state = _step().state
    assert mgr.restore(state) == (None, None)
    assert mgr.restore_latest(state) == (None, None)
    assert mgr.best_epoch() is None and mgr.best_metrics() == {}
    assert mgr.load_config() is None


def test_load_config_warns_as_jax(tmp_path):
    # tests/test_train.py::test_model_version_legacy_configs_flagged, with
    # the port's manager and its config_to_json.
    d = json.loads(tconfig.config_to_json(TCFG))
    del d["model"]["model_version"]
    (tmp_path / "config.json").write_text(json.dumps(d))
    for mod, match in ((tckpt, "predates the model_version field"),
                       (jckpt, "predates the model_version field")):
        with pytest.warns(UserWarning, match=match):
            cfg = mod.CheckpointManager(str(tmp_path)).load_config()
        assert cfg.model.model_version == 0
    d["model"]["model_version"] = 1
    (tmp_path / "config.json").write_text(json.dumps(d))
    with pytest.warns(UserWarning, match="expect degraded accuracy"):
        cfg = tckpt.CheckpointManager(str(tmp_path)).load_config()
    assert cfg.model.model_version == 1


def test_config_written_and_loaded_from_dir(tmp_path):
    tckpt.CheckpointManager(str(tmp_path), TCFG)
    assert tckpt.load_config_from_dir(str(tmp_path)) == TCFG
    # The JAX package reads the port's config.json, and the other way round.
    assert jckpt.load_config_from_dir(str(tmp_path)) == JCFG
    jckpt.CheckpointManager(str(tmp_path / "j"), JCFG).close()
    assert tckpt.CheckpointManager(str(tmp_path / "j")).load_config() == TCFG


def test_converted_jax_weights_round_trip(tmp_path):
    jmodel = j_build(JCFG.model)
    variables = perturb(jmodel.init_variables(jax.random.PRNGKey(3)), seed=1)
    converted = {k: torch.from_numpy(np.array(v)) for k, v in
                 hourglass_from_jax(variables, 1, depth=2).items()}
    step = _step(state_dict=converted)
    mgr = tckpt.CheckpointManager(str(tmp_path), TCFG)
    mgr.save(0, step.state)
    fresh = _step(seed=5)
    mgr.restore(fresh.state, epoch=0)
    got = fresh.state.model.net.state_dict()
    assert list(got) == list(converted)
    for k, v in converted.items():
        assert torch.equal(got[k], v), k
