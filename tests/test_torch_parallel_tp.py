"""The port's tensor parallelism (``parallel/tp.py``) over gloo ranks, on the
CPU.

Job ``tp`` of ``tests/torch_dp_worker.py`` runs 2 ranks at
``model_parallel = 2`` (data 1 x model 2); job ``tp4`` runs 4 ranks at
data 2 x model 2.  The JAX side shards the same flax-initialised state on a
``make_mesh(2, model_parallel=2)`` mesh of the conftest's virtual CPU
devices with ``state_sharding_for`` (plain head):

- **(a) the shards**: for a tiny hg2 (dsnt + JS), a tiny ViT-T/16 (its
  ``qkv`` and ``pos_*``) and a tiny hg1 with the fc head (its
  ``fc_head_bias``), each rank holds exactly JAX's ``addressable_shards[r]``
  of every leaf (mapped by ``from_jax``, which maps a shard as it maps the
  whole leaf), the replicated leaves whole, and its optimizer moments of
  its shards' shapes only.
- **(b) one fp32 hg2 train step** against the JAX package's TP step, at
  ``tests/test_torch_parallel_step.py``'s tolerances: loss and aux rtol
  1e-4, ``grad_norm`` rtol 2e-2, running means atol 1e-3 and variances
  rtol 1e-2, each updated parameter shard's norm of change rtol 3e-2 with
  95% of its elements within 5% of a full RMSProp step, each RMSProp
  moment shard's norm rtol 3e-2 (both the square roots: the moment is a
  squared gradient); the replicated leaves bitwise equal across the ranks.
- **(c) fp64 against the port's own one-process step**, 2 steps, rtol
  1e-10 (each tensor within 1e-10 of its largest value, or of 1, as
  ``test_torch_parallel_step.py``).
- **(d) data 2 x model 2** on 4 ranks, each hourglass stack under remat
  (its recompute issues the stack's BN and model-axis collectives again):
  one fp64 step against the one process on the global batch without
  remat (remat is bitwise in fp64, ``tests/test_torch_remat.py``).
- **(e) checkpoints**: one saved at t = 2 restores at t = 1 bitwise, and
  one saved at t = 1 restores at t = 2 bitwise (parameters, BN
  statistics, RMSProp moments, counts).
- **the CLIs**: ``cli.train --model-parallel 2`` trains one epoch of a
  tiny hg1 and writes whole checkpoints; ``cli.evaluate`` and
  ``cli.infer`` run on the 2 ranks at the run's width, and
  ``cli.evaluate`` in one process (the config set to t = 1) scores the
  same checkpoint to the train run's ``val_pckh``.
"""

import contextlib
import dataclasses
import io
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from dsnt_pose2d_tpu.data.synthetic import make_synthetic_mpii as j_synth
from dsnt_pose2d_tpu.models.factory import build_pose_model as j_build
from dsnt_pose2d_tpu.parallel.mesh import make_mesh, shard_batch
from dsnt_pose2d_tpu.train import loop as jloop
from dsnt_pose2d_tpu.train.state import TrainState as JTrainState
from dsnt_pose2d_tpu.train.state import make_optimizer as j_make_optimizer
from dsnt_pose2d_tpu.utils import config as jconfig
from dsnt_pose2d_tpu_torch.cli import evaluate as evaluate_cli
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
from dsnt_pose2d_tpu_torch.models.from_jax import pose_net_from_jax
from dsnt_pose2d_tpu_torch.parallel import tp
from dsnt_pose2d_tpu_torch.train import loop
from dsnt_pose2d_tpu_torch.train.checkpoint import CheckpointManager
from dsnt_pose2d_tpu_torch.utils import config as tconfig
from port_helpers import jax_train_draws
import torch_dp_worker

T, BATCH = 2, 8
MODELS = {
    "hg": dict(base="hg2", hg_features=32, input_size=64, reg="js"),
    "vit": dict(base="vit_t16", input_size=32, reg="js"),
    "fc": dict(base="hg1", hg_features=16, hg_depth=1, input_size=32,
               output_strat="fc"),
}
CANVAS = {"hg": 96, "vit": 48, "fc": 48}
# Leaves the rule must shard (the cases a naive "shard torch dim 0" gets
# wrong, and a plain conv).
MUST_SHARD = {"hg": ("backbone.stem_conv.weight", "backbone.score1.weight",
                     "backbone.score_back0.weight"),
              "vit": ("backbone.block0.qkv.weight", "backbone.block0.qkv.bias",
                      "backbone.pos_row", "backbone.pos_col",
                      "backbone.block0.fc2.weight"),
              "fc": ("fc_head_kernel", "fc_head_bias")}
# Biases whose gradient is 0 in exact arithmetic (tests/test_torch_train_step.py).
ZERO_GRAD_BIASES = ("score0.bias", "score1.bias", "fc_back0.bias",
                    "score_back0.bias")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(name):
    jcfg = jconfig.Config(
        model=jconfig.ModelConfig(**MODELS[name], dtype="float32",
                                  use_pallas=False),
        data=jconfig.DataConfig(warp_method="shear"),
        train=jconfig.TrainConfig(batch_size=BATCH, donate=False))
    tcfg = tconfig.config_from_json(jconfig.config_to_json(jcfg))
    cfg32 = dataclasses.replace(
        tcfg, model=dataclasses.replace(tcfg.model, use_pallas=True))
    return jcfg, cfg32, tcfg


def _nu(opt_state):
    """optax rmsprop's second moment (a tree like the params)."""
    return next(s.nu for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "nu")) if hasattr(s, "nu"))


def _shards(tree, mesh, r):
    """Device ``(0, r)``'s shard of every leaf."""
    dev = mesh.devices[0, r]
    return jax.tree_util.tree_map(
        lambda x: np.asarray(next(s.data for s in x.addressable_shards
                                  if s.device == dev)), tree)


def _port_layout(tree, stats, cfg):
    """A flax params-like tree (and BN statistics) in the port's keys."""
    return pose_net_from_jax({"params": tree, "batch_stats": stats}, cfg)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp")
    mesh = make_mesh(T, model_parallel=T)
    key = jax.random.PRNGKey(5)
    exp = {}
    for name in MODELS:
        jcfg, cfg32, cfg64 = _configs(name)
        jmodel = j_build(jcfg.model)
        variables = jax.device_get(jmodel.init_variables(jax.random.PRNGKey(0)))
        stats = variables.get("batch_stats", {})
        weights = pose_net_from_jax(variables, cfg32.model)
        batch = j_synth(BATCH, CANVAS[name], seed=3)
        tx = j_make_optimizer(jcfg.optim, 1, jcfg.train.epochs)
        state = JTrainState(step=jnp.zeros((), jnp.int32),
                            params=variables["params"], batch_stats=stats,
                            opt_state=tx.init(variables["params"]), rng=key)
        state = jax.device_put(state, jloop.state_sharding_for(jmodel, jcfg, mesh))
        exp[name] = {"weights": weights, "loaded": [
            _port_layout(*_shards((state.params, state.batch_stats), mesh, r),
                         cfg32.model) for r in range(T)]}
        (work / f"{name}_cfg.json").write_text(tconfig.config_to_json(cfg32))
        np.savez(work / f"{name}_weights.npz", **weights)
        np.savez(work / f"{name}_batch.npz", **batch)
        if name != "hg":
            continue
        (work / "hg_cfg64.json").write_text(tconfig.config_to_json(cfg64))
        (work / "hg_cfg64_remat.json").write_text(tconfig.config_to_json(
            dataclasses.replace(cfg64, model=dataclasses.replace(
                cfg64.model, remat=True))))
        draws = jax_train_draws(jax.random.fold_in(key, 0), BATCH, jcfg.data)
        np.savez(work / "hg_draws.npz", **draws)
        train_step, _ = jloop.make_step_fns(jmodel, jcfg, mesh)
        new_state, metrics = train_step(state, shard_batch(mesh, batch))
        exp["hg"].update(
            metrics=jax.device_get(metrics), lr=jcfg.optim.lr,
            after=[_port_layout(*_shards((new_state.params, new_state.batch_stats),
                                         mesh, r), cfg32.model) for r in range(T)],
            nu=[_port_layout(*_shards((_nu(new_state.opt_state),
                                       new_state.batch_stats), mesh, r),
                             cfg32.model) for r in range(T)])
        # The port's one-process steps: fp64 (c, d) and the fp32 step whose
        # checkpoint the ranks restore at t = 2 (e).
        exp["one64"] = torch_dp_worker.fp64_steps(cfg64, weights, batch, 2)
        model = build_pose_model(cfg32.model, device="cpu", state_dict=weights)
        step = loop.make_train_fn(model, cfg32, device="cpu")
        step(batch, draws={k: torch.from_numpy(v) for k, v in draws.items()})
        CheckpointManager(str(work / "ckpt_t1")).save_step(
            step.state, epoch=0, step_in_epoch=1)
        exp["ckpt_t1"] = torch.load(work / "ckpt_t1" / "ckpt_step" / "1" / "state.pt")
        exp["layouts"] = tp.leaf_layouts(model.net)
    (work / "models.json").write_text(json.dumps(list(MODELS)))
    jobs = [torch_dp_worker.start("tp", work, work, T),
            torch_dp_worker.start("tp4", work, work, 2 * T)]
    try:
        ranks = torch_dp_worker.wait(jobs[0])
    finally:
        ranks4 = torch_dp_worker.wait(jobs[1])
    return dict(ranks=ranks, ranks4=ranks4, exp=exp, work=work)


def _take(exp, key, whole, r, t=T):
    """Rank ``r``'s shard of a whole port tensor (itself if replicated)."""
    layout = exp["layouts"][key] if key in exp["layouts"] else None
    if layout is None or not tp.sharded(layout.flax_shape, t):
        return whole
    return tp.Shard(layout, r, t).take(whole)


def test_ranks_joined_one_mesh(run):
    assert [r["world"] for r in run["ranks"]] == [
        {"backend": "gloo", "rank": r, "world_size": T} for r in range(T)]
    assert [r["mesh"] for r in run["ranks4"]] == [
        (d, m, {"data": 2, "model": 2}) for d in range(2) for m in range(2)]


@pytest.mark.parametrize("name", list(MODELS))
def test_state_shards_match_jax(run, name):
    # (a): each rank's shard of every leaf is JAX's addressable shard.
    whole = run["exp"][name]["weights"]
    for r, rank in enumerate(run["ranks"]):
        got, exp = rank[name]["loaded"], run["exp"][name]["loaded"][r]
        assert set(got) == set(exp)
        for k, v in exp.items():
            assert tuple(got[k].shape) == v.shape, k
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        cut = {k for k in exp if exp[k].shape != whole[k].shape}
        assert set(MUST_SHARD[name]) <= cut
        if name == "vit":
            # JAX's qkv shard is a strided set of the port's rows.
            assert got["backbone.block0.qkv.weight"].shape == (3 * 192 // 2, 192)


@pytest.mark.parametrize("name", list(MODELS))
def test_moments_are_held_as_shards(run, name):
    # (a): after a step each parameter's optimizer state has its shard's
    # shape (the JAX shard's), nothing of the whole leaf.
    for r, rank in enumerate(run["ranks"]):
        moments, exp = rank[name]["moments"], run["exp"][name]["loaded"][r]
        assert moments
        for k, m in moments.items():
            assert tuple(m["square_avg"].shape) == exp[k].shape, k


@pytest.mark.parametrize("key", ["loss", "euclidean", "reg", "grad_norm"])
def test_fp32_step_metrics_match_jax(run, key):
    # (b)
    rtol = 2e-2 if key == "grad_norm" else 1e-4
    for rank in run["ranks"]:
        got = rank["hg"]["metrics"][key]
        assert got.shape == ()
        np.testing.assert_allclose(got.numpy(), run["exp"]["hg"]["metrics"][key],
                                   rtol=rtol)


def test_fp32_step_shards_match_jax(run):
    # (b): updated parameters, BN statistics and RMSProp moments, shard by
    # shard against JAX's.
    exp = run["exp"]["hg"]
    full = 10 * exp["lr"]
    agree = total = stats = 0
    for r, rank in enumerate(run["ranks"]):
        after, moments = rank["hg"]["state"], rank["hg"]["moments"]
        for name, want in exp["after"][r].items():
            got = after[name].numpy()
            if "running_mean" in name:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-3, err_msg=name)
                stats += 1
                continue
            if "running_var" in name:
                np.testing.assert_allclose(got, want, rtol=1e-2, err_msg=name)
                continue
            if name.endswith(ZERO_GRAD_BIASES) or name not in moments:
                continue
            start = exp["loaded"][r][name]
            np.testing.assert_allclose(np.linalg.norm(got - start),
                                       np.linalg.norm(want - start),
                                       rtol=3e-2, err_msg=name)
            agree += int((np.abs((got - start) - (want - start)) <= 0.05 * full).sum())
            total += got.size
            np.testing.assert_allclose(
                np.linalg.norm(np.sqrt(moments[name]["square_avg"].numpy())),
                np.linalg.norm(np.sqrt(exp["nu"][r][name])), rtol=3e-2,
                err_msg=name)
    assert stats > 100 and total > 150_000
    assert agree / total >= 0.95, agree / total


def _replicated(state, exp):
    return [k for k in state if k not in exp["layouts"]
            or not tp.sharded(exp["layouts"][k].flax_shape, T)]


def test_replicated_leaves_bitwise_equal_across_the_model_group(run):
    exp = run["exp"]
    a, b = run["ranks"]
    keys = _replicated(a["hg"]["state"], exp)
    assert len(keys) > 100
    for k in keys:
        assert torch.equal(a["hg"]["state"][k], b["hg"]["state"][k]), k
        if k in a["hg"]["moments"]:
            assert torch.equal(a["hg"]["moments"][k]["square_avg"],
                               b["hg"]["moments"][k]["square_avg"]), k
    for s in range(2):
        x, y = (r["fp64"]["state"][s] for r in run["ranks"])
        assert all(torch.equal(x[k], y[k]) for k in keys)
    for k, v in a["hg"]["metrics"].items():
        assert torch.equal(v, b["hg"]["metrics"][k]), k


def test_collectives_per_step(run):
    # Data axis of one rank: none.  Model axis: a gather per conv forward,
    # an input-gradient sum per conv backward but the stem's (its input is
    # the images), the norm's sum of squares, and one broadcast bucket of
    # the replicated gradients.
    convs = sum(1 for k in run["exp"]["hg"]["weights"]
                if k.endswith(".weight") and run["exp"]["hg"]["weights"][k].ndim == 4)
    c = run["ranks"][0]["hg"]["collectives"]
    assert c["data"] == {"all_reduce": 0, "broadcast": 0}
    assert c[None] == {"all_reduce": 0, "broadcast": 0}
    assert c["model"] == {"all_reduce": 2 * convs, "broadcast": 1}


def _close(got, ref, err):
    v = ref.numpy()
    np.testing.assert_allclose(got.numpy(), v, rtol=0,
                               atol=1e-10 * max(np.abs(v).max(), 1.0), err_msg=err)


@pytest.mark.parametrize("step", [0, 1])
def test_fp64_matches_one_process(run, step):
    # (c)
    one = run["exp"]["one64"]
    for r, rank in enumerate(run["ranks"]):
        got = rank["fp64"]
        for k, v in one["metrics"][step].items():
            np.testing.assert_allclose(got["metrics"][step][k].numpy(), v.numpy(),
                                       rtol=1e-10, err_msg=k)
        state = got["state"][step]
        assert all(v.dtype == torch.float64 for v in state.values()
                   if v.is_floating_point())
        for k, v in one["state"][step].items():
            _close(state[k], _take(run["exp"], k, v, r), k)


def test_data_by_model_on_4_ranks_matches_one_process(run):
    # (d)
    one = run["exp"]["one64"]
    for i, rank in enumerate(run["ranks4"]):
        d, m, _ = rank["mesh"]
        for k, v in one["metrics"][0].items():
            np.testing.assert_allclose(rank["metrics"][0][k].numpy(), v.numpy(),
                                       rtol=1e-10, err_msg=k)
        for k, v in one["state"][0].items():
            _close(rank["state"][0][k], _take(run["exp"], k, v, m), k)
        # The remat recompute repeats the stacks' gathers: more model-axis
        # all-reduces than the 2 ranks' step without remat issued.
        c = rank["collectives"]
        assert c["data"]["all_reduce"] > 0
        assert c["model"]["all_reduce"] > run["ranks"][0]["hg"]["collectives"][
            "model"]["all_reduce"]
    # The data group's ranks (one model index) hold the same shards.
    for m in range(2):
        x, y = (run["ranks4"][d * 2 + m]["state"][0] for d in range(2))
        assert all(torch.equal(x[k], y[k]) for k in x)


def test_checkpoint_saved_at_t2_restores_at_t1_bitwise(run):
    # (e): the ranks' checkpoint is whole; one process restores it, and each
    # rank's shards are cut from it bit for bit.
    cfg = tconfig.config_from_json((run["work"] / "hg_cfg.json").read_text())
    model = build_pose_model(cfg.model, device="cpu", seed=11)
    state = loop.make_train_fn(model, cfg, device="cpu").state
    meta = CheckpointManager(str(run["work"] / "ckpt_t2")).step_mgr.restore(1, state)
    assert (meta["step"], state.step, state.optimizer.count) == (1, 1, 1)
    whole = model.net.state_dict()
    moments = torch_dp_worker._moments(state)
    for r, rank in enumerate(run["ranks"]):
        for k, v in rank["hg"]["state"].items():
            assert tuple(whole[k].shape) == tuple(run["exp"]["hg"]["weights"][k].shape)
            assert torch.equal(_take(run["exp"], k, whole[k], r), v), k
        for k, m in rank["hg"]["moments"].items():
            assert torch.equal(_take(run["exp"], k, moments[k]["square_avg"], r),
                               m["square_avg"]), k


def test_checkpoint_saved_at_t1_restores_at_t2_bitwise(run):
    # (e): the one-process checkpoint into the ranks' sharded state.
    saved = run["exp"]["ckpt_t1"]
    opt = saved["optimizer"]["state"]
    names = list(saved["model"])
    params = [k for k in names if k in run["exp"]["layouts"]]
    for r, rank in enumerate(run["ranks"]):
        got = rank["restored"]
        assert (got["count"], got["step"]) == (saved["count"], saved["step"]) == (1, 1)
        for k, v in saved["model"].items():
            assert torch.equal(got["state"][k], _take(run["exp"], k, v, r)), k
        assert len(got["moments"]) == len(params) == len(opt)
        for i, k in enumerate(params):
            assert torch.equal(got["moments"][k]["square_avg"],
                               _take(run["exp"], k, opt[i]["square_avg"], r)), k


def test_cli_trains_evaluates_and_infers_at_model_parallel_2(run, monkeypatch):
    work = run["work"]
    assert all(r["cli"]["train"] == r["cli"]["evaluate"] == r["cli"]["infer"] == 0
               for r in run["ranks"])
    exp_dir = work / "cli" / "tp"
    cfg = json.loads((exp_dir / "config.json").read_text())
    assert cfg["train"]["model_parallel"] == T
    assert [p.name for p in (exp_dir / "ckpt").iterdir()] == ["0"]
    saved = torch.load(exp_dir / "ckpt" / "0" / "state.pt")["model"]
    whole = build_pose_model(tconfig.config_from_json(json.dumps(cfg)).model,
                             device="cpu", seed=0).net.state_dict()
    assert {k: tuple(v.shape) for k, v in saved.items()} == \
        {k: tuple(v.shape) for k, v in whole.items()}
    best = json.loads((exp_dir / "best.json").read_text())["metrics"]["val_pckh"]
    assert [r["cli"]["evaluate_pckh"] for r in run["ranks"]] == [best] * T
    assert scipy.io.loadmat(work / "cli" / "preds.mat")["preds"].shape == (8, 16, 2)
    log = (work / "cli_rank0.log").read_text()
    assert "world_size=2 device=cpu model_parallel=2" in log

    # The same checkpoint scored in one process, at t = 1.
    one = work / "cli_t1"
    shutil.copytree(exp_dir, one)
    cfg["train"]["model_parallel"] = 1
    (one / "config.json").write_text(json.dumps(cfg))
    recorded = {}

    class RecordingDriver(loop.EvalDriver):
        def evaluate(self, *args, **kw):
            result = super().evaluate(*args, **kw)
            recorded["pckh"] = result["pckh"]
            return result

    monkeypatch.setattr(evaluate_cli, "EvalDriver", RecordingDriver)
    with contextlib.redirect_stdout(io.StringIO()):
        assert evaluate_cli.main(["--model-dir", str(one), "--device", "cpu",
                                  "--data-source", "synthetic",
                                  "--synthetic-size", "32",
                                  "--canvas-size", "48"]) == 0
    assert recorded["pckh"] == best
