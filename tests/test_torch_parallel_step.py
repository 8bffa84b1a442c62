"""The port's data-parallel train step over 2 gloo ranks, on the CPU.

Two ranks (``tests/torch_dp_worker.py``, job ``step``) each take their half
of one global batch of 8 (hg2, 32 features, 64-px input, 96-px synthetic
canvases, JS head, shear warp with rotation, flip and jitter):

- **fp32, against the JAX package's step on a 2-device ``data`` mesh**
  (``make_step_fns`` on the conftest's virtual CPU devices, its plain head),
  from the same flax-initialised weights, the same global batch and the
  same draws (the JAX step's, each rank taking its rows).  The tolerances
  of ``tests/test_torch_train_step.py``'s fp32 parity: loss and aux rtol
  1e-4; running means atol 1e-3 and variances rtol 1e-2; each updated
  parameter leaf's norm of change rtol 3e-2 and 95% of the elements within
  5% of a full RMSProp step.  ``grad_norm`` rtol 2e-2 against JAX's.  The
  ranks are bitwise equal to each other, and the step issues exactly one
  all-reduce per BN forward and one per BN backward, one for the mask
  count, one for the metrics and one gradient bucket.
- **fp64, against the port's own one-process step on the global batch**
  (two steps, the port's own draws, the heatmaps' fp32 activation cast
  lifted on both sides): loss, aux and grad norm within rtol 1e-10, every
  parameter and BN statistic within 1e-10 of its tensor's largest value (or
  of 1: the biases whose gradient is 0 in exact arithmetic hold rounding
  noise of ~1e-13 after RMSProp's first steps, different in each run).
- **The mask sum**: ranks holding different numbers of visible joints sum
  to the one-process loss, which a mean of the ranks' means misses.
- **``--debug-nans``**: a NaN made in one rank's backward pass raises on
  both ranks, after the gradient sum, and neither waits in a collective.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsnt_pose2d_tpu.data.synthetic import make_synthetic_mpii as j_synth
from dsnt_pose2d_tpu.models.factory import build_pose_model as j_build
from dsnt_pose2d_tpu.parallel.mesh import make_mesh, replicated, shard_batch
from dsnt_pose2d_tpu.train import loop as jloop
from dsnt_pose2d_tpu.train.state import TrainState as JTrainState
from dsnt_pose2d_tpu.train.state import make_optimizer as j_make_optimizer
from dsnt_pose2d_tpu.utils import config as jconfig
from dsnt_pose2d_tpu_torch.models import heads
from dsnt_pose2d_tpu_torch.models.from_jax import hourglass_from_jax
from dsnt_pose2d_tpu_torch.utils import config as tconfig
from port_helpers import jax_train_draws
import torch_dp_worker

STACKS, FEATS, SIZE, BATCH, RANKS = 2, 32, 64, 8, 2
MODEL_KW = dict(base="hg2", hg_features=FEATS, input_size=SIZE,
                dtype="float32", reg="js")
# Biases whose gradient is 0 in exact arithmetic (tests/test_torch_train_step.py).
ZERO_GRAD_BIASES = ("score0.bias", "score1.bias", "fc_back0.bias",
                    "score_back0.bias")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs():
    jcfg = jconfig.Config(
        model=jconfig.ModelConfig(**MODEL_KW, use_pallas=False),
        data=jconfig.DataConfig(warp_method="shear"),
        train=jconfig.TrainConfig(batch_size=BATCH, donate=False))
    tcfg = tconfig.config_from_json(jconfig.config_to_json(jcfg))
    cfg32 = dataclasses.replace(
        tcfg, model=dataclasses.replace(tcfg.model, use_pallas=True))
    return jcfg, cfg32, tcfg


def _mask_case():
    rng = np.random.default_rng(5)
    raw = rng.normal(size=(STACKS, BATCH, 16, 8, 8)).astype(np.float32)
    coords = rng.uniform(-0.8, 0.8, size=(BATCH, 16, 2)).astype(np.float32)
    mask = np.ones((BATCH, 16), np.float32)
    mask[:BATCH // 2] = rng.uniform(size=(BATCH // 2, 16)) < 0.25   # rank 0
    return {"raw": raw, "coords": coords, "mask": mask}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("dp_step")
    jcfg, cfg32, cfg64 = _configs()
    jmodel = j_build(jcfg.model)
    variables = jax.device_get(jmodel.init_variables(jax.random.PRNGKey(0)))
    weights = hourglass_from_jax(variables, STACKS)
    batch = j_synth(BATCH, 96, seed=3)
    key = jax.random.PRNGKey(5)
    draws = jax_train_draws(jax.random.fold_in(key, 0), BATCH, jcfg.data)
    assert 0 < draws["flip"].sum() < BATCH and np.all(draws["rot"] != 0)
    (work / "cfg.json").write_text(tconfig.config_to_json(cfg32))
    (work / "cfg64.json").write_text(tconfig.config_to_json(cfg64))
    np.savez(work / "weights.npz", **weights)
    np.savez(work / "batch.npz", **batch)
    np.savez(work / "draws.npz", **draws)
    case = _mask_case()
    np.savez(work / "mask_case.npz", **case)
    ranks = torch_dp_worker.launch("step", work, work, RANKS)

    # The JAX package's step on a 2-device data mesh, same inputs.
    mesh = make_mesh(RANKS)
    tx = j_make_optimizer(jcfg.optim, 1, jcfg.train.epochs)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                        batch_stats=variables["batch_stats"],
                        opt_state=tx.init(variables["params"]), rng=key)
    train_step, _ = jloop.make_step_fns(jmodel, jcfg, mesh)
    new_state, metrics = train_step(jax.device_put(state, replicated(mesh)),
                                    shard_batch(mesh, batch))
    exp_after = hourglass_from_jax(jax.device_get(
        {"params": new_state.params, "batch_stats": new_state.batch_stats}),
        STACKS)

    # The port's own step on the whole batch, one process, in fp64.
    one = torch_dp_worker.fp64_steps(cfg64, weights, batch, 2)
    return dict(ranks=ranks, exp=jax.device_get(metrics), exp_after=exp_after,
                start=weights, lr=jcfg.optim.lr, one=one, case=case,
                cfg=cfg32)


def test_ranks_joined_one_gloo_group(run):
    assert [r["world"] for r in run["ranks"]] == [
        {"backend": "gloo", "rank": r, "world_size": RANKS} for r in range(RANKS)]


def test_ranks_bitwise_equal(run):
    a, b = (r["fp32"] for r in run["ranks"])
    for k in a["metrics"]:
        assert torch.equal(a["metrics"][k], b["metrics"][k]), k
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k
    for s in range(2):
        x, y = (r["fp64"]["state"][s] for r in run["ranks"])
        assert all(torch.equal(x[k], y[k]) for k in x)


@pytest.mark.parametrize("key", ["loss", "euclidean", "reg"])
def test_fp32_loss_and_aux_match_jax(run, key):
    got = run["ranks"][0]["fp32"]["metrics"][key]
    assert got.shape == ()
    np.testing.assert_allclose(got.numpy(), run["exp"][key], rtol=1e-4)


def test_fp32_grad_norm_matches_jax(run):
    got = run["ranks"][0]["fp32"]["metrics"]["grad_norm"]
    np.testing.assert_allclose(got.numpy(), run["exp"]["grad_norm"], rtol=2e-2)


def test_fp32_updated_params_match_jax(run):
    after = run["ranks"][0]["fp32"]["state"]
    full = 10 * run["lr"]
    agree = total = 0
    for name, start in run["start"].items():
        if "running" in name or name.endswith(ZERO_GRAD_BIASES):
            continue
        got = after[name].numpy() - start
        exp = run["exp_after"][name] - start
        np.testing.assert_allclose(np.linalg.norm(got), np.linalg.norm(exp),
                                   rtol=3e-2, err_msg=name)
        agree += int((np.abs(got - exp) <= 0.05 * full).sum())
        total += got.size
    assert total > 150_000
    assert agree / total >= 0.95, agree / total


def test_fp32_batch_stats_match_jax(run):
    after = run["ranks"][0]["fp32"]["state"]
    keys = [k for k in run["exp_after"] if "running" in k]
    assert len(keys) > 100
    for k in keys:
        got, exp = after[k].numpy(), run["exp_after"][k]
        if k.endswith("running_mean"):
            np.testing.assert_allclose(got, exp, rtol=0, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_allclose(got, exp, rtol=1e-2, err_msg=k)
    # Global-batch statistics: each rank's half alone would move them elsewhere.
    stem = next(k for k in keys if k.endswith("stem_bn.running_mean"))
    assert not np.allclose(after[stem].numpy(), run["start"][stem])


def test_collectives_per_step(run):
    # One all-reduce per BN forward and per BN backward, the mask count,
    # the metrics, and one gradient bucket (the model is ~1 MB).
    r = run["ranks"][0]["fp32"]
    assert r["bns"] > 50
    assert r["collectives"] == {"all_reduce": 2 * r["bns"] + 3, "broadcast": 0}


@pytest.mark.parametrize("step", [0, 1])
def test_fp64_matches_one_process(run, step):
    got = run["ranks"][1]["fp64"]
    exp = run["one"]
    for k, v in exp["metrics"][step].items():
        np.testing.assert_allclose(got["metrics"][step][k].numpy(), v.numpy(),
                                   rtol=1e-10, err_msg=k)
    state, ref = got["state"][step], exp["state"][step]
    assert all(v.dtype == torch.float64 for v in state.values()
               if v.is_floating_point())
    for k, v in ref.items():
        v = v.numpy()
        np.testing.assert_allclose(state[k].numpy(), v, rtol=0,
                                   atol=1e-10 * max(np.abs(v).max(), 1.0),
                                   err_msg=k)


def test_mask_sum_is_global(run):
    case, cfg = run["case"], run["cfg"].model
    shares = [r["mask_case"] for r in run["ranks"]]
    assert shares[0]["visible"] < shares[1]["visible"] / 2
    whole, _ = heads.pose_loss(heads.PoseOutput(torch.from_numpy(case["raw"])),
                               torch.from_numpy(case["coords"]),
                               torch.from_numpy(case["mask"]), cfg)
    for s in shares:
        np.testing.assert_allclose(s["total"].item(), whole.item(), rtol=1e-6)
    np.testing.assert_allclose(sum(s["share"].item() for s in shares),
                               whole.item(), rtol=1e-6)
    # A mean of the ranks' own masked means is another number.
    half = BATCH // 2
    means = [heads.pose_loss(
        heads.PoseOutput(torch.from_numpy(case["raw"][:, rows])),
        torch.from_numpy(case["coords"][rows]),
        torch.from_numpy(case["mask"][rows]), cfg)[0].item()
        for rows in (slice(0, half), slice(half, BATCH))]
    assert abs(np.mean(means) - whole.item()) > 1e-3 * whole.item()


def test_debug_nans_raises_on_every_rank(run):
    assert [r["debug_nans"] for r in run["ranks"]] == [
        "debug_nans: the gradient of w is not finite"] * RANKS
