"""The port's data-parallel eval pass and ``EvalDriver.predict`` over 2 gloo
ranks, against the JAX package on a 2-device ``data`` mesh, on the CPU.

33 val rows (an odd tail: the host split pads rank 1's stream with a masked
row, the last global batch pads both), batch 8 (4 a rank), hg1 of depth 1,
32 features, 32-px input, fp32, JS head, the same perturbed weights.  Each
rank runs ``tests/torch_dp_worker.py``'s job ``eval``: the streaming pass
over its host split (``ShardedLoader(num_hosts=2, host_id=rank)``), the
resident scan over its strided shard, and ``predict``.  The JAX side runs
the same global batches (its loader's two host streams, concatenated as a
2-host run assembles them) and the same resident layout on 2 devices.
Tolerances of ``tests/test_torch_eval_driver.py``: loss rtol 1e-4,
predictions atol 1e-2 original px, PCKh counts equal; the ranks agree
bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from dsnt_pose2d_tpu.data import ArrayDataset as JArrayDataset
from dsnt_pose2d_tpu.data import ShardedLoader as JShardedLoader
from dsnt_pose2d_tpu.data.resident import ResidentEvalData as JResidentEvalData
from dsnt_pose2d_tpu.data.synthetic import make_synthetic_mpii as j_synth
from dsnt_pose2d_tpu.models.factory import build_pose_model as j_build
from dsnt_pose2d_tpu.parallel.mesh import make_mesh, replicated, shard_batch
from dsnt_pose2d_tpu.train import loop as jloop
from dsnt_pose2d_tpu.utils import config as jconfig
from dsnt_pose2d_tpu_torch.models.from_jax import hourglass_from_jax
from port_helpers import perturb
import torch_dp_worker

N, BATCH, RANKS, J = 33, 8, 2, 16
JCFG = jconfig.Config(
    model=jconfig.ModelConfig(base="hg1", hg_features=32, hg_depth=1,
                              input_size=32, dtype="float32", reg="js",
                              use_pallas=False),
    data=jconfig.DataConfig(warp_method="shear"),
    train=jconfig.TrainConfig(batch_size=BATCH))
LOSS_RTOL = 1e-4
PRED_ATOL_PX = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_counts(step_outputs):
    correct = sum(np.asarray(o["pckh_correct"]) for o in step_outputs)
    total = sum(np.asarray(o["pckh_total"]) for o in step_outputs)
    return {"loss": float(np.mean([float(o["loss"]) for o in step_outputs])),
            "correct": correct, "total": total}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("dp_eval")
    split = j_synth(N, 48, seed=4)
    jmodel = j_build(JCFG.model)
    variables = perturb(jmodel.init_variables(jax.random.PRNGKey(0)), seed=1)
    (work / "cfg.json").write_text(jconfig.config_to_json(JCFG))
    np.savez(work / "weights.npz", **hourglass_from_jax(variables, 1, depth=1))
    np.savez(work / "split.npz", **split)
    ranks = torch_dp_worker.launch("eval", work, work, RANKS)

    mesh = make_mesh(RANKS)
    driver = jloop.EvalDriver(
        model=jmodel, cfg=JCFG, mesh=mesh,
        loader=JShardedLoader(JArrayDataset(split), BATCH, shuffle=False,
                              drop_last=False))
    state = jax.device_put(driver.init_state().replace(
        params=variables["params"], batch_stats=variables["batch_stats"]),
        replicated(mesh))
    # The global batches of a 2-host run: host 0's rows, then host 1's.
    hosts = [JShardedLoader(JArrayDataset(split), BATCH, shuffle=False,
                            drop_last=False, num_hosts=RANKS, host_id=h)
             for h in range(RANKS)]
    streamed = []
    for parts in zip(*(h.epoch(0) for h in hosts), strict=True):
        batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        streamed.append(jax.device_get(driver.eval_step(state, shard_batch(mesh, batch))))
    res = JResidentEvalData(JArrayDataset(split), BATCH, mesh)
    resident = jloop.run_evaluation_resident_scan(
        jloop.make_resident_eval_scan(jmodel, JCFG, mesh), state, res, J)
    return dict(ranks=ranks, streamed=_jax_counts(streamed),
                resident={"loss": resident["loss"],
                          "correct": resident["evaluator"].correct,
                          "total": resident["evaluator"].total},
                preds=driver.predict(state), split=split,
                gidx=hosts[0].global_index_batches(0))


@pytest.mark.parametrize("path", ["streamed", "resident"])
def test_eval_counts_and_loss_match_jax(run, path):
    for r in run["ranks"]:
        got, exp = r[path], run[path]
        np.testing.assert_array_equal(got["total"], exp["total"])
        np.testing.assert_array_equal(got["correct"], exp["correct"])
        np.testing.assert_allclose(got["loss"], exp["loss"], rtol=LOSS_RTOL)
    # Pad rows count nowhere: the totals are the split's visible joints.
    assert run["ranks"][0][path]["total"].sum() == run["split"]["mask"].sum()
    a, b = (r[path] for r in run["ranks"])
    assert a["loss"] == b["loss"]
    np.testing.assert_array_equal(a["correct"], b["correct"])


def test_predict_matches_jax_in_dataset_order(run):
    a, b = (r["preds"] for r in run["ranks"])
    assert a.shape == run["preds"].shape == (N, J, 2) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, run["preds"], atol=PRED_ATOL_PX, rtol=0)


def test_global_index_map_covers_each_row_once(run):
    got = run["ranks"][0]["gidx"]
    # 17 rows a host (rank 1's last one a pad row), 5 steps of 4 each.
    assert len(got) == run["ranks"][0]["steps"] == len(run["gidx"]) == 5
    for g, e in zip(got, run["gidx"]):
        np.testing.assert_array_equal(g, e)
    rows = np.concatenate(got)
    assert (rows == -1).sum() == 5 * BATCH - N
    np.testing.assert_array_equal(np.sort(rows[rows >= 0]), np.arange(N))
