"""The port's eval passes against the JAX package's, on the CPU.

- ``ResidentEvalData``'s per-step ``(idx, valid)`` and ``host_rows`` equal
  the JAX package's on a 1-device mesh (n in {8, 13, 32}, batch 8).
- On identical weights (the JAX model's, perturbed, converted with
  ``models/from_jax.py``), each of the port's three runners
  (``run_evaluation`` over a ``ShardedLoader(drop_last=False)``,
  ``run_evaluation_resident`` and ``run_evaluation_resident_scan``) matches
  the JAX package's ``run_evaluation`` on the same 13-row val split (two
  steps of 8, the second with 3 pad rows): PCKh counts equal, loss rtol
  1e-5 (measured 1.3e-7).  Both sides in fp32 (hg1 of depth 2, 32
  features, 32-px input, 48-px canvases); the step's own parity is held in
  fp64 elsewhere (``tests/test_torch_train_step.py``).
- The port's resident scan equals its sequential resident steps bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from dsnt_pose2d_tpu.data import ArrayDataset as JArrayDataset
from dsnt_pose2d_tpu.data import ShardedLoader as JShardedLoader
from dsnt_pose2d_tpu.data import make_synthetic_mpii as j_synth
from dsnt_pose2d_tpu.data.resident import ResidentEvalData as JResidentEvalData
from dsnt_pose2d_tpu.models.factory import build_pose_model as j_build
from dsnt_pose2d_tpu.parallel.mesh import make_mesh, replicated
from dsnt_pose2d_tpu.train import loop as jloop
from dsnt_pose2d_tpu.train.state import create_train_state as j_create_state
from dsnt_pose2d_tpu.utils import config as jconfig
from dsnt_pose2d_tpu_torch.data.loader import ShardedLoader
from dsnt_pose2d_tpu_torch.data.mpii import ArrayDataset
from dsnt_pose2d_tpu_torch.data.resident import ResidentEvalData
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
from dsnt_pose2d_tpu_torch.models.from_jax import hourglass_from_jax
from dsnt_pose2d_tpu_torch.train import loop as tloop
from dsnt_pose2d_tpu_torch.utils import config as tconfig
from port_helpers import perturb

JCFG = jconfig.Config(
    model=jconfig.ModelConfig(base="hg1", hg_features=32, hg_depth=2,
                              input_size=32, dtype="float32", reg="js",
                              use_pallas=False),
    data=jconfig.DataConfig(mean=(0, 0, 0), std=(1, 1, 1)),
    train=jconfig.TrainConfig(batch_size=8))
TCFG = tconfig.config_from_json(jconfig.config_to_json(JCFG))
BATCH = 8


@pytest.mark.parametrize("n", [8, 13, 32])
def test_resident_eval_data_matches_jax(n):
    data = j_synth(n, canvas_size=16, seed=n)
    got = ResidentEvalData(ArrayDataset(data), BATCH, "cpu")
    exp = JResidentEvalData(JArrayDataset(data), BATCH, make_mesh(1))
    assert got.steps_per_epoch == exp.steps_per_epoch == -(-n // BATCH)
    assert got.nbytes == exp.nbytes
    for s in range(got.steps_per_epoch):
        for a, b in zip(got._step_host_arrays(s), exp._step_host_arrays(s)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.host_rows(s), exp.host_rows(s))
    idxs, valids = got.epoch_stacked()
    exp_idxs, exp_valids = exp.epoch_stacked()
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(exp_idxs))
    np.testing.assert_array_equal(valids.numpy(), np.asarray(exp_valids))
    assert valids.sum().item() == n
    for (idx, valid), i, v in zip(got.epoch(), idxs, valids):
        assert torch.equal(idx, i) and torch.equal(valid, v)
    for k, a in data.items():
        np.testing.assert_array_equal(got.resident[k].numpy(), a)


@pytest.fixture(scope="module")
def val_split():
    jmodel = j_build(JCFG.model)
    variables = perturb(jmodel.init_variables(jax.random.PRNGKey(0)), seed=2)
    data = j_synth(13, canvas_size=48, seed=21)
    mesh = make_mesh(1)
    state = j_create_state(jmodel, JCFG.optim, jax.random.PRNGKey(0),
                           batch_size=2)
    state = jax.device_put(
        state.replace(params=variables["params"],
                      batch_stats=variables["batch_stats"]), replicated(mesh))
    exp = jloop.run_evaluation(
        jloop.make_eval_fn(jmodel, JCFG, mesh), state, mesh,
        JShardedLoader(JArrayDataset(data), BATCH, shuffle=False,
                       drop_last=False), 16)
    model = build_pose_model(
        TCFG.model, device="cpu",
        state_dict={k: torch.from_numpy(np.array(v)) for k, v in
                    hourglass_from_jax(variables, 1, depth=2).items()})
    return model, data, exp


def _port_runner(name, model, data):
    eval_step = tloop.make_eval_fn(model, TCFG, "cpu")
    ds = ArrayDataset(data)
    if name == "streaming":
        return tloop.run_evaluation(
            eval_step, "cpu",
            ShardedLoader(ds, BATCH, shuffle=False, drop_last=False), 16)
    res = ResidentEvalData(ds, BATCH, "cpu")
    if name == "resident":
        return tloop.run_evaluation_resident(
            tloop.make_resident_eval_step(model, TCFG, "cpu", eval_step),
            res, 16)
    return tloop.run_evaluation_resident_scan(
        tloop.make_resident_eval_scan(model, TCFG, "cpu", eval_step), res, 16)


@pytest.mark.parametrize("runner", ["streaming", "resident", "resident_scan"])
def test_runner_matches_jax_run_evaluation(val_split, runner):
    model, data, exp = val_split
    got = _port_runner(runner, model, data)
    assert set(got) == set(exp) == {"loss", "pckh", "evaluator"}
    np.testing.assert_array_equal(got["evaluator"].total,
                                  exp["evaluator"].total)
    assert got["evaluator"].total.sum() == data["mask"].sum()
    np.testing.assert_array_equal(got["evaluator"].correct,
                                  exp["evaluator"].correct)
    assert got["pckh"] == exp["pckh"]
    np.testing.assert_allclose(got["loss"], exp["loss"], rtol=1e-5)


def test_resident_scan_is_sequential_resident_steps_bitwise(val_split):
    model, data, _ = val_split
    res = ResidentEvalData(ArrayDataset(data), BATCH, "cpu")
    step = tloop.make_resident_eval_step(model, TCFG, "cpu")
    scan = tloop.make_resident_eval_scan(model, TCFG, "cpu")
    stacked = scan(res.resident, *res.epoch_stacked())
    seq = [step(res.resident, idx, valid) for idx, valid in res.epoch()]
    assert stacked["loss"].shape == (2,)
    assert stacked["pred_orig"].shape == (2, BATCH, 16, 2)
    for k, v in stacked.items():
        for s, out in enumerate(seq):
            assert torch.equal(v[s], out[k]), (k, s)


def test_pad_rows_count_nowhere(val_split):
    # The resident step's valid vector zeroes the pad rows' mask: the last
    # step (5 real rows + 3 pads of row 12) counts row 12 once.
    model, data, _ = val_split
    res = ResidentEvalData(ArrayDataset(data), BATCH, "cpu")
    step = tloop.make_resident_eval_step(model, TCFG, "cpu")
    idx, valid = list(res.epoch())[1]
    assert idx.tolist() == [8, 9, 10, 11, 12, 12, 12, 12]
    out = step(res.resident, idx, valid)
    np.testing.assert_array_equal(out["pckh_total"].numpy(),
                                  data["mask"][8:].sum(axis=0))
