"""The port's Trainer and CLIs over 2 gloo ranks, on the CPU.

Job ``trainer`` of ``tests/torch_dp_worker.py``: run A trains hg1 (16
features, 32 px, fp32) for 2 epochs over resident shards (40 train rows,
20 a shard, 5 steps of 8 global rows an epoch in dispatch groups of 2; 13
val rows, resident too), saving mid-epoch checkpoints every 2 steps; run B
restores A's older mid-epoch save into a fresh Trainer on each rank and
trains to the end.  Then ``cli.train`` -> ``cli.evaluate`` -> ``cli.infer``
run on the same 2 ranks (streaming input).

Held: run B ends bitwise equal to run A (parameters, BN statistics,
optimizer state, counts) and the ranks to each other; each rank staged its
own shard only; rank 0 alone wrote the metric records, whose
``images_per_sec`` counts the global batch; ``cli.evaluate``'s PCKh equals
the train run's ``val_pckh``; rank 0 alone printed and wrote the
predictions.
"""

import json

import numpy as np
import pytest
import scipy.io
import torch

from dsnt_pose2d_tpu.data.synthetic import make_synthetic_mpii as j_synth
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
from dsnt_pose2d_tpu_torch.utils import config as tconfig
import torch_dp_worker

RANKS, BATCH, EPOCHS, STEPS = 2, 8, 2, 5
CFG = tconfig.Config(
    model=tconfig.ModelConfig(base="hg1", hg_features=16, hg_depth=2,
                              input_size=32, dtype="float32", reg="js"),
    optim=tconfig.OptimConfig(lr=1e-3),
    data=tconfig.DataConfig(device_resident="on", workers=1),
    train=tconfig.TrainConfig(batch_size=BATCH, epochs=EPOCHS,
                              steps_per_dispatch=2, checkpoint_every_steps=2,
                              log_every_steps=1, seed=3))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("dp_trainer")
    (work / "cfg.json").write_text(tconfig.config_to_json(CFG))
    weights = build_pose_model(CFG.model, device="cpu", seed=0).net.state_dict()
    np.savez(work / "weights.npz", **{k: v.numpy() for k, v in weights.items()})
    np.savez(work / "train.npz", **j_synth(40, 48, seed=1))
    np.savez(work / "val.npz", **j_synth(13, 48, seed=2))
    return torch_dp_worker.launch("trainer", work, work, RANKS), work


def _equal(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_resume_ends_bitwise_equal_to_the_uninterrupted_run(run):
    ranks, _ = run
    for r in ranks:
        # The older of the two kept step saves: epoch 1, two steps in.
        assert r["ckpt_steps"] == [STEPS + 2, STEPS + 4]
        assert (r["resumed_from"]["epoch"], r["resumed_from"]["step_in_epoch"]) == (1, 2)
        assert r["a"]["step"] == r["a"]["count"] == EPOCHS * STEPS
        _equal(r["b"], r["a"])


def test_ranks_bitwise_equal(run):
    ranks, _ = run
    _equal(ranks[0]["a"], ranks[1]["a"])
    assert ranks[0]["best_a"] == ranks[1]["best_a"]


def test_each_rank_stages_its_own_shard(run):
    ranks, _ = run
    for rank, r in enumerate(ranks):
        assert r["resident"] == (RANKS, rank, RANKS)
        assert r["shard_rows"]["canvases"] == (20, 48, 48, 3)


def test_rank0_writes_the_records_with_global_image_counts(run):
    ranks, work = run
    records = [json.loads(x) for x in
               (work / "run_a" / "metrics.jsonl").read_text().splitlines()]
    summaries = [x for x in records if "train_loss" in x]
    assert [x["epoch"] for x in summaries] == list(range(EPOCHS))
    # k=2 dispatch groups log once each: 2 groups an epoch.
    assert len([x for x in records if "step" in x]) == 2 * EPOCHS
    for s in ranks[0]["summaries"]:
        assert s["images_per_sec"] * s["epoch_seconds"] == pytest.approx(STEPS * BATCH)
    for r in ranks:
        assert [s["train_loss"] for s in r["summaries"]] == \
            [s["train_loss"] for s in summaries]
        assert [s["val_pckh"] for s in r["summaries"]] == \
            [s["val_pckh"] for s in summaries]
    assert {p.name for p in (work / "run_a").iterdir()} >= {
        "config.json", "metrics.jsonl", "ckpt", "ckpt_step", "samples"}


def test_clis_over_two_ranks(run):
    ranks, work = run
    for r in ranks:
        assert {k: r["cli"][k] for k in ("train", "evaluate", "infer")} == \
            {"train": 0, "evaluate": 0, "infer": 0}
    records = [json.loads(x) for x in
               (work / "cli" / "dp" / "metrics.jsonl").read_text().splitlines()]
    val = [x["val_pckh"] for x in records if "val_pckh" in x]
    assert len(val) == 1
    assert ranks[0]["cli"]["evaluate_pckh"] == ranks[1]["cli"]["evaluate_pckh"] == val[0]
    preds = scipy.io.loadmat(work / "cli" / "preds.mat")["preds"]
    assert preds.shape == (8, 16, 2) and np.isfinite(preds).all()
    log0 = (work / "cli_rank0.log").read_text()
    log1 = (work / "cli_rank1.log").read_text()
    assert "distributed: backend=gloo world_size=2 device=cpu" in log0
    assert "done; best val PCKh@0.5" in log0 and "wrote (8, 16, 2)" in log0
    assert "PCKh" in log0 and log1.strip() == ""
