"""The port's Trainer against the JAX package's, on the CPU.

**Orchestration.**  Both packages' ``Trainer`` run the tiny config of
``tests/test_train.py`` (hg1 of depth 2, 32 features, 32-px input, batch
8) for 2 epochs of 4 steps on the same 32-row train split and 13-row val
split (48-px synthetic canvases), with mid-epoch saves every 2 steps, from
the same weights (the JAX model's, converted with ``models/from_jax.py``).
Two input modes: resident with ``steps_per_dispatch`` 2 (multi-step
dispatch, the resident eval scan) and streaming with ``steps_per_dispatch``
4, which both packages clamp to 1 (single steps, the streaming eval pass).
The augmentation is made deterministic (no rotation, scale 1, no flip, no
color jitter), so the port's ``torch.Generator`` draws and JAX's
``fold_in`` draws are the same constants.  The optimizer is SGD with
momentum: RMSProp's first steps are ~lr * sign(g), which turns fp32
rounding into whole steps (measured: 1.7% apart in loss after 4 steps).
Both packages agree on the metric records' ``epoch``/``step`` keys, their
cadence and their key sets, the epoch summaries' keys, which epochs and
steps were saved, ``best.json``'s epoch, the sample renders' names and the
clamp message.  Values, fp32 on both sides: the logged and epoch losses
(and euclidean and reg) within rtol 5e-5 (measured at most 1.1e-5 over the
8 steps), the grad norm within 2e-2 (measured 5.4e-3; flax's fp32 BN batch
statistics, see ``tests/test_torch_train_step.py``), the val PCKh counts of
each epoch and of a final pass exactly equal.

**Mid-epoch resume, bitwise.**  The port's counterpart of
``tests/test_train.py::test_mid_epoch_resume_bit_exact``: a run of 2 epochs
x 4 steps dies in epoch 0 after its step-2 save; a fresh Trainer restores
that save in place and runs on; its parameters, BN statistics, optimizer
state, ``OptimizerChain.count`` and step equal the uninterrupted run's bit
for bit.  Cases: streaming k=1, resident k=2, and streaming across a
``step``-schedule boundary at epoch 1 (a lost count would keep the
undropped learning rate there).
"""

import contextlib
import dataclasses
import io
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from dsnt_pose2d_tpu.data import ArrayDataset as JArrayDataset
from dsnt_pose2d_tpu.data import ShardedLoader as JShardedLoader
from dsnt_pose2d_tpu.data import make_synthetic_mpii as j_synth
from dsnt_pose2d_tpu.models.factory import build_pose_model as j_build
from dsnt_pose2d_tpu.parallel.mesh import make_mesh
from dsnt_pose2d_tpu.train import loop as jloop
from dsnt_pose2d_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from dsnt_pose2d_tpu.train.metrics import MetricWriter as JMetricWriter
from dsnt_pose2d_tpu.utils import config as jconfig
from dsnt_pose2d_tpu.utils import visualization as jvis
from dsnt_pose2d_tpu_torch.data.loader import ShardedLoader
from dsnt_pose2d_tpu_torch.data.mpii import ArrayDataset
from dsnt_pose2d_tpu_torch.data.transforms import transform_coords
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
from dsnt_pose2d_tpu_torch.models.from_jax import hourglass_from_jax
from dsnt_pose2d_tpu_torch.train import loop as tloop
from dsnt_pose2d_tpu_torch.train.checkpoint import CheckpointManager
from dsnt_pose2d_tpu_torch.train.loop import Trainer
from dsnt_pose2d_tpu_torch.train.metrics import MetricWriter
from dsnt_pose2d_tpu_torch.utils import config as tconfig
from dsnt_pose2d_tpu_torch.utils import visualization as tvis

MODEL = jconfig.ModelConfig(base="hg1", output_strat="dsnt", reg="js",
                            hg_features=32, hg_depth=2, input_size=32,
                            dtype="float32", use_pallas=False)
TRAIN = j_synth(32, canvas_size=48, seed=11)
VAL = j_synth(13, canvas_size=48, seed=12)
LOSS_RTOL = 5e-5
GRAD_NORM_RTOL = 2e-2
MODES = {"resident_k2": ("auto", 2), "streaming_clamped": ("off", 4)}


def _jax_config(resident: str, k: int) -> jconfig.Config:
    return jconfig.Config(
        model=MODEL,
        optim=jconfig.OptimConfig(optimizer="sgd", lr=1e-3, momentum=0.9,
                                  schedule="constant"),
        data=jconfig.DataConfig(mean=(0, 0, 0), std=(1, 1, 1),
                                color_jitter=0.0, max_rotation_deg=0.0,
                                scale_range=(1.0, 1.0), flip_prob=0.0,
                                device_resident=resident),
        train=jconfig.TrainConfig(batch_size=8, seed=0, log_every_steps=1,
                                  donate=False, epochs=2, eval_every_epochs=1,
                                  checkpoint_every_steps=2,
                                  steps_per_dispatch=k))


def _outputs(out_dir: str, printed: str, final_eval: dict) -> dict:
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    for r in records:
        r.pop("time")
    with open(os.path.join(out_dir, "best.json")) as f:
        best_epoch = json.load(f)["epoch"]
    return {
        "steps": [r for r in records if "step" in r],
        "summaries": [r for r in records if "step" not in r],
        "saved": {s: sorted(os.listdir(os.path.join(out_dir, s)), key=int)
                  for s in ("ckpt", "ckpt_best", "ckpt_step")},
        "best_epoch": best_epoch,
        "samples": sorted(os.listdir(os.path.join(out_dir, "samples"))),
        "clamp": [ln for ln in printed.splitlines() if "steps_per_dispatch" in ln],
        "final_eval": final_eval,
    }


@pytest.fixture(scope="module", params=list(MODES))
def runs(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    jcfg = _jax_config(*MODES[request.param])
    tcfg = tconfig.config_from_json(jconfig.config_to_json(jcfg))

    out = str(tmp / "jax")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        jt = jloop.Trainer(
            model=j_build(jcfg.model), cfg=jcfg, mesh=make_mesh(1),
            train_loader=JShardedLoader(JArrayDataset(TRAIN), 8, shuffle=True,
                                        seed=0),
            val_loader=JShardedLoader(JArrayDataset(VAL), 8, shuffle=False,
                                      drop_last=False),
            checkpointer=JCheckpointManager(out, jcfg, max_to_keep=2),
            metric_writer=JMetricWriter(out, echo=False))
    state = jt.init_state()
    variables = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    state, _ = jt.run(state)
    jt.checkpointer.close()
    exp = _outputs(out, printed.getvalue(), jt.evaluate(state)["evaluator"])

    out = str(tmp / "torch")
    model = build_pose_model(
        tcfg.model, device="cpu",
        state_dict={k: torch.from_numpy(np.array(v)) for k, v in
                    hourglass_from_jax(variables, 1, depth=2).items()})
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        tt = Trainer(
            model=model, cfg=tcfg,
            train_loader=ShardedLoader(ArrayDataset(TRAIN), 8, shuffle=True,
                                       seed=0),
            val_loader=ShardedLoader(ArrayDataset(VAL), 8, shuffle=False,
                                     drop_last=False),
            checkpointer=CheckpointManager(out, tcfg, max_to_keep=2),
            metric_writer=MetricWriter(out, echo=False), device="cpu")
    assert (tt.resident is None) == (jt.resident is None)
    assert (tt.resident_multi is None) == (jt.resident_multi is None)
    assert (tt.val_resident is None) == (jt.val_resident is None)
    state, best = tt.run()
    assert state is tt.init_state() and state.step == 8
    got = _outputs(out, printed.getvalue(), tt.evaluate()["evaluator"])
    return request.param, got, exp


def test_step_records_match_jax(runs):
    mode, got, exp = runs
    cadence = [(r["epoch"], r["step"]) for r in got["steps"]]
    assert cadence == [(r["epoch"], r["step"]) for r in exp["steps"]]
    if mode == "resident_k2":   # one record per dispatch: its last loss
        assert cadence == [(0, 2), (0, 4), (1, 6), (1, 8)]
    else:                       # every single step, the full metrics
        assert cadence == [(e, s) for e in (0, 1) for s in range(4 * e + 1, 4 * e + 5)]
    for g, e in zip(got["steps"], exp["steps"]):
        assert sorted(g) == sorted(e)
        for k in set(g) - {"epoch", "step"}:
            rtol = GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL
            np.testing.assert_allclose(g[k], e[k], rtol=rtol, err_msg=k)


def test_epoch_summaries_match_jax(runs):
    _, got, exp = runs
    assert len(got["summaries"]) == len(exp["summaries"]) == 2
    for epoch, (g, e) in enumerate(zip(got["summaries"], exp["summaries"])):
        assert list(g) == list(e) == [
            "epoch", "train_loss", "epoch_seconds", "images_per_sec",
            "val_loss", "val_pckh", "eval_seconds", "ckpt_seconds"]
        assert g["epoch"] == epoch
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(g[k], e[k], rtol=LOSS_RTOL, err_msg=k)
        assert g["val_pckh"] == e["val_pckh"]


def test_final_eval_counts_match_jax(runs):
    _, got, exp = runs
    np.testing.assert_array_equal(got["final_eval"].total, exp["final_eval"].total)
    np.testing.assert_array_equal(got["final_eval"].correct,
                                  exp["final_eval"].correct)
    assert got["final_eval"].correct.sum() > 0


def test_checkpoints_and_samples_match_jax(runs):
    _, got, exp = runs
    assert got["saved"] == exp["saved"] == {
        "ckpt": ["0", "1"], "ckpt_best": [str(exp["best_epoch"])],
        "ckpt_step": ["2", "6"]}
    assert got["best_epoch"] == exp["best_epoch"]
    assert got["samples"] == exp["samples"] == [
        f"epoch{e:04d}_s{i}.png" for e in (0, 1) for i in range(4)]


def test_streaming_clamp_matches_jax(runs):
    mode, got, exp = runs
    assert got["clamp"] == exp["clamp"]
    if mode == "streaming_clamped":
        assert got["clamp"] and got["clamp"][0].startswith(
            "steps_per_dispatch=4 clamped to 1 on the streaming input path")
    else:
        assert not got["clamp"]


def test_val_split_charged_beside_train_split(monkeypatch):
    # With a budget that holds the train split but not both splits, both
    # packages stage the train split and stream the eval.
    jcfg = _jax_config("auto", 2)
    tcfg = tconfig.config_from_json(jconfig.config_to_json(jcfg))
    train_bytes = sum(a.nbytes for a in TRAIN.values())
    monkeypatch.setenv("DSNT_RESIDENT_BUDGET_BYTES", str(train_bytes + 1000))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        jt = jloop.Trainer(
            model=j_build(jcfg.model), cfg=jcfg, mesh=make_mesh(1),
            train_loader=JShardedLoader(JArrayDataset(TRAIN), 8, shuffle=True),
            val_loader=JShardedLoader(JArrayDataset(VAL), 8, shuffle=False,
                                      drop_last=False))
        tt = Trainer(
            model=build_pose_model(tcfg.model, device="cpu"), cfg=tcfg,
            train_loader=ShardedLoader(ArrayDataset(TRAIN), 8, shuffle=True),
            val_loader=ShardedLoader(ArrayDataset(VAL), 8, shuffle=False,
                                     drop_last=False), device="cpu")
    assert jt.resident is not None and tt.resident is not None
    assert jt.val_resident is None and tt.val_resident is None
    assert tt.resident.nbytes == train_bytes
    assert printed.getvalue().count("val split does not fit beside") == 2


# -- mid-epoch resume ---------------------------------------------------------


class _Bomb(Exception):
    pass


class _BombWriter:
    """Metric writer that stops the run at its n-th step record."""

    path = None

    def __init__(self, n):
        self.left = n

    def write(self, record):
        if "loss" in record and "train_loss" not in record:
            self.left -= 1
            if self.left == 0:
                raise _Bomb


RESUME_CASES = {
    # name: (device_resident, steps_per_dispatch, step records before the
    # bomb, optimizer config)
    "streaming_k1": ("off", 1, 3, dict(lr=2e-3, schedule="constant")),
    "resident_k2": ("on", 2, 2, dict(lr=2e-3, schedule="constant")),
    "lr_boundary": ("off", 1, 3, dict(lr=2e-3, schedule="step",
                                      lr_drop_epochs=(1,), lr_drop_factor=0.1)),
}


def _resume_config(resident, k, optim) -> tconfig.Config:
    return tconfig.Config(
        model=tconfig.ModelConfig(base="hg1", reg="js", hg_features=16,
                                  hg_depth=2, input_size=32, dtype="float32"),
        optim=tconfig.OptimConfig(**optim),
        data=tconfig.DataConfig(mean=(0, 0, 0), std=(1, 1, 1),
                                max_rotation_deg=10.0, scale_range=(0.9, 1.1),
                                device_resident=resident),
        train=tconfig.TrainConfig(batch_size=8, seed=0, log_every_steps=1,
                                  epochs=2, eval_every_epochs=10,
                                  checkpoint_every_steps=2,
                                  steps_per_dispatch=k))


def _resume_trainer(cfg, ckpt=None, writer=None):
    return Trainer(model=build_pose_model(cfg.model, device="cpu", seed=0),
                   cfg=cfg,
                   train_loader=ShardedLoader(ArrayDataset(TRAIN), 8,
                                              shuffle=True, seed=0),
                   checkpointer=ckpt, metric_writer=writer, device="cpu")


def _assert_bitwise_equal(a, b):
    sa, sb = a.model.net.state_dict(), b.model.net.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.optimizer.state_dict(), b.optimizer.optimizer.state_dict()
    assert len(oa["state"]) == len(ob["state"]) > 50
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert oa["param_groups"] == ob["param_groups"]
    assert (a.step, a.optimizer.count) == (b.step, b.optimizer.count) == (8, 8)


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_mid_epoch_resume_bitwise(tmp_path, case):
    resident, k, bomb, optim = RESUME_CASES[case]
    cfg = _resume_config(resident, k, optim)
    state_a, _ = _resume_trainer(cfg).run()

    ckpt = CheckpointManager(str(tmp_path / "exp"), cfg, max_to_keep=2)
    with pytest.raises(_Bomb):
        _resume_trainer(cfg, ckpt, _BombWriter(bomb)).run()
    assert os.listdir(tmp_path / "exp" / "ckpt") == []
    assert os.listdir(tmp_path / "exp" / "ckpt_step") == ["2"]

    trainer_c = _resume_trainer(cfg, ckpt)
    restored, meta = ckpt.restore_latest(trainer_c.init_state())
    assert restored is trainer_c.init_state()
    assert (meta["epoch"], meta["step_in_epoch"], restored.step) == (0, 2, 2)
    assert restored.optimizer.count == 2
    state_c, _ = trainer_c.run(restored, start_epoch=meta["epoch"],
                               start_step=meta["step_in_epoch"])
    _assert_bitwise_equal(state_a, state_c)
    if case == "lr_boundary":
        assert state_c.optimizer.optimizer.param_groups[0]["lr"] == pytest.approx(2e-4)


# -- what the port refuses, loudly; auto-pack's wrapper ----------------------


class _DecodeBacked(ArrayDataset):
    """A train set that decodes its images (the MPIIDataset surface that
    auto-pack keys on)."""

    images_dir = "images"
    canvas_size = 48


def _tiny_cfg(**data_kw):
    cfg = _resume_config("off", 1, dict(lr=2e-3, schedule="constant"))
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **data_kw))


def test_auto_pack_of_a_decode_backed_set_raises(tmp_path):
    # Auto-pack is ported (tests/test_torch_autopack.py runs it against the
    # JAX Trainer): with auto_pack on, a decode-backed train set is wrapped
    # and epoch 0 streams it.  What raises, as in the JAX package, is
    # device_resident=on for it: the split is not array-backed until the
    # archive is published.
    from dsnt_pose2d_tpu_torch.data.pack import AutoPackDataset

    cfg = _tiny_cfg(data_dir=str(tmp_path))
    assert cfg.data.auto_pack
    model = build_pose_model(cfg.model, device="cpu")
    trainer = Trainer(model=model, cfg=cfg, device="cpu",
                      train_loader=ShardedLoader(_DecodeBacked(TRAIN), 8,
                                                 shuffle=True))
    assert isinstance(trainer.train_loader.dataset, AutoPackDataset)
    assert trainer._autopack is trainer.train_loader.dataset
    assert trainer.resident is None
    assert os.listdir(tmp_path / "packed") == ["train_canvases.npy.building"]
    with pytest.raises(ValueError, match="not array-backed"):
        Trainer(model=model, cfg=_tiny_cfg(data_dir=str(tmp_path / "on"),
                                           device_resident="on"),
                train_loader=ShardedLoader(_DecodeBacked(TRAIN), 8, shuffle=True),
                device="cpu")
    loader = ShardedLoader(_DecodeBacked(TRAIN), 8, shuffle=True)
    trainer = Trainer(model=model, cfg=_tiny_cfg(auto_pack=False),
                      train_loader=loader, device="cpu")
    assert trainer.resident is None and trainer._autopack is None
    assert trainer.train_loader.dataset is loader.dataset


def test_run_refuses_another_state():
    cfg = _tiny_cfg()
    trainer = _resume_trainer(cfg)
    other = _resume_trainer(cfg).init_state()
    with pytest.raises(ValueError, match="own state"):
        trainer.run(other)
    assert trainer.init_state().step == 0


# -- sample renders -----------------------------------------------------------


def test_dump_samples_decode_to_the_renders(tmp_path):
    rng = np.random.default_rng(0)
    batch = {"canvases": rng.uniform(0, 1, (5, 40, 36, 3)).astype(np.float32),
             "mask": (rng.uniform(size=(5, 16)) > 0.2).astype(np.float32),
             "canvas_from_orig": np.tile(np.array(
                 [[1.5, 0, 3.0], [0, 1.5, -2.0], [0, 0, 1]], np.float32), (5, 1, 1))}
    pred = rng.uniform(0, 26, (5, 16, 2)).astype(np.float32)
    tloop._dump_samples(str(tmp_path / "t"), 7, batch, pred)
    jloop._dump_samples(str(tmp_path / "j"), 7, batch, pred)
    names = [f"epoch0007_s{i}.png" for i in range(4)]
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == names
    pred_canvas = transform_coords(torch.from_numpy(batch["canvas_from_orig"]),
                                   torch.from_numpy(pred)).numpy()
    for i, name in enumerate(names):
        render = tvis.render_skeleton(batch["canvases"][i], pred_canvas[i],
                                      batch["mask"][i])
        assert render.dtype == np.uint8 and render.shape == (40, 36, 3)
        np.testing.assert_array_equal(
            render, jvis.render_skeleton(batch["canvases"][i], pred_canvas[i],
                                         batch["mask"][i]))
        with Image.open(tmp_path / "t" / name) as img:
            assert img.mode == "RGB"
            np.testing.assert_array_equal(np.asarray(img), render)
        with Image.open(tmp_path / "j" / name) as img:
            np.testing.assert_array_equal(np.asarray(img), render)


@pytest.mark.parametrize("shape", [(1, 1, 3), (7, 300, 3)])
def test_save_png_round_trips(tmp_path, shape):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    tvis.save_png(img, str(tmp_path / "x.png"))
    with Image.open(tmp_path / "x.png") as decoded:
        np.testing.assert_array_equal(np.asarray(decoded), img)
    with pytest.raises(ValueError, match="uint8"):
        tvis.save_png(img.astype(np.float32), str(tmp_path / "y.png"))
