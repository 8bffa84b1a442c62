"""The port's train, evaluate and infer CLIs, on the pattern of
``tests/test_cli.py``: the flag surface and the config it builds against the
JAX package's, the checkpoint-config overrides, and the three entry points
end to end on the CPU (``--device cpu``, synthetic data, a tiny hg1).
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dsnt_pose2d_tpu.cli import common as jcommon
from dsnt_pose2d_tpu.cli import evaluate as jevaluate
from dsnt_pose2d_tpu.cli import infer as jinfer
from dsnt_pose2d_tpu.cli import train as jtrain
from dsnt_pose2d_tpu.utils import config as jconfig
from dsnt_pose2d_tpu_torch.cli import common, evaluate, infer, train
from dsnt_pose2d_tpu_torch.train import loop as tloop
from dsnt_pose2d_tpu_torch.train import metrics as tmetrics
from dsnt_pose2d_tpu_torch.train.checkpoint import STATE_FILENAME
from dsnt_pose2d_tpu_torch.utils import config as tconfig

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Tiny models run faster on one intra-op thread, and parallel test
    # workers share the host's cores: more threads only contend.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _jax_parser(main, monkeypatch):
    """The parser a JAX CLI's ``main`` builds (stopped at its parse)."""
    def capture(self, *a, **k):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as e:
        main([])
    monkeypatch.undo()
    return e.value.parser


def _surface(parser, drop: str) -> dict:
    return {a.option_strings[0]: (a.dest, a.default, a.choices, a.type,
                                  a.required, type(a).__name__, a.nargs)
            for a in parser._actions
            if a.option_strings and a.option_strings[0] not in ("-h", drop)}


@pytest.mark.parametrize("name", ["train", "evaluate", "infer"])
def test_flag_surface_matches_jax(name, monkeypatch):
    jmain = {"train": jtrain, "evaluate": jevaluate, "infer": jinfer}[name].main
    port = {"train": train, "evaluate": evaluate, "infer": infer}[name]
    exp = _surface(_jax_parser(jmain, monkeypatch), "--platform")
    got_parser = port.build_parser()
    got = _surface(got_parser, "--device")
    assert got == exp
    device = next(a for a in got_parser._actions if "--device" in a.option_strings)
    assert (device.default, device.choices) == ("cuda", ["cuda", "cpu"])


def _parse(mod, argv):
    p = argparse.ArgumentParser()
    mod.add_model_args(p)
    mod.add_data_args(p)
    mod.add_train_args(p)
    return p.parse_args(argv)


ARGVS = {
    "defaults": [],
    "flagship": ["--base-model", "hg8", "--reg", "js", "--hm-sigma", "1.0",
                 "--batch-size", "32", "--epochs", "120"],
    "everything": ["--base-model", "hg2", "--output-strat", "gauss", "--reg",
                   "kl", "--reg-coeff", "2.5", "--hm-sigma", "0.5", "--dilate",
                   "2", "--truncate", "1", "--preact", "thresholded_softmax",
                   "--hm-threshold", "0.5", "--coord-loss", "l1", "--no-pallas",
                   "--dtype", "float32", "--hg-features", "64", "--input-size",
                   "128", "--data-dir", "/x/mpii", "--data-source", "h5",
                   "--synthetic-size", "40", "--canvas-size", "320",
                   "--warp-method", "gather", "--workers", "2",
                   "--pretrained-resnet", "r.pth", "--device-resident", "off",
                   "--no-auto-pack", "--lr", "1e-3", "--optimizer", "adam",
                   "--schedule", "cosine", "--seed", "3", "--out-dir", "/o",
                   "--experiment-id", "e", "--resume",
                   "--steps-per-dispatch", "4", "--model-parallel", "2"],
}


@pytest.mark.parametrize("argv", list(ARGVS))
def test_config_from_args_matches_jax(argv):
    got = common.config_from_args(_parse(common, ARGVS[argv]))
    exp = jcommon.config_from_args(_parse(jcommon, ARGVS[argv]))
    assert json.loads(tconfig.config_to_json(got)) == json.loads(
        jconfig.config_to_json(exp))
    if got.train.experiment_id:
        assert common.experiment_dir(got) == jcommon.experiment_dir(exp)


def test_experiment_dir_uses_id():
    cfg = common.config_from_args(_parse(common, ["--out-dir", "/tmp/o",
                                                  "--experiment-id", "x1"]))
    assert common.experiment_dir(cfg) == "/tmp/o/x1"


def _override_parser(mod):
    p = argparse.ArgumentParser()
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--flip-eval", action="store_true")
    p.add_argument("--eval-scales", default="1.0")
    mod.add_data_args(p)
    return p


OVERRIDES = {
    "all_data_flags": (dict(), ["--data-dir", "/elsewhere/mpii", "--data-source",
                                "h5", "--canvas-size", "320", "--warp-method",
                                "gather", "--workers", "8", "--batch-size", "4",
                                "--flip-eval"]),
    "defaults_keep_checkpoint": (dict(warp_method="gather", workers=4),
                                 ["--data-dir", "/x"]),
    "explicit_default_and_source_reset": (dict(source="h5", workers=1),
                                          ["--data-dir", "/other", "--workers", "4"]),
    "explicit_source": (dict(source="h5", workers=1),
                        ["--data-dir", "/other", "--data-source", "h5"]),
    "eval_scales": (dict(), ["--eval-scales", "0.9,1.0,1.1"]),
    "nothing": (dict(), []),
}


@pytest.mark.parametrize("case", list(OVERRIDES))
def test_merge_cli_overrides_matches_jax(case):
    data_kw, argv = OVERRIDES[case]
    results = []
    for mod, cfgmod in ((common, tconfig), (jcommon, jconfig)):
        base = cfgmod.Config()
        base = dataclasses.replace(base, data=dataclasses.replace(base.data, **data_kw))
        p = _override_parser(mod)
        merged = mod.merge_cli_overrides(base, p.parse_args(argv), p, argv)
        results.append(json.loads(cfgmod.config_to_json(merged)))
        assert mod.explicit_cli_args(p, argv) == {
            a.lstrip("-").replace("-", "_") for a in argv if a.startswith("--")}
    assert results[0] == results[1]
    merged = results[0]
    if case == "all_data_flags":
        assert merged["data"]["canvas_size"] == 320 and merged["train"]["flip_eval"]
        assert merged["train"]["batch_size"] == 4 and merged["data"]["workers"] == 8
    if case == "explicit_default_and_source_reset":
        assert (merged["data"]["workers"], merged["data"]["source"]) == (4, "auto")
    if case == "explicit_source":
        assert merged["data"]["source"] == "h5"
    if case == "eval_scales":
        assert merged["train"]["eval_scales"] == [0.9, 1.0, 1.1]
    if case == "nothing":
        assert merged["train"]["eval_scales"] == [1.0]
        assert not merged["train"]["flip_eval"]


@pytest.mark.parametrize("spec,expected", [
    ("0.9,1.0,1.1", (0.9, 1.0, 1.1)), ((0.8, 1.2), (0.8, 1.2)),
    ("1.0", (1.0,)), ("0.9; 1.1,", (0.9, 1.1)), ("0,-1", ValueError),
    ("", ValueError), ((), ValueError)])
def test_parse_eval_scales_matches_jax(spec, expected):
    if expected is ValueError:
        for mod in (common, jcommon):
            with pytest.raises(ValueError, match="positive"):
                mod.parse_eval_scales(spec)
        return
    assert common.parse_eval_scales(spec) == jcommon.parse_eval_scales(spec) == expected


def test_dataset_split_method_reads_both_flavors():
    class Annot:
        split_method = "val-list:v.txt"

    class WithAnnot:
        annot = Annot()

    class Packed:
        split_method = "hash-holdout:0.115"

    for ds, exp in ((WithAnnot(), "val-list:v.txt"), (Packed(), "hash-holdout:0.115"),
                    (object(), "")):
        assert common.dataset_split_method(ds) == jcommon.dataset_split_method(ds) == exp


# -- end to end on the CPU ----------------------------------------------------

TINY = ["--device", "cpu", "--base-model", "hg1", "--reg", "js",
        "--hg-features", "16", "--input-size", "64", "--dtype", "float32",
        "--data-source", "synthetic", "--synthetic-size", "16",
        "--batch-size", "4", "--lr", "1e-3", "--workers", "2"]
DATA = ["--data-source", "synthetic", "--synthetic-size", "16", "--device", "cpu"]


class _RecordingDriver(tloop.EvalDriver):
    """EvalDriver that keeps what its evaluate() returned."""

    runs: list = []

    def evaluate(self, *args, **kw):
        result = super().evaluate(*args, **kw)
        _RecordingDriver.runs.append((self, result))
        return result


def _run(main, argv, capsys=None):
    assert main(argv) == 0
    return capsys.readouterr().out if capsys is not None else None


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed), contextlib.redirect_stderr(io.StringIO()):
        assert train.main(TINY + ["--epochs", "2", "--out-dir", str(out),
                                  "--experiment-id", "e2e",
                                  "--steps-per-dispatch", "2"]) == 0
    exp_dir = out / "e2e"
    with open(exp_dir / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    return exp_dir, records, printed.getvalue()


def test_train_cli_writes_the_run(trained):
    exp_dir, records, printed = trained
    assert sorted(os.listdir(exp_dir)) == ["best.json", "ckpt", "ckpt_best",
                                           "ckpt_step", "config.json",
                                           "metrics.jsonl", "samples"]
    assert sorted(os.listdir(exp_dir / "ckpt"), key=int) == ["0", "1"]
    summaries = [r for r in records if "step" not in r]
    assert [r["epoch"] for r in summaries] == [0, 1]
    best = max(r["val_pckh"] for r in summaries)
    assert printed.splitlines()[-1] == f"done; best val PCKh@0.5 = {100 * best:.2f}"
    assert "device_resident=auto: staging train split on the device" in printed
    cfg = tconfig.config_from_json((exp_dir / "config.json").read_text())
    assert (cfg.model.base, cfg.model.hg_features, cfg.train.epochs) == ("hg1", 16, 2)
    assert cfg.train.steps_per_dispatch == 2


def test_evaluate_cli_scores_the_saved_best(trained, monkeypatch, capsys):
    exp_dir, records, _ = trained
    summaries = [r for r in records if "step" not in r]
    best = max(summaries, key=lambda r: r["val_pckh"])
    monkeypatch.setattr(evaluate, "EvalDriver", _RecordingDriver)
    _RecordingDriver.runs = []
    out = _run(evaluate.main, ["--model-dir", str(exp_dir)] + DATA, capsys)
    (_, result), = _RecordingDriver.runs
    # The checkpoint round trip: evaluate's total is the train run's final
    # (best) val_pckh, exactly, and its loss the recorded val_loss.
    assert result["pckh"] == best["val_pckh"]
    np.testing.assert_allclose(result["loss"], best["val_loss"], rtol=1e-6)
    lines = out.splitlines()
    assert lines[0] == "PCKh@0.5"
    assert f"  total     {100 * best['val_pckh']:6.2f}" in lines
    assert lines[-1] == f"val loss {result['loss']:.5f}"


def test_evaluate_cli_flip_and_scales(trained, monkeypatch, capsys):
    exp_dir, _, _ = trained
    monkeypatch.setattr(evaluate, "EvalDriver", _RecordingDriver)
    _RecordingDriver.runs = []
    _run(evaluate.main, ["--model-dir", str(exp_dir), "--flip-eval",
                         "--eval-scales", "0.9,1.0,1.1", "--batch-size", "3"] + DATA,
         capsys)
    (driver, result), = _RecordingDriver.runs
    assert driver.cfg.train.flip_eval and driver.cfg.train.eval_scales == (0.9, 1.0, 1.1)
    assert driver.loader.batch_size == 3
    assert result["evaluator"].total.sum() > 0 and np.isfinite(result["loss"])


def test_infer_cli_writes_h5_and_mat(trained, capsys, tmp_path):
    h5py = pytest.importorskip("h5py")
    scipy_io = pytest.importorskip("scipy.io")
    exp_dir, _, _ = trained
    h5 = tmp_path / "preds.h5"
    out = _run(infer.main, ["--model-dir", str(exp_dir), "--preds-file", str(h5)]
               + DATA, capsys)
    assert out.strip() == (f"wrote (8, 16, 2) predictions to {h5} (subset=val, "
                           "split_method=unknown)")
    with h5py.File(h5, "r") as f:
        preds = np.asarray(f["preds"])
        assert dict(f["preds"].attrs) == {"split_method": "unknown", "subset": "val"}
    assert preds.shape == (8, 16, 2) and np.isfinite(preds).all()
    mat = tmp_path / "preds.mat"
    _run(infer.main, ["--model-dir", str(exp_dir), "--preds-file", str(mat),
                      "--subset", "train", "--flip-eval", "--eval-scales",
                      "0.9,1.0,1.1"] + DATA, capsys)
    m = scipy_io.loadmat(mat)
    assert m["preds"].shape == (16, 16, 2) and np.isfinite(m["preds"]).all()
    assert (str(m["subset"][0]), str(m["split_method"][0])) == ("train", "unknown")


# -- --resume from a mid-epoch save --------------------------------------------


class _Bomb(Exception):
    pass


def _with_step_saves(monkeypatch, bomb_after=None):
    """The train CLI with a step checkpoint every 2 steps and, optionally, a
    metric writer that stops the run at its ``bomb_after``-th step record."""
    real = common.config_from_args

    def config(args):
        cfg = real(args)
        return dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, checkpoint_every_steps=2, log_every_steps=1))

    monkeypatch.setattr(train, "config_from_args", config)
    if bomb_after is not None:
        left = [bomb_after]
        write = tmetrics.MetricWriter.write

        def bomb(self, event):
            write(self, event)
            if "step" in event:
                left[0] -= 1
                if left[0] == 0:
                    raise _Bomb

        monkeypatch.setattr(tmetrics.MetricWriter, "write", bomb)


def test_train_cli_resumes_from_a_mid_epoch_save(tmp_path, monkeypatch, capsys):
    # One epoch of 4 steps, a step save at step 2; run b stops after step 3
    # and resumes from that save.
    argv = TINY + ["--epochs", "1", "--out-dir", str(tmp_path),
                   "--device-resident", "off", "--seed", "4"]
    with monkeypatch.context() as m:
        _with_step_saves(m)
        _run(train.main, argv + ["--experiment-id", "a"], capsys)
    with monkeypatch.context() as m:
        _with_step_saves(m, bomb_after=3)
        with pytest.raises(_Bomb):
            train.main(argv + ["--experiment-id", "b"])
    assert os.listdir(tmp_path / "b" / "ckpt") == []
    assert os.listdir(tmp_path / "b" / "ckpt_step") == ["2"]
    with monkeypatch.context() as m:
        _with_step_saves(m)
        out = _run(train.main, argv + ["--experiment-id", "b", "--resume"], capsys)
    assert "resumed from epoch 0 step 2" in out
    a = torch.load(tmp_path / "a" / "ckpt" / "0" / STATE_FILENAME, weights_only=True)
    b = torch.load(tmp_path / "b" / "ckpt" / "0" / STATE_FILENAME, weights_only=True)
    assert (a["step"], a["count"]) == (b["step"], b["count"]) == (4, 4)
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)


def test_train_cli_resume_seeds_the_best(trained, tmp_path, capsys):
    # --resume after the last epoch: nothing left to train; the recorded
    # best seeds the tracker, so the final line repeats it.
    import shutil

    exp_dir, records, _ = trained
    shutil.copytree(exp_dir, tmp_path / "e2e")
    best = max(r["val_pckh"] for r in records if "step" not in r)
    out = _run(train.main, TINY + ["--epochs", "2", "--out-dir", str(tmp_path),
                                   "--experiment-id", "e2e", "--resume"], capsys)
    lines = out.splitlines()
    assert "resumed from epoch 1" in lines
    assert lines[-1] == f"done; best val PCKh@0.5 = {100 * best:.2f}"


# -- what is not ported yet ----------------------------------------------------


@pytest.mark.parametrize("flag,title", [
    (["--dashboard-port", "8080"], "Telemetry"), (["--profile-dir", "p"], "Telemetry"),
    (["--debug-nans"], "Telemetry"), (["--model-parallel", "2"], "Data parallel")])
def test_unported_train_flags_raise_with_their_roadmap_item(flag, title, tmp_path):
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1, {title}"):
        train.main(TINY + ["--out-dir", str(tmp_path)] + flag)
    assert not os.listdir(tmp_path)
    assert f"**{title}" in (ROOT / "ROADMAP.md").read_text()


@pytest.mark.parametrize("name", ["train", "evaluate", "infer"])
def test_cli_runs_as_a_module(name):
    proc = subprocess.run([sys.executable, "-m", f"dsnt_pose2d_tpu_torch.cli.{name}",
                           "--help"], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--device {cuda,cpu}" in proc.stdout
