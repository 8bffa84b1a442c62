"""A converted JAX run through the port's CLIs, and the card's fixture.

The run is ``tests/jax_ckpt_fixture.py``'s (hg1 at 32 features, 64 px,
fp32, the fused head with JS, RMSProp, the synthetic fixture): made by the
JAX package, converted by ``tools/jax_ckpt_to_torch.py`` (which writes
nothing into the JAX run), then:

- the port's ``cli.evaluate`` gives the JAX ``cli.evaluate``'s per-joint
  PCKh counts, with and without ``--flip-eval``; a joint's count may differ
  only where some row's normalised distance in JAX lies within 1e-5 of the
  0.5 threshold (none does on this run: the counts are equal), and the
  port's distances are within 1e-5 of JAX's;
- ``cli.infer``'s preds agree with JAX's ``predict`` within 1e-4 px;
- ``cli.train --resume`` re-enters the JAX run's mid-epoch save (epoch 1,
  step 2 in it, global step 6) and trains to the end of that epoch; from
  the epoch save alone it resumes after epoch 0, and the best is seeded
  from ``best.json``;
- the committed fixture ``tests/fixtures/jax_ckpt_hg1/`` (what
  ``chip_smoke.py`` drives on the card) is this run's epoch-0 save,
  bitwise, and its ``jax_reference.json`` holds this run's numbers within
  1e-6; the port's evaluate, infer and resumed train step on the committed
  fixture meet the card's tolerances here on the CPU: the step's loss and
  aux rtol 1e-4, its grad norm rtol 2e-2 of JAX's with BN statistics in
  fp64 (``tests/test_torch_train_step.py``'s fp32 rules).
"""

import contextlib
import hashlib
import io
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import scipy.io
import torch

import jax_ckpt_fixture as fixture
from dsnt_pose2d_tpu_torch.cli import evaluate, infer, train
from dsnt_pose2d_tpu_torch.data.synthetic import make_synthetic_mpii
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
from dsnt_pose2d_tpu_torch.train.checkpoint import (STATE_FILENAME,
                                                    CheckpointManager)
from dsnt_pose2d_tpu_torch.train.loop import make_train_fn
from jax_ckpt_to_torch import convert

torch.set_num_threads(1)

DIST_MARGIN = 1e-5
PRED_ATOL_PX = 1e-4
STEP_TOL = {"loss_rtol": 1e-4, "grad_norm_rtol": 2e-2}
PORT_ARGV = ["--device", "cpu"]
TRAIN_ARGV = ["--device", "cpu", "--base-model", "hg1", "--hg-features", "32",
              "--input-size", "64", "--dtype", "float32", "--reg", "js",
              "--data-source", "synthetic", "--synthetic-size", "32",
              "--batch-size", "8", "--lr", "1e-3", "--seed", "7",
              "--workers", "1"]


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): (p.stat().st_mtime_ns,
                                       hashlib.sha256(p.read_bytes()).hexdigest())
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_ckpt")
    jax_dir, port_dir = root / "jax_run", root / "port" / "e2e"
    with pytest.MonkeyPatch.context() as mp:
        # The JAX CLIs' compilation cache would write under $HOME.
        mp.setenv("DSNT_NO_COMPILE_CACHE", "1")
        fixture.train_run(str(jax_dir), full=True)
        before = _tree(jax_dir)
        lines = []
        records = convert(str(jax_dir), str(port_dir), log=lines.append)
        ref, draws = fixture.reference(str(jax_dir))
    return dict(jax_dir=jax_dir, port_dir=port_dir, before=before,
                after=_tree(jax_dir), lines=lines, records=records, ref=ref,
                draws=draws)


def test_convert_prints_a_line_per_key_and_the_draws_note(run):
    lines = run["lines"]
    assert [line.split(" ->")[0] for line in lines[:3]] == [
        "ckpt/0", "ckpt_best/0", "ckpt_step/6"]
    assert lines[2].endswith("epoch 1, step 6, step_in_epoch 2, optimizer count 6")
    assert lines[3:] == ["note: the JAX rng is not carried over: the port draws "
                         "each step's augmentation from (seed, step), so a "
                         "resumed run takes other draws than the JAX run would have"]


def test_convert_writes_nothing_into_the_jax_run(run):
    assert run["after"] == run["before"]


def test_converted_layout_and_meta(run):
    jax_dir, port_dir = run["jax_dir"], run["port_dir"]
    for name in ("config.json", "best.json", "metrics.jsonl"):
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes(), name
    metas = {f"{r['store']}/{r['key']}": r["meta"] for r in run["records"]}
    assert {k: (m["epoch"], m["step"], m["step_in_epoch"]) for k, m in metas.items()} \
        == {"ckpt/0": (0, 4, 0), "ckpt_best/0": (0, 4, 0), "ckpt_step/6": (1, 6, 2)}
    for key, meta in metas.items():
        assert json.loads((port_dir / key / "meta.json").read_text()) == meta
        payload = torch.load(port_dir / key / STATE_FILENAME, weights_only=True)
        assert (payload["step"], payload["count"], payload["seed"]) == (
            meta["step"], meta["step"], 7)
    assert json.loads((port_dir / "best.json").read_text())["metrics"] == \
        metas["ckpt_best/0"]["metrics"]


def _port_evaluate(model_dir, flip):
    argv = ["--model-dir", str(model_dir), *PORT_ARGV] + (
        ["--flip-eval"] if flip else [])
    out = io.StringIO()
    with fixture._Recording(evaluate) as rec, contextlib.redirect_stdout(out):
        assert evaluate.main(argv) == 0
    (driver, state, result), = rec.runs
    preds = np.asarray(driver.predict(state), np.float64)
    val = make_synthetic_mpii(8, canvas_size=96, seed=2)
    ev = result["evaluator"]
    return {"correct": ev.correct, "total": ev.total, "loss": result["loss"],
            "table": out.getvalue(), "preds": preds,
            "norm_dist": fixture.normalised_distances(preds, val)}


def _hold_evaluate(got, exp):
    """The port's evaluate against JAX's record: counts equal but where a
    row's JAX distance lies within DIST_MARGIN of the threshold."""
    jd = np.asarray(exp["norm_dist"], np.float64)
    near = np.nansum(np.abs(jd - 0.5) < DIST_MARGIN, axis=0) > 0
    diff = np.asarray(got["correct"]) != np.asarray(exp["correct"])
    assert not (diff & ~near).any(), (got["correct"], exp["correct"])
    np.testing.assert_array_equal(got["total"], exp["total"])
    np.testing.assert_allclose(got["norm_dist"], jd, rtol=0, atol=DIST_MARGIN)
    np.testing.assert_allclose(got["loss"], exp["loss"], rtol=1e-4)
    return near


@pytest.mark.parametrize("flip", [False, True], ids=["single", "flip"])
def test_evaluate_cli_gives_jax_counts(run, flip):
    exp = run["ref"]["evaluate_flip" if flip else "evaluate"]
    got = _port_evaluate(run["port_dir"], flip)
    near = _hold_evaluate(got, exp)
    # No row lies that near the threshold on this run, so the counts and
    # the printed PCKh table are JAX's.
    assert not near.any()
    np.testing.assert_array_equal(got["correct"], exp["correct"])
    table = [line for line in got["table"].splitlines() if not line.startswith("val loss")]
    assert table == [line for line in exp["table"].splitlines()
                     if not line.startswith("val loss")]


@pytest.mark.parametrize("flip", [False, True], ids=["single", "flip"])
def test_infer_cli_preds_match_jax(run, flip, tmp_path, capsys):
    out = tmp_path / "preds.mat"
    argv = ["--model-dir", str(run["port_dir"]), "--preds-file", str(out),
            *PORT_ARGV] + (["--flip-eval"] if flip else [])
    assert infer.main(argv) == 0
    preds = scipy.io.loadmat(out)["preds"]
    exp = np.asarray(run["ref"]["evaluate_flip" if flip else "evaluate"]["preds"])
    assert preds.shape == exp.shape == (8, 16, 2)
    np.testing.assert_allclose(preds, exp, rtol=0, atol=PRED_ATOL_PX)


def _resume(run, tmp_path, epochs, drop_step_saves=False):
    model_dir = tmp_path / "e2e"
    shutil.copytree(run["port_dir"], model_dir)
    if drop_step_saves:
        shutil.rmtree(model_dir / "ckpt_step")
        (model_dir / "ckpt_step").mkdir()
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        assert train.main(TRAIN_ARGV + ["--epochs", str(epochs), "--out-dir",
                                        str(tmp_path), "--experiment-id", "e2e",
                                        "--resume"]) == 0
    return model_dir, out.getvalue().splitlines()


def test_train_cli_resumes_the_jax_mid_epoch_save(run, tmp_path):
    model_dir, lines = _resume(run, tmp_path, epochs=2)
    assert "resumed from epoch 1 step 2" in lines
    saved = torch.load(model_dir / "ckpt" / "1" / STATE_FILENAME, weights_only=True)
    # Epoch 1's last 2 steps on top of the JAX run's 6.
    assert (saved["step"], saved["count"]) == (8, 8)
    meta = json.loads((model_dir / "ckpt" / "1" / "meta.json").read_text())
    assert (meta["epoch"], meta["step"]) == (1, 8)


def test_train_cli_resume_seeds_the_best_from_best_json(run, tmp_path):
    # The epoch save alone: resume after epoch 0 with nothing left to train;
    # the final line repeats best.json's PCKh.
    model_dir, lines = _resume(run, tmp_path, epochs=1, drop_step_saves=True)
    best = json.loads((run["port_dir"] / "best.json").read_text())
    assert "resumed from epoch 0" in lines
    assert lines[-1] == f"done; best val PCKh@0.5 = {100 * best['metrics']['val_pckh']:.2f}"


# -- the committed fixture ------------------------------------------------------


def test_committed_fixture_is_this_runs_epoch_save(run):
    got = torch.load(fixture.FIXTURE / "ckpt" / "0" / STATE_FILENAME,
                     weights_only=True)
    exp = torch.load(run["port_dir"] / "ckpt" / "0" / STATE_FILENAME,
                     weights_only=True)
    assert set(got["model"]) == set(exp["model"])
    for k, v in exp["model"].items():
        assert torch.equal(got["model"][k], v), k
    assert got["optimizer"]["param_groups"] == exp["optimizer"]["param_groups"]
    for i, st in exp["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(got["optimizer"]["state"][i][k], v), (i, k)
    assert {k: got[k] for k in ("count", "step", "seed")} == {
        k: exp[k] for k in ("count", "step", "seed")}
    assert (fixture.FIXTURE / "config.json").read_bytes() == \
        (run["jax_dir"] / "config.json").read_bytes()


def _numbers(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _numbers(v, f"{path}.{k}")
    elif isinstance(tree, list):
        yield path, np.asarray(tree, np.float64)
    elif isinstance(tree, (int, float)):
        yield path, np.float64(tree)


def test_committed_reference_holds_this_runs_numbers(run):
    committed = json.loads((fixture.FIXTURE / fixture.REFERENCE).read_text())
    exp = dict(_numbers(run["ref"]))
    got = dict(_numbers(committed))
    assert set(got) == set(exp) and len(exp) > 10
    for k, v in exp.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-6, err_msg=k)
    for k in ("evaluate", "evaluate_flip"):
        assert committed[k]["table"] == run["ref"][k]["table"]
    draws = np.load(fixture.FIXTURE / fixture.DRAWS)
    assert set(draws.files) == set(run["draws"])
    for k, v in run["draws"].items():
        np.testing.assert_array_equal(draws[k], v, err_msg=k)


def test_fixture_stays_small():
    size = sum(p.stat().st_size for p in fixture.FIXTURE.rglob("*") if p.is_file())
    assert size < 2 * 2**20, size


@pytest.mark.parametrize("flip", [False, True], ids=["single", "flip"])
def test_port_on_the_fixture_meets_the_cards_tolerances(flip):
    ref = json.loads((fixture.FIXTURE / fixture.REFERENCE).read_text())
    exp = ref["evaluate_flip" if flip else "evaluate"]
    got = _port_evaluate(fixture.FIXTURE, flip)
    _hold_evaluate(got, exp)
    np.testing.assert_allclose(got["preds"], exp["preds"], rtol=0, atol=PRED_ATOL_PX)


def test_resumed_step_on_the_fixture_matches_jax():
    ref = json.loads((fixture.FIXTURE / fixture.REFERENCE).read_text())["resumed_step"]
    ckpt = CheckpointManager(str(fixture.FIXTURE))
    cfg = ckpt.load_config()
    model = build_pose_model(cfg.model, device="cpu")
    step = make_train_fn(model, cfg, device="cpu",
                         steps_per_epoch=fixture.STEPS_PER_EPOCH)
    state, meta = ckpt.restore(step.state, epoch=0)
    assert state is step.state and state.step == ref["step"] == meta["step"]
    syn = ref["synthetic"]
    rows = make_synthetic_mpii(syn["num_samples"], canvas_size=syn["canvas"],
                               seed=syn["seed"])
    batch = {k: v[ref["rows"]] for k, v in rows.items()}
    npz = np.load(fixture.FIXTURE / fixture.DRAWS)
    draws = {k: torch.from_numpy(npz[k]) if k in npz.files else None
             for k in ("rot", "scale", "flip", "jitter")}
    got = step(batch, draws=draws)
    for k in ("loss", "euclidean", "reg"):
        np.testing.assert_allclose(float(got[k]), ref[k],
                                   rtol=STEP_TOL["loss_rtol"], err_msg=k)
    np.testing.assert_allclose(float(got["grad_norm"]), ref["grad_norm_bn64"],
                               rtol=STEP_TOL["grad_norm_rtol"])
    assert state.step == ref["step"] + 1 and state.optimizer.count == ref["step"] + 1
