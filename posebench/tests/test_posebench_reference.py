"""The reference against the port at a tiny size on the CPU, in fp32: the
same weights, rows and draws give the same preprocess, model, loss, steps
and predictions.  This test alone imports both."""

import numpy as np
import pytest
import torch

from posebench import compare, harness, inputs
from posebench.reference import head, model as M, preprocess as P, steps as R


def _pair(cell):
    calib = inputs.make_split(4, inputs.canvas_side(cell.config), 5, "cpu")
    w = inputs.make_weights(cell.config, 5, calib, "cpu",
                            **cell.config_file["weights"]["made"])
    prog = harness.program_model(harness.program_config(cell), w, "cpu")
    return w, prog, R.build(cell.config, w, "cpu")


@pytest.mark.parametrize("name", ["hg8-train-resident", "resnet50-2x-train-resident"])
@pytest.mark.parametrize("train", [False, True])
def test_model_and_loss(name, train, tiny):
    cell = tiny(name)
    _, prog, ref = _pair(cell)
    batch = {k: torch.as_tensor(v) for k, v in
             inputs.make_split(4, inputs.canvas_side(cell.config), 9, "cpu").items()}
    pre = P.preprocess(batch, cell.config["data"], M.input_size(cell.config["model"]))
    with torch.no_grad():
        a = prog.forward(pre["images"], train=train)
        b = ref.train(train)(pre["images"])
        torch.testing.assert_close(a.heatmaps, b, rtol=1e-4, atol=1e-4)
        la, _ = prog.loss(a, pre["coords"], pre["mask"])
        lb = head.pose_loss(b, pre["coords"], pre["mask"], cell.config["model"])
        torch.testing.assert_close(la, lb, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(prog.decode(a), head.decode(b[-1]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_preprocess_and_draws(train, tiny):
    from dsnt_pose2d_tpu_torch.data.augment import preprocess_batch, sample_train_draws
    from dsnt_pose2d_tpu_torch.train.state import step_seed

    cell = tiny("hg8-train-resident")
    data = cell.config["data"]
    cfg = harness.program_config(cell)
    batch = {k: torch.as_tensor(v) for k, v in
             inputs.make_split(4, inputs.canvas_side(cell.config), 9, "cpu").items()}
    assert P.step_seed(2 ** 31 + 5, 3) == step_seed(2 ** 31 + 5, 3)
    dr = None
    if train:
        dr = P.draws(4, data, P.step_seed(11, 2), "cpu")
        gen = torch.Generator().manual_seed(step_seed(11, 2))
        mine = sample_train_draws(4, cfg.data, gen)
        for k in dr:
            torch.testing.assert_close(dr[k], mine[k], rtol=0, atol=0)
    size = M.input_size(cell.config["model"])
    got = preprocess_batch(batch["canvases"], batch["coords_px"], batch["mask"],
                           batch["head_length"], batch["canvas_from_orig"], cfg.data, size,
                           train=train, canvas_margin=batch["canvas_margin"], draws=dr)
    exp = P.preprocess(batch, data, size, dr)
    for k in ("images", "coords", "mask", "crop_from_orig"):
        torch.testing.assert_close(got[k], exp[k], rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("name", ["hg8-train-resident", "resnet50-2x-train-resident"])
def test_train_steps_follow_the_port(name, tiny):
    """The program's compared steps (through the cell's own feed) against
    the reference's: fp32 on both sides, so the first step agrees to
    round-off; after RMSProp's first update, whose size does not depend on
    the gradient's, round-off in the smallest gradients moves later
    steps by more."""
    cell = tiny(name)
    traffic = harness.generator(cell).Traffic(cell)
    traffic.release()
    got = traffic.readings()
    assert got["loss1_rel"] < 1e-5 and got["grad1_median_gap"] < 1e-4
    assert got["loss_rel"] < 1e-2 and got["change_median_gap"] < 1e-2


def test_predictions_follow_the_port(tiny):
    cell = tiny("hg8-serve-photos")
    traffic = harness.generator(cell).Traffic(cell)
    traffic.window(0.5)
    traffic.release()
    got = traffic.readings()
    assert got["pred_gap_px"] < 0.05 and got["pred_gap_mean_px"] < 0.01


def test_controls_read_worse(tiny):
    cell = tiny("hg8-serve-photos")
    traffic = harness.generator(cell).Traffic(cell)
    traffic.window(0.5)
    traffic.release()
    ref = traffic.reference()
    prog = traffic.compare(traffic.program(), ref)
    for control in ("fp8", "half_batch"):
        got = traffic.compare(traffic.reference(control), ref)
        assert got["pred_gap_mean_px"] > 10 * prog["pred_gap_mean_px"]


def test_worst_leaf_and_round_off_rule():
    ref = {"losses": [1.0], "grad1": {"a": 1.0, "b": 2.0, "c": 1e-6},
           "change": {"a": 1.0, "b": 1.0, "c": 1.0}}
    prog = {"losses": [1.0], "grad1": {"a": 1.0, "b": 2.0, "c": 0.0},
            "change": {"a": 1.0, "b": 1.5, "c": 0.0}}
    got = compare.train_readings(prog, ref)
    assert got["grad1_gap"] == pytest.approx(1e-6)        # c against the median leaf
    assert got["change_gap"] == pytest.approx(0.5)        # c is left out: round-off
    prog["change"].pop("a")
    assert compare.train_readings(prog, ref)["change_gap"] == np.inf
