"""The last five drivers of ``tools/`` in the port
(``dsnt_pose2d_tpu_torch/tools/``: ``bench_row_shift``, ``bench_maxpool``,
``bench_streaming``, ``bench_conv_core``, ``close_the_loop``) on the CPU.

- Each driver's flags and defaults are the JAX tool's (its ``argparse``,
  captured at its parse), plus ``--device``; the report paths default to the
  temporary directory instead of ``docs/``, and ``close_the_loop``'s
  ``--reference`` to ``reference/`` at the repo's root instead of the JAX
  tool's image mount.
- One window of each at small shapes: ``row_shift``'s two impls bitwise
  equal and equal to the plain version; the pools' forwards equal, their
  gradients apart only in tied windows; the streaming report and each
  conv-core case with the keys of ``docs/bench_streaming.json`` and
  ``docs/bench_conv_core.json`` (the port adding ``h2d_pageable``,
  ``propagated`` and ``winner_b16``); a lever that does not reach the step
  is reported with no times.
- ``close_the_loop`` on an absent and an empty tree writes the stub report
  (``docs/reference_closure_report.json``'s keys) and exits 0; on a small
  fake reference tree written here it diffs the layout, holds the tree's
  ops against the port's, regenerates the goldens with the oracle's recipe
  (bitwise the committed ``tests/goldens/ops_goldens.npz`` when the tree's
  ops are the oracle's) and re-pins the README's numbers; a tree whose
  ``dsnt`` takes the grid's endpoints is caught (exit 1).
"""

import argparse
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dsnt_pose2d_tpu_torch.tools import (bench_conv_core, bench_maxpool,
                                         bench_row_shift, bench_streaming,
                                         close_the_loop)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DOCS = ROOT / "docs"
BENCH_TINY = {"BENCH_HG_FEATURES": "16", "BENCH_HG_DEPTH": "1",
              "BENCH_INPUT_SIZE": "32", "BENCH_CANVAS": "48"}
DRIVERS = {"bench_row_shift": bench_row_shift, "bench_maxpool": bench_maxpool,
           "bench_streaming": bench_streaming, "bench_conv_core": bench_conv_core,
           "close_the_loop": close_the_loop}
# The port's defaults that differ from the JAX tool's: reports outside docs/,
# and no machine path for the reference tree.
NEW_DEFAULTS = {"--out", "--report", "--goldens-out", "--reference"}


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _parser(main, monkeypatch, *args):
    def capture(self, *a, **k):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed) as e:
            main(*args)
    return e.value.parser


def _surface(parser) -> dict:
    return {a.option_strings[0]: (a.dest, a.default, a.type, type(a).__name__)
            for a in parser._actions if a.option_strings
            and a.option_strings[0] != "-h"}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_flags_and_defaults_are_the_jax_tools(name, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    jax_tool = importlib.import_module(name)
    try:
        exp = _surface(_parser(jax_tool.main, monkeypatch))
    finally:
        sys.modules.pop(name, None)
    got = _surface(_parser(DRIVERS[name].main, monkeypatch, []))
    device = got.pop("--device")
    assert device[1] == "cuda"
    assert set(got) == set(exp)
    for flag, surface in exp.items():
        if flag in NEW_DEFAULTS:
            assert got[flag][0] == surface[0] and "docs" not in str(got[flag][1])
        else:
            assert got[flag] == surface, flag


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_refuses_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, SystemExit)):
        DRIVERS[name].main(["--reference", "/nonexistent-tree"] if name ==
                           "close_the_loop" else [])


# -- one window each at small shapes ----------------------------------------


def test_row_shift_study_on_the_cpu():
    assert bench_row_shift.CASES == [(6144, 3864, 2502, 3), (4096, 1674, 768, 3)]
    lines = []
    rep = bench_row_shift.run(iters=2, device="cpu", cases=[(64, 300, 200, 3)],
                              calib_rows=16, log=lines.append)
    (rec,) = rep["cases"]
    assert rec["max_abs_vec_minus_legacy"] == rec["max_abs_vec_minus_plain"] == 0.0
    assert rec["bytes"] == (64 * 300 + 64 * 200) * 4
    for impl in ("legacy", "vec"):
        assert rec[impl]["ms"] > 0 and rec[impl]["frac_of_ceiling"] > 0
    assert rep["copy_ceiling_GBps"] > 0
    assert lines[0].startswith("(64,300)->200 s3  legacy") and "speedup" in lines[2]


def test_row_shift_inputs_are_the_jax_tools():
    rows, starts, fracs = bench_row_shift.case_inputs(16, 100, 40, 3, "cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(rows.numpy(), rng.uniform(size=(16, 100))
                                  .astype(np.float32))
    exp = rng.integers(0, (100 - 40 - 3) // 3, size=(16,)).astype(np.int32) * 3
    np.testing.assert_array_equal(starts.numpy(), exp)
    assert fracs.shape == (16,) and starts.dtype == torch.int32


def test_maxpool_study_on_the_cpu():
    assert bench_maxpool.shapes_for(16)[0] == (16, 64, 192, 192)
    recs = bench_maxpool.run(device="cpu", iters=2,
                             shapes=[(2, 4, 8, 8), (2, 8, 4, 4)], log=lambda s: None)
    for rec in recs:
        assert rec["fwd_equal"] and rec["every_difference_in_a_tie"]
        assert rec["window_ms"] > 0 and rec["reshape_ms"] > 0


def test_maxpool_gradients_part_only_at_ties():
    x = torch.tensor([[[[1.0, 3.0, 2.0, 2.0], [0.0, 3.0, 1.0, 0.0]]]],
                     dtype=torch.bfloat16)   # window 0: two 3s; window 1: one 2 twice
    gw = bench_maxpool._grad(bench_maxpool.window_pool, x)
    gr = bench_maxpool._grad(bench_maxpool.reshape_pool, x)
    assert bench_maxpool.tied_windows(x).tolist() == [[[[True, True]]]]
    assert float(gw.sum()) == float(gr.sum()) == 6.0 + 4.0
    assert sorted(gw.flatten().tolist()) == [0, 0, 0, 0, 0, 0, 4.0, 6.0]
    assert sorted(gr.flatten().tolist()) == [0, 0, 0, 0, 2.0, 2.0, 3.0, 3.0]


@pytest.fixture
def tiny_bench(monkeypatch, tmp_path):
    for k, v in BENCH_TINY.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BENCH_FIXTURE_DIR", str(tmp_path / "fixture"))
    # The conv-core cases' processes: one intra-op thread each, as this
    # file's (parallel test workers share the host's cores).
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_streaming_study_on_the_cpu(tiny_bench):
    rep = bench_streaming.run(
        batch=2, quick=True, device="cpu", canvases=(48,),
        h2d_kw={"sizes_mb": (1,), "repeats": 1},
        step_kw={"iters": 1, "repeats": 1, "warmup": 1},
        e2e_kw={"repeats": 1, "epoch_steps": 2, "workers": 1}, log=lambda s: None)
    doc = json.loads((DOCS / "bench_streaming.json").read_text())
    assert set(rep) == set(doc) | {"h2d_pageable"}
    for key in ("h2d", "h2d_pageable"):
        assert set(rep[key]) == {"1MB"} and set(rep[key]["1MB"]) == set(doc["h2d"]["1MB"])
    assert [(c["canvas"], c["steps_per_dispatch"]) for c in rep["streaming"]] == [
        (48, 1), (48, 4)]
    for cell in rep["streaming"]:
        assert set(cell) == set(doc["streaming"][0])
        assert cell["img_s"] > 0 and cell["transport_ceiling_img_s"] > 0
    assert rep["resident_img_s"] > 0 and rep["device_step_img_s"] > 0


def test_conv_core_study_on_the_cpu(tiny_bench):
    rep = bench_conv_core.run(repeats=1, iters=1, device="cpu", log=lambda s: None)
    doc = json.loads((DOCS / "bench_conv_core.json").read_text())
    cases = [k for k in rep if k != "winner_b16"]
    assert cases[:4] == ["baseline_b16", "cudnn_benchmark_b16",
                         "channels_last_b16", "baseline_b32"]
    assert rep["winner_b16"] in bench_conv_core.LEVERS
    assert len(cases) == 4 + (rep["winner_b16"] != "baseline")
    for name in cases:
        rec = rep[name]
        lever = name.rsplit("_b", 1)[0]
        seen = rec["propagated"]
        assert seen["cudnn_benchmark"] == bench_conv_core.LEVERS[lever][0]
        assert seen["conv_inputs"] > 0
        if rec.get("not_propagated"):
            assert not bench_conv_core.reached(lever, seen) and "median" not in rec
        else:
            assert set(doc["baseline_b16"]) <= set(rec), name
            assert rec["case"] == name and rec["median"] > 0


def test_conv_core_probe_sees_the_memory_format():
    from torch import nn

    class PoseNet(nn.Module):   # the probe stops at the end of a PoseNet forward
        def __init__(self):
            super().__init__()
            self.a, self.b = nn.Conv2d(3, 4, 3), nn.Conv2d(4, 4, 1)

        def forward(self, x):
            return self.b(self.a(x))

    net = PoseNet().to(memory_format=torch.channels_last)
    seen = bench_conv_core.conv_probe()
    net(torch.randn(1, 8, 8, 3).permute(0, 3, 1, 2))
    net(torch.randn(1, 3, 8, 8))                       # after the probe: unseen
    assert seen == {"conv_inputs": 2, "conv_inputs_channels_last": 2,
                    "first_conv_input": "channels_last"}
    assert bench_conv_core.reached("channels_last", {**seen, "cudnn_benchmark": False})
    assert not bench_conv_core.reached("cudnn_benchmark", {**seen,
                                                           "cudnn_benchmark": False})


# -- close_the_loop -----------------------------------------------------------


@pytest.mark.parametrize("tree", ["absent", "empty"])
def test_close_the_loop_stub_on_no_tree(tree, tmp_path, capsys):
    ref = tmp_path / "reference"
    if tree == "empty":
        ref.mkdir()
    out = tmp_path / "report.json"
    assert close_the_loop.main(["--reference", str(ref), "--out", str(out),
                                "--device", "cpu"]) == 0
    rep = json.loads(out.read_text())
    doc = json.loads((DOCS / "reference_closure_report.json").read_text())
    assert set(rep) == set(doc) and rep["census"] == {"n_files": 0}
    assert rep["status"] == doc["status"] and rep["reference"] == str(ref)


FAKE_OPS = '''
import torch
import sys
sys.path.insert(0, {oracle!r})
from torch_oracle import (flat_softmax, make_gauss, kl_reg_losses, js_reg_losses,
                          mse_reg_losses, variance_reg_losses, euclidean_losses,
                          average_loss, normalized_linspace)
from torch_oracle import dsnt as _dsnt


def dsnt(hm):
    {dsnt_body}

kl_reg_loss, js_reg_loss, mse_reg_loss = kl_reg_losses, js_reg_losses, mse_reg_losses
variance_reg_loss = variance_reg_losses


def euclidean_loss(actual, target):
    return euclidean_losses(actual, target).mean()
'''
DSNT_BODIES = {
    "oracle": "return _dsnt(hm)",
    # Grid endpoints at -1 and 1 instead of the pixel centres.
    "endpoints": ("w = hm.shape[-1]; xs = torch.linspace(-1, 1, w, dtype=hm.dtype); "
                  "return torch.stack([(hm.sum(-2) * xs).sum(-1), "
                  "(hm.sum(-1) * xs).sum(-1)], -1)"),
}


@pytest.mark.parametrize("variant", sorted(DSNT_BODIES))
def test_close_the_loop_on_a_fake_reference(variant, tmp_path, monkeypatch, capsys):
    ref = tmp_path / "reference"
    (ref / "dsnt").mkdir(parents=True)
    (ref / "dsnt" / "__init__.py").write_text("")
    (ref / "dsnt" / "nn.py").write_text(FAKE_OPS.format(
        oracle=str(ROOT / "tests" / "oracle"), dsnt_body=DSNT_BODIES[variant]))
    (ref / "dsnt" / "model.py").write_text("")
    (ref / "train.py").write_text("")
    (ref / "extra.py").write_text("")
    (ref / "README.md").write_text("| hg8 | PCKh total | 87.20 |\nnothing 12.34\n")
    monkeypatch.setattr(sys, "path", list(sys.path))
    saved = {k: sys.modules.pop(k) for k in ("dsnt", "dsnt.nn") if k in sys.modules}
    out, goldens = tmp_path / "report.json", tmp_path / "goldens.npz"
    try:
        rc = close_the_loop.main(["--reference", str(ref), "--out", str(out),
                                  "--goldens-out", str(goldens), "--device", "cpu"])
    finally:
        for k in ("dsnt", "dsnt.nn"):
            sys.modules.pop(k, None)
        sys.modules.update(saved)
    rep = json.loads(out.read_text())
    assert rep["census"] == {"n_files": 6}
    layout = rep["layout"]
    assert set(layout["found"]) == {"dsnt/nn.py", "dsnt/model.py", "train.py"}
    assert "evaluate.py" in layout["survey_predicted_but_absent"]
    assert layout["present_but_unmapped_by_survey"] == ["dsnt/__init__.py", "extra.py"]
    assert [h["line"] for h in rep["numbers"]["candidate_lines"]] == [1]
    ops = rep["op_parity"]["ops"]
    assert rep["op_parity"]["module"] == "dsnt.nn" and len(ops) == 8
    regen = rep["golden_regen"]
    assert regen["status"] == "ran"
    probe = rep["op_parity"]["probes"]["grid_convention"]
    if variant == "oracle":
        assert rc == 0 and regen["passed"]
        assert all(v["max_abs_dev"] <= 1e-9 for v in ops.values())
        assert probe["pixel_center_formula_matches"]
        committed = np.load(ROOT / "tests" / "goldens" / "ops_goldens.npz")
        got = np.load(goldens)
        for k in committed.files:
            np.testing.assert_array_equal(got[k], committed[k], err_msg=k)
    else:
        assert rc == 1 and not regen["passed"]
        assert ops["dsnt"]["max_abs_dev"] > 1e-3
        assert not regen["port_ops"]["pred_coords"]["passed"]
        assert not probe["pixel_center_formula_matches"]
