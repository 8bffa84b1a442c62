"""The port's experiment drivers (``dsnt_pose2d_tpu_torch/tools/``) on the CPU.

- ``HEAD_FLAGS`` is the JAX tool's, and the port's ``cli.evaluate`` table
  parses to the same total through both packages' parse.
- Each ablation driver and ``flagship_report`` builds the same CLI argv as
  the JAX driver for the same arguments (module names swapped, ``--device``
  added), and runs a real one-cell grid over the synthetic fallback: the
  CLIs in this process (``ablation_common.run_in_process``) with the model
  cut by flags appended to the train CLI's argv (hg1/hg8 at 16 features,
  ResNet-18, a 64-px input, 16 rows).  Its JSON keys are those of the
  matching ``docs/*.json``.
- ``sweep_train_step`` and ``bench_infer``: their workers' programs and
  output parses, and one worker run each at a tiny size; ``profile_step``
  writes its trace.

The JAX tools in ``tools/`` import the standard library only at the top;
they are loaded by path with ``tools/`` on ``sys.path``.
"""

import importlib
import json
import os
import sys
from pathlib import Path

import pytest
import torch

from dsnt_pose2d_tpu_torch.tools import (ablation_common, bench_infer,
                                         flagship_report, profile_step,
                                         sweep_train_step)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DOCS = ROOT / "docs"
TINY = ["--hg-features", "16", "--input-size", "64", "--dtype", "float32",
        "--synthetic-size", "16", "--workers", "1"]
BENCH_TINY = {"BENCH_HG_FEATURES": "16", "BENCH_HG_DEPTH": "1",
              "BENCH_INPUT_SIZE": "32", "BENCH_CANVAS": "48"}


@pytest.fixture
def jax_tools(monkeypatch):
    """The JAX tools' modules, imported from ``tools/``."""
    monkeypatch.syspath_prepend(str(ROOT / "tools"))

    def load(name):
        return importlib.import_module(name)

    yield load
    for name in ("_ablation_common", "ablation_heads", "ablation_reg",
                 "ablation_resolution", "flagship_report", "sweep_train_step",
                 "bench_infer"):
        sys.modules.pop(name, None)


def _to_jax(argv):
    """A port CLI argv as the JAX driver builds it: the JAX package's
    module, no ``--device``."""
    out, skip = [], False
    for a in argv[1:]:
        if skip:
            skip = False
            continue
        if a == "--device":
            skip = True
            continue
        out.append(a.replace("dsnt_pose2d_tpu_torch.cli", "dsnt_pose2d_tpu.cli"))
    return out


FAKE_EVAL = "val split\nPCKh@0.5\n  head       50.00\n  total      42.25\n  total16    41.00\n"


def _recorder(calls, out_root=None):
    def run(argv, timeout=None):
        calls.append(list(argv))
        if out_root is not None and argv[2].endswith("cli.train"):
            exp = Path(argv[argv.index("--out-dir") + 1]) / argv[
                argv.index("--experiment-id") + 1]
            exp.mkdir(parents=True, exist_ok=True)
            (exp / "metrics.jsonl").write_text("".join(json.dumps(
                {"epoch": e, "images_per_sec": 10.0, "train_loss": 1.0,
                 "epoch_seconds": 2.0, "val_pckh": 0.5}) + "\n"
                for e in range(3)))
        return FAKE_EVAL
    return run


def _tiny_in_process(calls, extra=TINY):
    def run(argv, timeout=None):
        calls.append(list(argv))
        if argv[2].endswith("cli.train"):
            argv = [*argv, *extra]
        return ablation_common.run_in_process(argv, timeout)
    return run


def _same_keys(got: dict, doc: dict, path=""):
    assert set(got) == set(doc), (path, sorted(got), sorted(doc))
    for k, v in doc.items():
        if isinstance(v, dict) and k != "config":
            sub = got[k]
            if k == "results":   # the cells this run had, each with the doc's keys
                for cell in sub:
                    _same_keys(sub[cell], next(iter(v.values())), f"{path}.{cell}")
            else:
                _same_keys(sub, v, f"{path}.{k}")


def test_head_flags_and_total_parse_match_jax(jax_tools):
    jcommon = jax_tools("_ablation_common")
    assert ablation_common.HEAD_FLAGS == jcommon.HEAD_FLAGS
    assert ablation_common.TOTAL_RE.pattern == r"^\s*total\s+([0-9.]+)"


@pytest.mark.parametrize("driver,args", [
    ("ablation_heads", ["--base-model", "hg1", "--epochs", "2",
                        "--batch-size", "8", "--heads", "dsnt,gauss,fc"]),
    ("ablation_resolution", ["--base-model", "resnet18", "--epochs", "3",
                             "--dilates", "0,2", "--heads", "dsnt,gauss"]),
    ("ablation_reg", ["--epochs", "1", "--regs", "none,js",
                      "--sigmas", "0.5,1.0,2.0"]),
    ("flagship_report", ["--epochs", "5", "--batch-size", "4",
                         "--skip-device-bench"]),
])
def test_driver_argv_matches_jax(driver, args, jax_tools, monkeypatch, tmp_path):
    data = str(tmp_path / "data")
    os.makedirs(data)
    # The flagship's JAX default report lies in docs/: send both elsewhere.
    extra = (["--report", str(tmp_path / "r.json")]
             if driver == "flagship_report" else [])
    jcommon = jax_tools("_ablation_common")
    jmod = jax_tools(driver)
    jcalls, tcalls = [], []
    monkeypatch.setattr(jcommon, "run", _recorder(jcalls, tmp_path))
    monkeypatch.setattr(sys, "argv", [driver, "--data-dir", data, *args, *extra])
    jmod.main()
    monkeypatch.setattr(ablation_common, "run", _recorder(tcalls, tmp_path))
    tmod = importlib.import_module(f"dsnt_pose2d_tpu_torch.tools.{driver}")
    assert tmod.main(["--data-dir", data, *args, *extra, "--device", "cpu"]) == 0
    assert len(tcalls) == len(jcalls) >= 2
    for t, j in zip(tcalls, jcalls):
        assert t[0] == sys.executable and t[-2:] == ["--device", "cpu"]
        assert _to_jax(t) == j[1:]


def _tiny_experiment(tmp_path):
    from dsnt_pose2d_tpu_torch.cli import train

    out = tmp_path / "runs"
    assert train.main(["--base-model", "hg1", "--data-source", "synthetic",
                       "--batch-size", "4", "--epochs", "1", "--out-dir",
                       str(out), "--experiment-id", "e", "--device", "cpu",
                       *TINY]) == 0
    return out / "e"


def test_evaluate_table_parses_through_both_packages(jax_tools, monkeypatch,
                                                     tmp_path, capsys):
    from dsnt_pose2d_tpu_torch.cli import evaluate

    exp = _tiny_experiment(tmp_path)
    capsys.readouterr()
    assert evaluate.main(["--model-dir", str(exp), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    best = json.loads((exp / "best.json").read_text())["metrics"]["val_pckh"]
    total, table = ablation_common.parse_total(out)
    assert total == pytest.approx(100 * best, abs=5e-3)
    assert table[0] == "PCKh@0.5"
    jcommon = jax_tools("_ablation_common")
    monkeypatch.setattr(jcommon, "run", lambda argv, timeout=None: out)
    j = jcommon.train_and_eval(str(tmp_path), str(tmp_path), "x", [])
    assert j["pckh_total"] == total and j["table"] == table


def _doc(name):
    return json.loads((DOCS / name).read_text())


@pytest.mark.parametrize("driver,args,doc,cells", [
    ("ablation_heads", ["--base-model", "hg1", "--heads", "dsnt"],
     "ablation_heads.json", {"dsnt"}),
    ("ablation_resolution", ["--base-model", "resnet18", "--dilates", "1",
                             "--heads", "dsnt"],
     "ablation_resolution.json", {"dilate1_dsnt"}),
    ("ablation_reg", ["--base-model", "resnet18", "--regs", "js"],
     "ablation_reg.json", {"reg_js"}),
])
def test_ablation_one_cell_grid_on_cpu(driver, args, doc, cells, monkeypatch,
                                       tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    calls = []
    monkeypatch.setattr(ablation_common, "run", _tiny_in_process(calls))
    tmod = importlib.import_module(f"dsnt_pose2d_tpu_torch.tools.{driver}")
    assert tmod.main(["--data-dir", str(data), *args, "--epochs", "1",
                      "--batch-size", "4", "--device", "cpu"]) == 0
    got = json.loads((data / doc).read_text())
    reference = _doc(doc)
    reference.pop("caveat", None)    # a note added to the record by hand
    _same_keys(got, reference)
    assert set(got["results"]) == cells
    for r in got["results"].values():
        assert 0.0 <= r["pckh_total"] <= 100.0
    assert [c[2] for c in calls] == ["dsnt_pose2d_tpu_torch.cli.train",
                                     "dsnt_pose2d_tpu_torch.cli.evaluate"]


def test_flagship_report_one_epoch_on_cpu(monkeypatch, tmp_path):
    from dsnt_pose2d_tpu_torch.bench import step

    data = tmp_path / "data"
    data.mkdir()
    for k, v in BENCH_TINY.items():
        monkeypatch.setenv(k, v)
    real = step.measure_step
    monkeypatch.setattr(step, "measure_step", lambda **kw: real(
        **{**kw, "iters": 1, "warmup": 1, "repeats": 1}))
    monkeypatch.setattr(ablation_common, "run", _tiny_in_process([]))
    assert flagship_report.main(["--data-dir", str(data), "--epochs", "1",
                                 "--batch-size", "4", "--device", "cpu"]) == 0
    got = json.loads((data / "flagship" / "flagship_hg8_report.json").read_text())
    _same_keys(got, _doc("flagship_hg8_report.json"))
    assert set(got["per_epoch"][0]) == set(
        _doc("flagship_hg8_report.json")["per_epoch"][0])
    assert got["config"]["base"] == "hg8" and got["device_step_img_s"] > 0
    assert 0.0 <= got["pckh_total"] <= 100.0


def test_sweep_worker_program_and_parse(monkeypatch):
    code = sweep_train_step.worker_code("b64_nopallas",
                                        dict(batch=64, use_pallas=False), 8)
    assert "measure_step(iters=8, repeats=3, device='cuda', " \
           "**{'batch': 64, 'use_pallas': False})" in code
    assert [c[0] for c in sweep_train_step.CONFIGS] == [
        "b16", "b32", "b64", "b128", "b64_remat", "b128_remat", "b256_remat",
        "b64_nopallas", "b64_k4"]
    row = sweep_train_step.parse_worker("b128", "", "x" * 600 + "OutOfMemoryError")
    assert row == {"label": "b128", "error": ("x" * 600 + "OutOfMemoryError")[-500:]}
    line = json.dumps({"label": "b16", "ips": 1.0})
    assert sweep_train_step.parse_worker("b16", "noise\n" + line, "") == \
        {"label": "b16", "ips": 1.0}


def test_sweep_run_one_on_cpu(monkeypatch):
    for k, v in {**BENCH_TINY, "OMP_NUM_THREADS": "1"}.items():
        monkeypatch.setenv(k, v)
    rec = sweep_train_step.run_one("tiny", dict(batch=2, base="hg1",
                                                use_pallas=False, remat=True),
                                   iters=1, device="cpu", repeats=1)
    assert rec["label"] == "tiny" and rec["ips"] > 0 and rec["mfu"] is None
    assert rec["cfg"] == {"batch": 2, "base": "hg1", "use_pallas": False,
                          "remat": True}


def test_bench_infer_worker_and_table_on_cpu(monkeypatch):
    from dsnt_pose2d_tpu_torch.data import synthetic

    # The worker's 384-px canvases cut to 48 px: the batch-1 latency alone
    # takes 3 x 192 calls.
    make = synthetic.make_synthetic_mpii
    monkeypatch.setattr(synthetic, "make_synthetic_mpii",
                        lambda n, canvas_size, seed: make(n, 48, seed))
    rec = bench_infer.measure_base("hg1", 16, 1, 1, "cpu", hg_features=8,
                                   hg_depth=1, input_size=32)
    doc = _doc("infer_bench.json")[0]
    assert set(rec) == set(doc)
    assert set(rec["throughput"]) == set(doc["throughput"]) == set(rec["latency_b1"])
    assert rec["throughput"]["ips"] > 0 and rec["batch"] == 16
    text = bench_infer.table([rec, {"base": "x", "error": "e"}], 16)
    assert text.splitlines()[1] == "| base | params (M) | img/s @ b16 | ms/img @ b1 |"
    assert len(text.splitlines()) == 4
    assert bench_infer.parse_worker("hg2", "", "boom") == {"base": "hg2",
                                                           "error": "boom"}
    assert bench_infer.parse_worker("hg2", json.dumps(rec), "") == rec


def test_profile_step_writes_a_trace_on_cpu(monkeypatch, tmp_path, capsys):
    for k, v in BENCH_TINY.items():
        monkeypatch.setenv(k, v)
    assert profile_step.main(["--base", "hg1", "--batch", "2", "--steps", "1",
                              "--out", str(tmp_path), "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["trace_files"] == [str(tmp_path / profile_step.TRACE_FILE)]
    events = json.loads((tmp_path / profile_step.TRACE_FILE).read_text())
    assert events["traceEvents"]
    assert rec["flop_counter_tflop_per_step"] > 0 and rec["implied_mfu"] is None
