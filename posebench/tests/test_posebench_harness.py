"""The result line, the files found by name, and the trace's reduction."""

import json
import math
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from posebench import harness, metrics, trace
from posebench import run as run_mod

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_result_line(name, tiny):
    cell = tiny(name)
    out = harness.run_cell(cell, 0.5, False, 0.0)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {m["name"] for m in cell.e2e}
    for m in cell.e2e:
        assert out["metrics"][m["name"]]["unit"] == m["unit"]
        assert math.isfinite(out["metrics"][m["name"]]["value"])
    assert set(out["checks"]) == set(cell.limits)
    assert out["device"]["platform"] == "cpu"
    json.dumps(out)


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert run_mod.main(["--workload", "hg8-train-resident", "--seed", "1",
                         "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_benchmark_file():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert (ROOT / "workloads" / f"{w['name']}.json").is_file()
        assert len(w["why"]) <= 200 and w["chips"] == 1
    for c in BENCH["configs"]:
        assert (ROOT.parent / c["file"]).is_file() and c["file"].startswith("posebench/")
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= cells
        assert m["moves"] in e2e
        # every cell of the metric reports the end-to-end metric it moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
        assert callable(metrics.reader(m["name"]))


def test_a_new_cell_is_files_only(tmp_path):
    """A cell added as a workload file and its BENCHMARK.json entry is found,
    with no file of the harness edited."""
    root = tmp_path / "posebench"
    for d in ("configs", "workloads", "traffic"):
        shutil.copytree(ROOT / d, root / d)
    shutil.copy(ROOT / "peaks.json", root / "peaks.json")
    bench = json.loads(json.dumps(BENCH))
    new = {"name": "hg8-serve-crowds", "config": "hg8_dsnt_js_train",
           "traffic": "crowd_requests", "chips": 1, "why": "a test cell"}
    bench["workloads"].append(new)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "hg8-serve-photos" in m.get("workloads", ()):
            m["workloads"].append(new["name"])
    traffic = json.loads((ROOT / "traffic" / "photo_requests.json").read_text())
    traffic["size_weights"] = [1.0] * 8
    (root / "traffic" / "crowd_requests.json").write_text(json.dumps(traffic))
    (root / "workloads" / "hg8-serve-crowds.json").write_text(json.dumps(
        {**{k: new[k] for k in ("config", "traffic", "chips", "why")},
         "limits": {"pred_gap_px": 1.0}}))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("hg8-serve-crowds", 3, "cpu", root=root)
    assert cell.traffic["size_weights"] == [1.0] * 8
    assert cell.config["model"]["base"] == "hg8"
    assert {m["name"] for m in cell.e2e} == {"serve_img_s", "serve_p95_ms", "setup_s"}
    assert "launches_per_request.serve" in {m["name"] for m in cell.per_layer}
    assert harness.generator(cell).__name__ == "posebench.generators.photo_requests"


def test_metric_readers_found_by_name():
    assert metrics.reader("device_idle_pct.train") is metrics.reader("device_idle_pct.serve")
    assert metrics.reader("row_shift_roofline_pct.anything").__module__.endswith(
        "row_shift_roofline_pct")


def test_window_img_s_reads_the_window_rate():
    ctx = harness.Readings(trace=None, units=0, calls={}, window={"train_img_s": 101.5},
                           peaks={}, compute_dtype="bf16")
    assert metrics.reader("window_img_s.host_bound")(ctx) == 101.5


def _event(name, start, end, cuda=False, parent=None):
    dev = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=dev, is_user_annotation=False,
                           time_range=SimpleNamespace(start=start, end=end), cpu_parent=parent)


def test_trace_reduction():
    win = _event(trace.WINDOW, 0, 100)
    ev = [win,
          _event("aten::conv2d", 0, 40, parent=win),
          _event("aten::mul", 40, 100, parent=win),
          _event("dsnt_head_fwd_kernel<1, false, Map64>", 10, 20, cuda=True),
          _event("void row_shift_kernel(float const*)", 15, 30, cuda=True),
          _event("Memcpy HtoD (Pageable -> Device)", 60, 70, cuda=True)]
    s = trace.summarize(ev)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(30e-6)     # [10, 30] and [60, 70]
    assert s.launches == 2
    assert s.kernel_seconds("dsnt_head_fwd") == [pytest.approx(10e-6)]
    assert s.kernel_seconds("dsnt_head_bwd") == []
    gaps = dict(s.idle_gaps)
    assert gaps["aten::conv2d"] == pytest.approx(10e-6)      # [0, 10]
    assert gaps["aten::mul"] == pytest.approx(60e-6)         # [30, 60] and [70, 100]
    d = trace.summarize_device(ev[3:], 1e-4)
    assert (d.busy_s, d.launches, d.window_s) == (pytest.approx(30e-6), 2, 1e-4)


def test_readers_leave_out_what_is_missing():
    empty = trace.TraceSummary(window_s=1.0, busy_s=0.0, launches=0)
    ctx = harness.Readings(trace=empty, units=0, calls={}, window={}, peaks={},
                           compute_dtype="bf16")
    for name in ("device_idle_pct", "step_mfu", "launches_per_step", "head_fwd_roofline_pct",
                 "row_shift_roofline_pct", "serve_peak_mem_gib", "window_img_s"):
        assert metrics.reader(name)(ctx) is None
