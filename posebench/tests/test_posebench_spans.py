"""The readers of the program's spans (``metrics/_spans.py`` and the
``*_host_ms`` and ``bn_host_pct`` metrics) on a hand-filled log."""

import json
import sys
from pathlib import Path

import pytest

import dsnt_pose2d_tpu_torch.utils
from dsnt_pose2d_tpu_torch.utils import spans
from dsnt_pose2d_tpu_torch.utils.spans import Span, Unit
from posebench import harness, metrics
from posebench.trace import TraceSummary

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
MS = 1_000_000
SPAN_METRICS = ("feed_host_ms", "preprocess_host_ms", "backbone_host_ms", "head_host_ms",
                "backward_host_ms", "optimizer_host_ms", "bn_host_pct")
NEW = [m for m in BENCH["per_layer"] if m["name"].split(".")[0] in SPAN_METRICS]


def _ctx(units: int) -> harness.Readings:
    return harness.Readings(trace=TraceSummary(window_s=1.0, busy_s=0.5, launches=1),
                            units=units, calls={}, window={}, peaks={},
                            compute_dtype="bf16")


def _unit(uid: int, kind: str, ms: dict, bn_ms=(), bn_parent=None):
    """A unit whose spans ``<kind>.<layer>`` last ``ms[layer]`` ms, laid
    end to end, with ``bn`` spans of ``bn_ms`` under ``bn_parent``."""
    u = Unit(id=uid, kind=kind)
    t = uid * 10_000 * MS
    for layer, d in ms.items():
        u.spans.append(Span(f"{kind}.{layer}", None, uid, t, t + int(d * MS)))
        t += int(d * MS)
    for d in bn_ms:
        u.spans.append(Span("bn", bn_parent or f"{kind}.backbone", uid, t, t + int(d * MS)))
    return u


@pytest.fixture
def log(monkeypatch):
    """Sets the program's log to the entries given."""
    def fill(entries):
        monkeypatch.setattr(spans, "log", lambda: list(entries))
    return fill


def _read(name, ctx):
    return metrics.reader(name)(ctx)


def test_the_device_only_segment_is_the_middle_of_the_last_2u(log):
    # Three segments of 2 units each: the reader takes the middle one.
    log([_unit(i, "serve", {"feed": 1.0 + i, "backbone": 10.0}) for i in range(6)])
    assert _read("feed_host_ms.serve", _ctx(2)) == pytest.approx((3.0 + 4.0) / 2)
    assert _read("backbone_host_ms.serve", _ctx(2)) == pytest.approx(10.0)


def test_too_few_units_read_none(log):
    log([_unit(i, "train", {"feed": 1.0}) for i in range(3)])
    assert _read("feed_host_ms.train", _ctx(2)) is None
    assert _read("feed_host_ms.train", _ctx(0)) is None
    log([])
    for name in SPAN_METRICS:
        assert _read(name, _ctx(4)) is None


def test_a_program_without_the_log_reads_none(monkeypatch):
    # The parent commit's program has no spans module: the readers leave
    # the metrics out.
    monkeypatch.delattr(dsnt_pose2d_tpu_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "dsnt_pose2d_tpu_torch.utils.spans", None)
    for name in SPAN_METRICS:
        assert _read(name, _ctx(1)) is None


def test_a_missing_span_reads_none(log):
    log([_unit(i, "serve", {"feed": 1.0, "backbone": 5.0}) for i in range(2)])
    assert _read("feed_host_ms.serve", _ctx(1)) == pytest.approx(1.0)
    assert _read("backward_host_ms.train", _ctx(1)) is None
    assert _read("bn_host_pct.serve", _ctx(1)) is None      # no bn span


def test_a_dispatch_span_is_shared_over_its_steps(log):
    # The resident gather of each 4-step dispatch is logged before its
    # steps, outside them: 8 ms, 2 ms a step, beside each step's own 1 ms
    # of feed.  The first dispatch's gather lasts 80 ms and the third's
    # 800: neither is the segment's.
    entries = []
    for d, gather in enumerate((80.0, 8.0, 800.0)):
        entries.append(Span("train.feed", None, None, 0, int(gather * MS)))
        entries += [_unit(4 * d + i, "train", {"feed": 1.0, "backward": 3.0})
                    for i in range(4)]
    log(entries)
    assert _read("feed_host_ms.train", _ctx(4)) == pytest.approx(1.0 + 8.0 / 4)
    assert _read("backward_host_ms.train", _ctx(4)) == pytest.approx(3.0)
    # With only the segment and the next logged, the gather before the
    # segment's first step is still its own.
    log(entries[5:])
    assert _read("feed_host_ms.train", _ctx(4)) == pytest.approx(1.0 + 8.0 / 4)


def test_two_spans_of_a_name_add(log):
    # zero_grad and the update are two train.optimizer spans of one step.
    u = _unit(0, "train", {"optimizer": 0.5, "backward": 3.0})
    u.spans.append(Span("train.optimizer", None, 0, 10**12, 10**12 + 2 * MS))
    log([u, _unit(1, "train", {"optimizer": 9.0})])
    assert _read("optimizer_host_ms.train", _ctx(1)) == pytest.approx(2.5)


def test_bn_share_of_the_backbone(log):
    # bn spans under the backbone count; a remat recompute's under the
    # backward do not.
    units = [_unit(i, "train", {"backbone": 100.0}, bn_ms=[20.0, 30.0]) for i in range(2)]
    for u in units:
        u.spans.append(Span("bn", "train.backward", u.id, 0, 40 * MS))
    log(units)
    assert _read("bn_host_pct.train", _ctx(1)) == pytest.approx(50.0)
    log([_unit(i, "serve", {"backbone": 40.0}, bn_ms=[4.0] * 3) for i in range(2)])
    assert _read("bn_host_pct.serve", _ctx(1)) == pytest.approx(30.0)


def test_the_harness_reports_them(log):
    # run_cell's loop over the cell's per-layer metrics, as a traced run
    # reaches it: each new metric of a cell reads from the log.
    log([_unit(i, "train", {layer: 1.0 + i for layer in
                            ("feed", "preprocess", "backbone", "head", "backward",
                             "optimizer")}, bn_ms=[0.5]) for i in range(8)])
    cell = harness.load_cell("hg8-train-resident", 1, device="cpu")
    names = [m["name"] for m in cell.per_layer if m["name"].split(".")[0] in SPAN_METRICS]
    assert len(names) == 7
    values = {n: _read(n, _ctx(4)) for n in names}
    # Units 0-3 of the 8 logged: 1, 2, 3 and 4 ms a layer, 0.5 ms of bn.
    assert values["feed_host_ms.train"] == pytest.approx(2.5)
    assert values["bn_host_pct.train"] == pytest.approx(100 * 4 * 0.5 / 10.0)


@pytest.mark.parametrize("entry", NEW, ids=lambda m: m["name"])
def test_new_entries(entry):
    # The checks test_benchmark_file makes of every entry, and the span metrics' own.
    cells = {w["name"]: w for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert entry["moves"] in e2e and entry["source"] == "host_clock"
    assert entry["workloads"] and set(entry["workloads"]) <= set(cells)
    for c in entry["workloads"]:
        assert c in e2e[entry["moves"]].get("workloads", [c])
    kind = entry["name"].split(".")[1]
    assert {cells[c]["traffic"] for c in entry["workloads"]} == (
        {"resident_train"} if kind == "train" else {"photo_requests"})
    assert callable(metrics.reader(entry["name"]))
    assert entry["unit"] == ("%" if entry["name"].startswith("bn_") else "ms")


def test_twelve_entries_at_the_end():
    assert len(NEW) == 12
    assert BENCH["per_layer"][-12:] == NEW
