"""The port's telemetry: the profile hook (``train/profiling.py``) and the
spans and units of the train and serve steps (``utils/spans.py``), the
dashboard (``train/dashboard.py``, its routes as ``tests/test_dashboard.py``
holds the JAX package's) and ``--debug-nans`` (``train/loop.py::
set_debug_nans``), on the CPU."""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from torch.profiler import ProfilerActivity, profile

from dsnt_pose2d_tpu_torch.data.mpii import ArrayDataset
from dsnt_pose2d_tpu_torch.data.resident import ResidentTrainData
from dsnt_pose2d_tpu_torch.data.synthetic import make_synthetic_mpii
from dsnt_pose2d_tpu_torch.models import hrnet
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
from dsnt_pose2d_tpu_torch.models.hourglass import BatchNorm
from dsnt_pose2d_tpu_torch.train import loop
from dsnt_pose2d_tpu_torch.train.dashboard import serve
from dsnt_pose2d_tpu_torch.train.profiling import make_profile_hook, trace_calls
from dsnt_pose2d_tpu_torch.utils import spans
from dsnt_pose2d_tpu_torch.utils.config import Config, DataConfig, ModelConfig
from dsnt_pose2d_tpu_torch.utils.spans import Span, Unit, span

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _epoch(tag: str):
    """A stand-in epoch: a few ops under a span."""
    with span(f"epoch_{tag}"):
        x = torch.randn(64, 64)
        torch.mm(x, x).sum()


def _trace_names(path) -> set:
    return {e.get("name", "") for e in json.loads(Path(path).read_text())["traceEvents"]}


def test_profile_hook_traces_the_second_epoch(tmp_path):
    # Called at each epoch's end: it starts after epoch 0 and stops after
    # epoch 1, so the trace holds epoch 1 and neither epoch 0 nor 2.
    hook = make_profile_hook(str(tmp_path))
    for epoch in range(3):
        _epoch(str(epoch))
        hook(epoch, None, {})
    assert os.listdir(tmp_path) == ["epoch1.pt.trace.json"]
    names = _trace_names(tmp_path / "epoch1.pt.trace.json")
    assert "epoch_1" in names and "aten::mm" in names
    assert not {"epoch_0", "epoch_2"} & names


def test_profile_hook_writes_nothing_over_one_epoch(tmp_path):
    hook = make_profile_hook(str(tmp_path / "p"))
    _epoch("0")
    hook(0, None, {})      # started, and the run ends here
    hook.close()           # stopped unwritten
    assert not (tmp_path / "p").exists()
    assert not torch.autograd._profiler_enabled()


def test_profile_hook_traces_a_later_epoch(tmp_path):
    hook = make_profile_hook(str(tmp_path), epoch_to_trace=2)
    for epoch in range(4):
        _epoch(str(epoch))
        hook(epoch, None, {})
    assert os.listdir(tmp_path) == ["epoch2.pt.trace.json"]
    assert "epoch_2" in _trace_names(tmp_path / "epoch2.pt.trace.json")


TRAIN_SPANS = ["train.feed", "train.preprocess", "train.backbone", "train.head",
               "train.optimizer", "train.backward", "train.optimizer"]


def _tiny_model():
    cfg = Config(model=ModelConfig(base="hg1", hg_features=16, input_size=64,
                                   dtype="float32", reg="js"),
                 data=DataConfig(canvas_size=96))
    return cfg, build_pose_model(cfg.model, device="cpu", seed=0)


@pytest.fixture
def resident_multi():
    """A tiny hg1 resident 2-step dispatch: ``(run, model, batch size)``."""
    cfg, model = _tiny_model()
    data = ResidentTrainData(ArrayDataset(make_synthetic_mpii(8, 96, seed=0)), 2,
                             device="cpu", seed=0)
    step = loop.make_train_fn(model, cfg, "cpu", data.steps_per_epoch)
    multi = loop.make_resident_multi_step(model, cfg, "cpu", data.steps_per_epoch, step)
    kind, idx = next(data.epoch_groups(0, 2))
    assert kind == "multi" and idx.shape == (2, 2)
    spans.clear()
    yield (lambda: multi(data.resident, idx)), model, 2
    spans.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _bns(model) -> int:
    return sum(isinstance(m, BatchNorm) for m in model.net.modules())


def test_spans_record_nothing_without_a_profiler(resident_multi):
    run, _, _ = resident_multi
    assert not torch.autograd._profiler_enabled()
    assert span("train.feed") is span("bn") is spans.unit("train")
    run()
    assert spans.log() == []


def test_resident_multi_step_logs_its_steps(resident_multi):
    run, _, _ = resident_multi
    with _cpu_profile():
        run()
    gather, *units = spans.log()
    # The gather is logged outside the steps, before them; each step's
    # spans are its own, in order.
    assert isinstance(gather, Span) and (gather.name, gather.parent, gather.unit) == (
        "train.feed", None, None)
    assert [type(u) for u in units] == [Unit, Unit]
    assert [u.kind for u in units] == ["train", "train"] and units[0].id != units[1].id
    assert gather.end_ns <= units[0].spans[0].start_ns
    for u in units:
        top = [s for s in u.spans if s.parent is None]
        assert [s.name for s in sorted(top, key=lambda s: s.start_ns)] == TRAIN_SPANS
        assert {s.unit for s in u.spans} == {u.id}
        assert {s.parent for s in u.spans if s.name == "bn"} == {"train.backbone"}
        assert all(0 < s.ns for s in u.spans)
        ends = [s.end_ns for s in sorted(top, key=lambda s: s.start_ns)]
        assert ends == sorted(ends)
    assert units[0].spans[-1].end_ns <= units[1].spans[0].start_ns


def test_bn_spans_are_the_models_batchnorms(resident_multi):
    run, model, _ = resident_multi
    with _cpu_profile():
        run()
    assert _bns(model) > 0
    for u in spans.log()[1:]:
        assert sum(s.name == "bn" for s in u.spans) == _bns(model)


def test_a_train_step_alone_logs_one_unit():
    cfg, model = _tiny_model()
    step = loop.make_train_fn(model, cfg, "cpu")
    spans.clear()
    with _cpu_profile():
        step(make_synthetic_mpii(2, 96, seed=0))
    (u,) = spans.log()
    assert isinstance(u, Unit) and u.kind == "train"
    top = sorted((s for s in u.spans if s.parent is None), key=lambda s: s.start_ns)
    assert [s.name for s in top] == TRAIN_SPANS
    spans.clear()


# Widths 8/16/32/64, one block a branch, one module a stage: 3 exchange units.
TINY_HRNET = {"widths": (8, 16, 32, 64), "blocks": 1, "modules": (1, 1, 1),
              "stage1_blocks": 1}


@pytest.fixture
def hrnet_step(monkeypatch):
    """A tiny HRNet's train step, built by the factory for ``hrnet_w48``:
    ``(step, model, batch)``."""
    monkeypatch.setitem(hrnet.HRNET_SPECS, "hrnet_w48", TINY_HRNET)
    cfg = Config(model=ModelConfig(base="hrnet_w48", input_size=64, dtype="float32",
                                   reg="js"),
                 data=DataConfig(canvas_size=96))
    model = build_pose_model(cfg.model, device="cpu", seed=0)
    step = loop.make_train_fn(model, cfg, "cpu")
    spans.clear()
    yield step, model, make_synthetic_mpii(2, 96, seed=0)
    spans.clear()


def test_hrnet_logs_a_fuse_span_an_exchange_unit(hrnet_step):
    step, model, batch = hrnet_step
    with _cpu_profile() as prof:
        step(batch)
    (u,) = spans.log()
    fuse = [s for s in u.spans if s.name == "fuse"]
    modules = [m for m in model.net.modules() if isinstance(m, hrnet.HighResolutionModule)]
    assert len(fuse) == len(modules) == 3
    assert {s.parent for s in fuse} == {"train.backbone"}
    # The fuse terms' BNs run inside the fuse spans, the branches' outside.
    fuse_bns = sum(isinstance(m, BatchNorm) for mod in modules
                   for name, term in mod.named_children() if name.startswith("fuse")
                   for m in term.modules())
    inner = [s for s in u.spans if s.name == "bn" and s.parent == "fuse"]
    assert len(inner) == fuse_bns == 12
    assert all(any(f.start_ns <= s.start_ns and s.end_ns <= f.end_ns for f in fuse)
               for s in inner)
    assert sum(s.name == "bn" for s in u.spans) == _bns(model)
    # A range of the profiler's trace, where bn is the log's alone.
    names = {e.name for e in prof.events()}
    assert "fuse" in names and "bn" not in names


def test_fuse_host_pct_reads_the_fuse_spans(hrnet_step):
    from posebench import harness
    from posebench.metrics import fuse_host_pct
    from posebench.trace import TraceSummary

    step, _, batch = hrnet_step
    with _cpu_profile():
        step(batch)
        step(batch)
    # The reader's device-only segment of one unit is the first of the two.
    ctx = harness.Readings(trace=TraceSummary(window_s=1.0, busy_s=0.5, launches=1),
                           units=1, calls={}, window={}, peaks={}, compute_dtype="fp32")
    first = spans.log()[0]
    fuse = sum(s.ns for s in first.spans if s.name == "fuse")
    whole = sum(s.ns for s in first.spans if s.name == "train.backbone")
    got = fuse_host_pct.read(ctx)
    assert got == pytest.approx(100.0 * fuse / whole) and 0 < got < 100
    spans.clear()
    assert fuse_host_pct.read(ctx) is None


def test_infer_step_logs_one_request():
    cfg, model = _tiny_model()
    infer = loop.make_infer_fn(model, cfg, "cpu")
    crops = make_synthetic_mpii(3, 96, seed=1)
    spans.clear()
    with _cpu_profile():
        infer(crops)
    (u,) = spans.log()
    assert u.kind == "serve"
    top = sorted((s for s in u.spans if s.parent is None), key=lambda s: s.start_ns)
    assert [s.name for s in top] == ["serve.feed", "serve.preprocess", "serve.backbone",
                                     "serve.head", "serve.head", "serve.head"]
    assert {s.parent for s in u.spans if s.name == "bn"} == {"serve.backbone"}
    assert sum(s.name == "bn" for s in u.spans) == _bns(model)
    spans.clear()


def test_a_unit_inside_a_unit_joins_it():
    spans.clear()
    with _cpu_profile():
        with spans.unit("train") as outer:
            with spans.unit("train") as inner, span("a"):
                pass
            with span("b"):
                pass
        with spans.unit("train"):
            pass
    a, b = spans.log()
    assert inner is outer is a and a.id != b.id
    assert [s.name for s in a.spans] == ["a", "b"] and b.spans == []
    spans.clear()


def test_only_outermost_spans_log_outside_a_unit():
    # The eval step opens the serving spans outside any unit: its forward
    # and decode are logged, the BN calls nested in them are not.
    cfg, model = _tiny_model()
    evaluate = loop.make_eval_fn(model, cfg, "cpu")
    spans.clear()
    with _cpu_profile():
        evaluate(make_synthetic_mpii(2, 96, seed=2))
        with span("outer"), span("inner"):
            pass
    names = [e.name for e in spans.log()]
    assert isinstance(spans.log()[0], Span) and "bn" not in names and "inner" not in names
    assert {"serve.backbone", "serve.head"} <= set(names) and names[-1] == "outer"
    assert all(e.unit is None and e.parent is None for e in spans.log())
    spans.clear()


def test_a_span_closes_on_an_exception():
    spans.clear()
    with _cpu_profile():
        with pytest.raises(ValueError), spans.unit("serve"), span("serve.feed"):
            raise ValueError
        with spans.unit("serve"), span("serve.head"):
            pass
    a, b = spans.log()
    assert [s.name for s in a.spans] == ["serve.feed"]
    assert [(s.name, s.parent) for s in b.spans] == [("serve.head", None)]
    spans.clear()


def test_the_log_keeps_the_last_entries():
    spans.clear()
    with _cpu_profile():
        for _ in range(spans.MAX_ENTRIES + 5):
            with spans.unit("serve"):
                pass
    units = spans.log()
    assert len(units) == spans.MAX_ENTRIES
    assert [u.id for u in units] == sorted(u.id for u in units)
    spans.clear()
    assert spans.log() == []


def test_chrome_trace_holds_the_spans_on_the_ops_clock(resident_multi, tmp_path):
    # The spans are record_function ranges of the profiler's own trace:
    # the aten ops a span ran sit inside it on the same timeline.
    run, _, _ = resident_multi
    path = trace_calls(run, 1, str(tmp_path / "t.json"))
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X"]
    ranges = {n: [e for e in events if e["name"] == n] for n in set(TRAIN_SPANS)}
    assert len(ranges["train.feed"]) == 3 and len(ranges["train.backbone"]) == 2
    assert not [e for e in events if e["name"] == "bn"]     # bn: the log only

    def inside(op, names):
        return [e for e in events if e["name"] == op and any(
            s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"]
            for n in names for s in ranges[n])]
    convs = [e for e in events if e["name"] == "aten::conv2d"]
    assert convs and inside("aten::conv2d", ["train.backbone"]) == convs
    assert inside("aten::index", ["train.feed"])
    assert [type(e) for e in spans.log()] == [Span, Unit, Unit]


def test_dashboard_routes(tmp_path):
    (tmp_path / "samples").mkdir()
    (tmp_path / "samples" / "epoch0000_s0.png").write_bytes(b"\x89PNG fake")
    with open(tmp_path / "metrics.jsonl", "w") as f:
        f.write(json.dumps({"epoch": 0, "train_loss": 1.0}) + "\n")
        f.write(json.dumps({"epoch": 0, "val_pckh": 0.5}) + "\n")

    server = serve(str(tmp_path), port=0)  # ephemeral port
    port = server.server_address[1]
    base = f"http://127.0.0.1:{port}"
    try:
        page = urllib.request.urlopen(f"{base}/").read().decode()
        assert "dsnt-pose2d-tpu" in page and "canvas" in page
        metrics = urllib.request.urlopen(f"{base}/metrics").read().decode()
        assert "train_loss" in metrics
        samples = json.loads(urllib.request.urlopen(f"{base}/samples").read())
        assert samples == ["epoch0000_s0.png"]
        png = urllib.request.urlopen(f"{base}/samples/epoch0000_s0.png").read()
        assert png.startswith(b"\x89PNG")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nope")
        assert e.value.code == 404
    finally:
        server.shutdown()
        server.server_close()


def test_dashboard_page_is_the_jax_packages():
    # The port's own copy of the page: the same charts and routes.
    from dsnt_pose2d_tpu.train import dashboard as jdashboard
    from dsnt_pose2d_tpu_torch.train import dashboard

    assert dashboard._PAGE.replace(" (PyTorch)", "") == jdashboard._PAGE


def test_dashboard_runs_as_a_module():
    proc = subprocess.run([sys.executable, "-m", "dsnt_pose2d_tpu_torch.train.dashboard",
                           "--help"], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--dir" in proc.stdout and "--port" in proc.stdout


@pytest.fixture
def debug_nans():
    loop.set_debug_nans(True)
    try:
        yield
    finally:
        loop.set_debug_nans(False)
    assert not torch.is_anomaly_enabled() and not loop._DEBUG_NANS


def _tiny_step():
    cfg = Config(model=ModelConfig(base="hg1", hg_features=16, input_size=64,
                                   dtype="float32", reg="js"),
                 data=DataConfig(canvas_size=96))
    model = build_pose_model(cfg.model, device="cpu", seed=0)
    batch = make_synthetic_mpii(2, 96, seed=0)
    return loop.make_train_fn(model, cfg, device="cpu"), batch


def test_debug_nans_raises_on_a_nan_batch(debug_nans):
    assert torch.is_anomaly_enabled()
    step, batch = _tiny_step()
    before = {k: v.clone() for k, v in step.state.model.net.state_dict().items()}
    assert np.isfinite(step(batch)["loss"].item())       # a finite step runs
    batch = dict(batch, canvases=np.full_like(batch["canvases"], np.nan))
    with pytest.raises(FloatingPointError, match="the loss is nan"):
        step(batch)
    # The NaN step stopped before its optimizer step.
    assert step.state.step == 1 and step.state.optimizer.count == 1
    assert any(not torch.equal(before[k], v)
               for k, v in step.state.model.net.state_dict().items())


def test_debug_nans_raises_on_a_nan_gradient(debug_nans):
    # A backward function that returns NaN (here the gradient of sqrt at 0
    # times 0) raises in anomaly mode, as FloatingPointError.
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(FloatingPointError, match="returned nan values"):
        loop._backward_checked((torch.sqrt(x) * 0).sum(), [("x", x)])


def test_debug_nans_names_a_non_finite_gradient(debug_nans):
    # A finite loss whose gradient is inf (sqrt at 0): anomaly mode looks
    # for NaN only, the gradient check names the parameter.
    x = torch.ones(3, requires_grad=True)
    y = torch.ones(2, requires_grad=True)
    with pytest.raises(FloatingPointError, match="the gradient of y is not finite"):
        loop._backward_checked(x.sum() + torch.sqrt(y - 1).sum(), [("x", x), ("y", y)])


def test_debug_nans_off_by_default():
    assert not loop._DEBUG_NANS and not torch.is_anomaly_enabled()
