"""The port's telemetry: the profile hook (``train/profiling.py``), the
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

from dsnt_pose2d_tpu_torch.data.synthetic import make_synthetic_mpii
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
from dsnt_pose2d_tpu_torch.train import loop
from dsnt_pose2d_tpu_torch.train.dashboard import serve
from dsnt_pose2d_tpu_torch.train.profiling import annotate, make_profile_hook
from dsnt_pose2d_tpu_torch.utils.config import Config, DataConfig, ModelConfig

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _epoch(tag: str):
    """A stand-in epoch: a few ops under a named range."""
    with annotate(f"epoch_{tag}"):
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
