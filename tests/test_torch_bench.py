"""The port's bench entry points on the CPU (``--device cpu``, tiny knobs).

``bench.step`` and ``bench.kernel`` run as subprocesses, as a user runs
them, with the tiny model of ``tests/test_bench_budget.py``; each must exit 0
and print parseable JSON lines with the expected keys and ``"device":
"cpu"``.  An exhausted budget still prints a partial line.  The FLOP count
that ``implied_mfu`` rests on is held against the analytic count of the
tiny model's convolutions.
"""

import json
import os
import subprocess
import sys

import pytest
import torch
from torch import nn

from dsnt_pose2d_tpu_torch.bench.step import count_flops
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
from dsnt_pose2d_tpu_torch.utils.config import ModelConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_ENV = {
    "BENCH_BASE": "hg1",
    "BENCH_HG_FEATURES": "16",
    "BENCH_HG_DEPTH": "1",
    "BENCH_INPUT_SIZE": "32",
    "BENCH_CANVAS": "48",
    "BENCH_BATCH": "4",
    "BENCH_ITERS": "3",
    "BENCH_REPEATS": "2",
    "OMP_NUM_THREADS": "2",
}


def _run(module, tmp_path, **env):
    env = {**os.environ, **TINY_ENV, "BENCH_FIXTURE_DIR": str(tmp_path / "fixture"),
           **env}
    proc = subprocess.run([sys.executable, "-m", module, "--device", "cpu"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.strip()]
    return proc, lines


def test_bench_step_prints_one_line_on_the_cpu(tmp_path):
    proc, lines = _run("dsnt_pose2d_tpu_torch.bench.step", tmp_path,
                       DSNT_BENCH_BUDGET_S="280")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert len(lines) == 1
    res = lines[0]
    assert res["device"] == "cpu" and res["card"] is None
    assert res["unit"] == "images/sec/chip" and res["value"] > 0
    assert res["budget"]["partial"] is False and "error" not in res
    assert res["tflops_per_step"] > 0 and res["implied_mfu"] is None
    for key in ("e2e", "e2e_resident"):
        assert res[key]["median"] > 0 and res[key]["vs_device_step_pct"] > 0
    assert res["e2e"]["resident"] is False and res["e2e_resident"]["resident"]
    assert res["e2e_resident"]["steps_per_dispatch"] == 4
    assert "[bench +" in proc.stderr


def test_bench_step_exhausted_budget_still_prints_a_partial_line(tmp_path):
    # A budget below the watchdog's margin: the watchdog fires at once.
    proc, lines = _run("dsnt_pose2d_tpu_torch.bench.step", tmp_path,
                       DSNT_BENCH_BUDGET_S="5")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert len(lines) == 1
    assert lines[0]["budget"]["partial"] is True
    assert lines[0]["budget"]["watchdog_fired"] is True
    assert lines[0]["device"] == "cpu"


def test_bench_kernel_prints_its_records_on_the_cpu(tmp_path):
    proc, lines = _run("dsnt_pose2d_tpu_torch.bench.kernel", tmp_path,
                       BENCH_ROWS="64", BENCH_KERNEL_ITERS="2")
    assert proc.returncode == 0, proc.stderr[-3000:]
    cal, shift, *heads = lines
    assert set(cal["calibration"]) == {"copy", "exp", "smax"}
    assert all(v["ms"] > 0 and v["gbps_read_write"] > 0
               for v in cal["calibration"].values())
    assert cal["device"] == "cpu" and cal["peak_hbm_gbps"] is None
    assert shift["kernel"] == "row_shift" and shift["ms"] > 0
    assert [h["reg"] for h in heads] == ["js", "none"]
    for h in heads:
        assert h["device"] == "cpu" and h["rows"] == 64
        for key in ("fwd_ms", "fwdbwd_ms", "oracle_fwd_ms", "oracle_fwdbwd_ms",
                    "fwd_frac_of_ceiling", "fwdbwd_frac_of_ceiling"):
            assert h[key] > 0, key
        assert h["fwd_frac_of_peak"] is None
        assert isinstance(h["meets_70pct_target"], bool)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flop_count_matches_the_convolutions(dtype):
    # FlopCounterMode's forward count of the tiny model against
    # sum(2 k^2 Cin/groups Cout Hout Wout B) over its Conv2d layers (the
    # bf16 backbone runs its convs under autocast).
    cfg = ModelConfig(base="hg1", hg_features=16, hg_depth=1, input_size=32,
                      dtype=dtype)
    model = build_pose_model(cfg, device="cpu", seed=0)
    images = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    convs = [m for m in model.net.modules() if isinstance(m, nn.Conv2d)]
    analytic = []

    def hook(conv, _inputs, out):
        b, c_out, h, w = out.shape
        kh, kw = conv.kernel_size
        analytic.append(2 * kh * kw * conv.in_channels // conv.groups
                        * c_out * h * w * b)

    handles = [c.register_forward_hook(hook) for c in convs]
    try:
        with torch.no_grad():
            counted = count_flops(lambda: model.forward(images, train=False))
    finally:
        for h in handles:
            h.remove()
    assert len(analytic) == len(convs) > 10
    assert counted == pytest.approx(sum(analytic), rel=1e-2)
