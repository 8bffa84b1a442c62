"""The data-driven harness: a cell is found by its name, and everything that
belongs to it by the names its files give.

- ``BENCHMARK.json`` (the repository's root) lists the cells and metrics;
- ``posebench/workloads/<cell>.json``: the configuration, the traffic mix,
  the chips, the limits of the comparison that decides ``correct``;
- ``posebench/configs/<config>.json``: the port's configuration as it is
  run (``config``), its source, what was cut or assumed, how the weights
  are made, and optionally the ``reference`` backbone module's name
  (``posebench/reference/<reference>.py``);
- ``posebench/traffic/<traffic>.json``: the mix's parameters, among them
  the ``generator`` that drives it, ``posebench/generators/<generator>.py``;
- ``posebench/metrics/<metric>.py``: one reader a per-layer metric.

:func:`run_cell` drives one run: the generator's set-up and warm-up, the
timed window, with ``trace`` a profiled window after it, the program's
state freed, then the comparison with the reference.
"""

from __future__ import annotations

import gc
import importlib
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import compare, metrics
from .trace import TraceSummary, profile_device, profile_host

ROOT = Path(__file__).resolve().parent
_T0 = time.perf_counter()
TRACE_ATTEMPTS = 3
PORTED = ("dsnt_head_fwd", "dsnt_head_bwd", "row_shift")
# The model's compute type -> the peak its MFU is taken against (peaks.json).
COMPUTE_DTYPES = {"bfloat16": "bf16", "float32": "tf32"}


@dataclass
class Cell:
    name: str
    workload: dict
    config_file: dict
    traffic: dict
    e2e: list
    per_layer: list
    seed: int
    device: torch.device
    peaks: dict = field(default_factory=dict)

    @property
    def config(self) -> dict:
        """The run configuration the yardstick's functions take: the port's
        (``config``), with the configuration file's ``reference`` where it
        names one."""
        cfg = self.config_file["config"]
        if "reference" not in self.config_file:
            return cfg
        return {**cfg, "reference": self.config_file["reference"]}

    @property
    def limits(self) -> dict:
        return self.workload["limits"]


@dataclass
class Readings:
    """What a per-layer metric's reader reads."""

    trace: TraceSummary
    units: int
    calls: dict
    window: dict
    peaks: dict
    compute_dtype: str


def log(msg: str):
    """A progress line on standard error, with the process's seconds."""
    print(f"posebench: {time.perf_counter() - _T0:8.2f} s  {msg}", file=sys.stderr, flush=True)


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str, seed: int, device="cuda", bench_path: Path | None = None,
              root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files under ``root``."""
    bench = _json(bench_path or root.parent / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    workload = _json(root / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: {key} is {entry[key]!r} in BENCHMARK.json "
                             f"and {workload[key]!r} in its workload file")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", ())
                 or ("workloads" not in m and m["moves"] in moves)]
    return Cell(name=name, workload=workload,
                config_file=_json(root / "configs" / f"{entry['config']}.json"),
                traffic=_json(root / "traffic" / f"{entry['traffic']}.json"),
                e2e=e2e, per_layer=per_layer, seed=seed,
                device=torch.device(device), peaks=_json(root / "peaks.json"))


def generator(cell: Cell):
    return importlib.import_module(f"posebench.generators.{cell.traffic['generator']}")


def program_model(cfg, state_dict: dict, device):
    """The port's model for ``cfg`` holding ``state_dict``."""
    from dsnt_pose2d_tpu_torch.models.factory import PoseModel, PoseNet

    with torch.device(device):
        net = PoseNet(cfg.model)
    net.load_state_dict(state_dict, strict=True)
    return PoseModel(net=net.eval(), cfg=cfg.model, device=torch.device(device))


def program_config(cell: Cell):
    """The port's ``Config`` from the configuration file, its train seed the
    run's (the augmentation draws follow it)."""
    import dataclasses

    from dsnt_pose2d_tpu_torch.utils.config import config_from_json

    cfg = config_from_json(json.dumps(cell.config_file["config"]))
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=cell.seed))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def launch_counts() -> dict:
    from dsnt_pose2d_tpu_torch.ops import cuda

    counts = cuda.launch_counts()
    return {k: counts[k] for k in PORTED}


def traced_summary(traffic) -> tuple[TraceSummary, int, dict]:
    """A device-only profile of the generator's traced segment, taken again
    (up to TRACE_ATTEMPTS) where it shows no device activity or misses a
    launch of a ported kernel that the program's counters counted; then a
    host and device profile of one more segment for the idle gaps."""
    for _ in range(TRACE_ATTEMPTS):
        fn, units, calls = traffic.traced()
        before = launch_counts()
        summary = profile_device(fn)
        after = launch_counts()
        seen = all(len(summary.kernel_seconds(k)) == after[k] - before[k]
                   == len(calls.get(k, ())) for k in PORTED)
        if summary.busy_s > 0 and seen:
            summary.idle_gaps = profile_host(traffic.traced()[0]).idle_gaps
            return summary, units, calls
    raise RuntimeError("the profiler saw no device activity, or missed launches "
                       f"of the ported kernels, {TRACE_ATTEMPTS} times")


def run_cell(cell: Cell, seconds: float, trace: bool, t_start: float) -> dict:
    """One run of ``cell``: ``{"correct", "attempted", "failed", "metrics",
    "device", ["breakdown"], "checks"}``."""
    cuda = cell.device.type == "cuda"
    traffic = generator(cell).Traffic(cell)
    setup_s = time.perf_counter() - t_start
    log("set-up done; window")
    win = traffic.window(seconds)
    log("window done")
    metrics_out = {}
    if trace:
        win["flops"] = win["work"] * traffic.flops_per_work()
        summary, units, calls = traced_summary(traffic)
        ctx = Readings(trace=summary, units=units, calls=calls, window=win,
                       peaks=cell.peaks, compute_dtype=traffic.compute_dtype)
        for m in cell.per_layer:
            value = metrics.reader(m["name"])(ctx)
            if value is not None:
                metrics_out[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**win, "setup_s": setup_s}
        for m in cell.e2e:
            metrics_out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(cell.device) if cuda else "cpu",
              "count": cell.workload["chips"],
              "memory_peak_bytes": max(traffic.setup_peak_bytes, win["peak_bytes"])}
    if trace:
        device.update(busy_s=summary.busy_s, window_s=summary.window_s)
    traffic.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log("reference")
    readings = traffic.readings()
    log("reference done")
    ok, rows = compare.judge(readings, cell.limits)
    out = {"correct": ok and win["failed"] == 0, "attempted": win["attempted"],
           "failed": win["failed"], "metrics": metrics_out, "device": device}
    if trace:
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps}
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return out
