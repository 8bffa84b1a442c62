"""Bench of the flagship train step on one card (port of ``bench.py``).

Measures images per second for the whole hg8 + DSNT + JS train step (train
augmentation on the card + forward + backward + RMSProp update, bf16
backbone, the fused DSNT head's kernels) at the batch already on the card,
then over whole epochs of the real input path: a packed uint8 archive ->
``ShardedLoader`` threads -> pinned non-blocking copies -> step
(``e2e``), and the same split resident on the card, each batch gathered
there (``e2e_resident``).  Prints ONE JSON line on stdout (progress goes to
stderr):

    {"metric": ..., "value": N, "unit": "images/sec/chip", "vs_baseline": N,
     "median": N, "min": N, "max": N, "spread_pct": N, "tflops_per_step": N,
     "implied_mfu": N, "e2e": {...}, "e2e_resident": {...}, "budget": {...},
     "device": ..., "card": ...}

``value`` is the median of ``BENCH_REPEATS`` two-point measurements: the
time of ``2 * iters`` steps less that of ``iters`` steps, each ending in a
``.item()`` of the last loss (the barrier), over ``iters``.
``tflops_per_step`` is counted by ``torch.utils.flop_counter.FlopCounterMode``
over one train step (convolutions and matrix products, forward and
backward); it does not see the ported CUDA kernels (launched through
``ctypes``), whose operations are a negligible share.  ``implied_mfu`` is
that count over the median step time and the card's dense bf16 peak
(``BENCH_PEAK_FLOPS``, default 989e12 for the H100 SXM); a repeat that implies
more than ``BENCH_MFU_CEILING`` (default 0.60) of it is a timing fault, not a
speedup, and is taken again.  On the CPU (``--device cpu``) the times are
the host's and no device metric (``implied_mfu``) is given.

The run keeps to a wall-clock budget (``DSNT_BENCH_BUDGET_S``, default 540
s): every stage logs ``[bench +Ns]`` to stderr, optional stages start only
with enough budget left, and a watchdog thread prints the partial line and
exits 0 shortly before the budget ends.  An exception prints the partial
line with ``error`` and exits 1.

``vs_baseline`` divides ``value`` by the PyTorch-CPU reference's images per
second cached in ``BENCH_BASELINE.json`` at the repo root, or is 0.0
without that file.

    python -m dsnt_pose2d_tpu_torch.bench.step                # on the card
    BENCH_BASE=hg1 BENCH_HG_FEATURES=16 BENCH_HG_DEPTH=1 BENCH_INPUT_SIZE=32 \\
      BENCH_CANVAS=48 BENCH_BATCH=4 python -m dsnt_pose2d_tpu_torch.bench.step --device cpu

Env knobs: BENCH_BATCH, BENCH_ITERS, BENCH_REPEATS, BENCH_SKIP_E2E,
BENCH_E2E_STEPS_PER_DISPATCH, BENCH_E2E_RESIDENT_DISPATCH, BENCH_PEAK_FLOPS,
BENCH_MFU_CEILING, BENCH_FIXTURE_DIR (default: ``dsnt_bench_fixture_torch``
in the temporary directory), DSNT_BENCH_BUDGET_S, and the model's
BENCH_BASE, BENCH_HG_FEATURES, BENCH_HG_DEPTH, BENCH_INPUT_SIZE,
BENCH_CANVAS.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .kernel import card_line

BASELINE_CACHE = Path(__file__).resolve().parents[2] / "BENCH_BASELINE.json"
H100_BF16_DENSE_FLOPS = 989e12   # NVIDIA H100 SXM data sheet, without sparsity
WATCHDOG_MARGIN_S = 12.0


class Budget:
    """Wall-clock budget of a run; ``seconds`` 0 or None means none."""

    def __init__(self, seconds: float | None):
        self.seconds = seconds or 0.0
        self.t0 = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def remaining(self) -> float:
        """Seconds left before the watchdog fires (inf without a budget)."""
        if not self.seconds:
            return math.inf
        return self.seconds - WATCHDOG_MARGIN_S - self.elapsed()


NO_BUDGET = Budget(None)


def stage(msg: str, budget: Budget = NO_BUDGET) -> None:
    print(f"[bench +{budget.elapsed():6.1f}s] {msg}", file=sys.stderr, flush=True)


def peak_flops() -> float:
    return float(os.environ.get("BENCH_PEAK_FLOPS", H100_BF16_DENSE_FLOPS))


def _flagship_config(batch: int, base: str = "hg8", steps_per_dispatch: int = 1,
                     use_pallas: bool = True, remat: bool = False, warp: str = ""):
    """BASELINE config #3 (hg8, 256 features, bf16 backbone, fused head with
    JS, shear warp, RMSProp); the model's size from the env knobs."""
    from ..utils.config import Config, DataConfig, ModelConfig, TrainConfig

    return Config(
        model=ModelConfig(
            base=base, output_strat="dsnt", reg="js", dtype="bfloat16",
            use_pallas=use_pallas, remat=remat,
            hg_features=int(os.environ.get("BENCH_HG_FEATURES", "256")),
            hg_depth=int(os.environ.get("BENCH_HG_DEPTH", "4")),
            input_size=int(os.environ.get("BENCH_INPUT_SIZE", "0"))),
        train=TrainConfig(batch_size=batch, steps_per_dispatch=steps_per_dispatch),
        data=DataConfig(warp_method=warp) if warp else DataConfig(),
    )


def count_flops(fn) -> float:
    """Floating-point operations of ``fn()`` as ``FlopCounterMode`` counts
    them (convolutions and matrix products, forward and backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def _last_loss(metrics: dict) -> float:
    """The barrier: reading the last step's loss waits for every step."""
    loss = metrics["loss"]
    return (loss if loss.ndim == 0 else loss[-1]).item()


def measure_step(batch: int = 32, iters: int = 20, warmup: int = 3,
                 repeats: int = 5, use_pallas: bool = True,
                 remat: bool = False, base: str = "hg8",
                 steps_per_dispatch: int = 1, warp: str = "",
                 device=DEFAULT_DEVICE, budget: Budget = NO_BUDGET) -> dict:
    """Repeated two-point measurement of the train step on a batch that is
    already on the device (the counterpart of ``bench.py::measure_tpu``).

    ``use_pallas=False`` runs the plain versions of the fused head (the
    plain ops head) and of ``row_shift``; ``remat`` checkpoints each stack
    (``torch.utils.checkpoint``); ``warp`` is the warp method (``shear``
    or ``gather``; empty: the config's default).  The repeat loop (with the
    MFU filter's retakes) stops when the budget nears its end, and reports
    the repeats that landed.
    """
    from ..data.augment import plain_row_shift

    with contextlib.nullcontext() if use_pallas else plain_row_shift():
        return _measure_step(batch, iters, warmup, repeats, base,
                             steps_per_dispatch, device, budget,
                             _flagship_config(batch, base, steps_per_dispatch,
                                              use_pallas, remat, warp))


def _measure_step(batch, iters, warmup, repeats, base, steps_per_dispatch,
                  device, budget, cfg) -> dict:
    from ..data.synthetic import make_synthetic_mpii
    from ..models.factory import build_pose_model
    from ..train.loop import make_multi_step, make_train_fn

    device = resolve_device(device)
    model = build_pose_model(cfg.model, device=device, seed=0)
    k = max(1, steps_per_dispatch)
    canvas = int(os.environ.get("BENCH_CANVAS", "384"))
    data = {key: torch.from_numpy(v).to(device) for key, v in
            make_synthetic_mpii(batch, canvas_size=canvas, seed=0).items()}
    train_step = make_train_fn(model, cfg, device)
    if k > 1:
        multi = make_multi_step(model, cfg, device, train_step=train_step)
        super_batch = {key: torch.stack([v] * k) for key, v in data.items()}
        step_fn = lambda: multi(super_batch)
    else:
        step_fn = lambda: train_step(data)
    stage(f"device step built (base={base} k={k} batch={batch})", budget)
    flops = count_flops(step_fn) / k
    stage(f"{flops / 1e12:.3f} TFLOP/step counted", budget)

    for _ in range(warmup):
        metrics = step_fn()
    _last_loss(metrics)
    stage("warmup done", budget)

    def timed(n: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            m = step_fn()
        _last_loss(m)
        return time.perf_counter() - t0

    on_card = device.type == "cuda"
    # A marginal time implying more than this share of the card's peak is a
    # timing fault between the two windows, not a speedup: it is dropped
    # and taken again, up to twice the repeats.  No filter on the CPU.
    mfu_ceiling = float(os.environ.get("BENCH_MFU_CEILING", "0.60"))
    floor = flops / (peak_flops() * mfu_ceiling) if on_card and flops else 0.0
    per_step, rejected, attempts, repeat_cost = [], [], 0, 0.0
    while len(per_step) < repeats and attempts < 2 * repeats:
        if attempts and budget.remaining() < 2.0 * repeat_cost:
            stage(f"deadline near: stopping after {attempts} repeat attempts",
                  budget)
            break
        attempts += 1
        ta = time.monotonic()
        t1 = timed(iters)
        t2 = timed(2 * iters)
        repeat_cost = max(repeat_cost, time.monotonic() - ta)
        dt = (t2 - t1) / (iters * k)
        (per_step if dt > floor else rejected).append(dt)
        stage(f"repeat {attempts}: {batch / dt:.1f} img/s"
              + ("" if dt > floor else " (rejected: above the MFU ceiling)"),
              budget)
    out = {"tflops_per_step": flops / 1e12, "repeats": len(per_step),
           "rejected_outliers": len(rejected), "steps_per_dispatch": k,
           "mfu_ceiling": mfu_ceiling if on_card else None,
           "flops_counted": "FlopCounterMode: convolutions and matrix products "
                            "of one train step, forward and backward; not the "
                            "ported CUDA kernels"}
    if not per_step:
        # Every repeat implied an impossible rate (or a negative marginal):
        # report the positive raw times, flagged in the line itself.
        per_step = [t for t in rejected if t > 0]
        out["all_repeats_rejected"] = True
        if not per_step:
            return {**out, "median": 0.0, "min": 0.0, "max": 0.0,
                    "spread_pct": 0.0, "implied_mfu": 0.0 if on_card else None}
    ips = sorted(batch / t for t in per_step)
    med_t = statistics.median(per_step)
    return {**out, "median": statistics.median(ips), "min": ips[0],
            "max": ips[-1], "spread_pct": 100.0 * (ips[-1] - ips[0]) / ips[0],
            "step_ms": med_t * 1e3,
            "implied_mfu": flops / med_t / peak_flops() if on_card else None}


def _ensure_e2e_fixture(n: int, canvas: int = 384) -> str:
    """A packed archive (:class:`..data.pack.PackedDataset` layout) of ``n``
    random samples, written once from seed 0 and kept on disk."""
    from ..data.pack import CANVAS_FILE, META_FILE

    root = os.environ.get("BENCH_FIXTURE_DIR") or os.path.join(
        tempfile.gettempdir(), "dsnt_bench_fixture_torch")
    out = os.path.join(root, f"n{n}_c{canvas}")
    if os.path.exists(os.path.join(out, META_FILE.format(subset="train"))):
        return out
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(0)
    canvases = np.lib.format.open_memmap(
        os.path.join(out, CANVAS_FILE.format(subset="train")), mode="w+",
        dtype=np.uint8, shape=(n, canvas, canvas, 3))
    for i in range(n):  # one sample at a time keeps the peak memory flat
        canvases[i] = rng.integers(0, 256, size=(canvas, canvas, 3),
                                   dtype=np.uint8)
    canvases.flush()
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy()
    np.savez(os.path.join(out, META_FILE.format(subset="train")),
             coords_px=rng.uniform(canvas * 0.2, canvas * 0.8,
                                   (n, 16, 2)).astype(np.float32),
             mask=np.ones((n, 16), np.float32),
             head_length=np.full((n,), 45.0, np.float32),
             canvas_from_orig=eye,
             canvas_margin=np.full((n,), 1.5, np.float32))
    return out


def measure_e2e(batch: int = 16, repeats: int = 3, epoch_steps: int = 24,
                base: str = "hg8", steps_per_dispatch: int = 1,
                workers: int = 4, resident: bool = False, canvas: int = 0,
                prefetch_depth: int = 2, device=DEFAULT_DEVICE,
                budget: Budget = NO_BUDGET) -> dict:
    """Epoch throughput over the real input path, images per second.

    ``resident=False``: mmap read -> collate -> pinned non-blocking copy ->
    step (streaming).  ``resident=True``: the packed split staged on the
    device once (:class:`..data.resident.ResidentTrainData`), each step
    gathering its batch there from a ``(B,)`` index vector.  The first
    epoch warms up (page cache, staging, cuDNN's choices); measurement
    epochs stop early when the budget nears its end (at least one lands).
    """
    from ..data.loader import ShardedLoader, prefetch_to_device
    from ..data.pack import PackedDataset
    from ..models.factory import build_pose_model
    from ..train.loop import (_prefetch_dispatch_groups, make_multi_step,
                              make_resident_multi_step, make_resident_step,
                              make_train_fn)

    device = resolve_device(device)
    canvas = canvas or int(os.environ.get("BENCH_CANVAS", "384"))
    fixture = _ensure_e2e_fixture(batch * epoch_steps, canvas=canvas)
    ds = PackedDataset(fixture, "train")
    cfg = _flagship_config(batch, base=base, steps_per_dispatch=steps_per_dispatch)
    model = build_pose_model(cfg.model, device=device, seed=0)
    k = max(1, steps_per_dispatch)
    train_step = make_train_fn(model, cfg, device)

    if resident:
        from ..data.resident import ResidentTrainData

        rd = ResidentTrainData(ds, batch, device, seed=0)
        res_step = make_resident_step(model, cfg, device, train_step=train_step)
        res_multi = make_resident_multi_step(model, cfg, device,
                                             train_step=train_step)

        def epoch_steps_of(epoch: int):
            groups = rd.epoch_groups(epoch, k) if k > 1 else (
                ("single", idx) for idx in rd.epoch(epoch))
            for kind, idx in groups:
                if kind == "single":
                    yield 1, res_step(rd.resident, idx)
                else:
                    yield k, res_multi(rd.resident, idx)
    else:
        multi = make_multi_step(model, cfg, device, train_step=train_step)
        loader = ShardedLoader(ds, batch, shuffle=True, seed=0,
                               workers=workers, prefetch=prefetch_depth)

        def epoch_steps_of(epoch: int):
            if k > 1:
                for kind, payload in _prefetch_dispatch_groups(
                        loader.epoch(epoch), k, device):
                    if kind == "single":
                        yield 1, train_step(payload)
                    else:
                        yield k, multi(payload)
            else:
                for b in prefetch_to_device(loader.epoch(epoch), device,
                                            prefetch_depth):
                    yield 1, train_step(b)

    def run_epoch(epoch: int) -> float:
        t0 = time.perf_counter()
        steps, last = 0, None
        for n, metrics in epoch_steps_of(epoch):
            steps += n
            last = metrics
        _last_loss(last)
        return steps * batch / (time.perf_counter() - t0)

    label = "resident" if resident else "streaming"
    t0 = time.monotonic()
    run_epoch(0)
    epoch_cost = time.monotonic() - t0
    stage(f"e2e {label} k={k}: warmup epoch done ({epoch_cost:.1f}s)", budget)
    vals = []
    for r in range(repeats):
        if vals and budget.remaining() < 1.5 * epoch_cost:
            stage(f"deadline near: e2e {label} stopping after "
                  f"{len(vals)}/{repeats} epochs", budget)
            break
        te = time.monotonic()
        vals.append(run_epoch(1 + r))
        epoch_cost = time.monotonic() - te
    vals.sort()
    out = {"median": statistics.median(vals), "min": vals[0], "max": vals[-1],
           "steps_per_dispatch": k, "epoch_steps": epoch_steps,
           "epochs_measured": len(vals), "resident": resident,
           "canvas": canvas}
    if not resident:
        out["workers"] = workers   # the resident path has no host loader
    return out


def baseline_ips() -> float:
    """The PyTorch-CPU reference's images per second, or 0.0 without the
    cache file."""
    if BASELINE_CACHE.exists():
        return json.loads(BASELINE_CACHE.read_text())["torch_cpu_images_per_sec"]
    return 0.0


class _Run:
    """The one JSON line of a run: filled as stages land, printed once,
    by the main thread or by the watchdog."""

    def __init__(self, budget: Budget):
        self.budget = budget
        self.result = {"metric": "images/sec/chip (hg8+DSNT+JS fwd/bwd train step)",
                       "value": 0.0, "unit": "images/sec/chip",
                       "vs_baseline": 0.0, "budget": {"stages": []}}
        self.emitted = threading.Lock()
        self.done = threading.Event()

    def emit(self, partial: bool) -> bool:
        if not self.emitted.acquire(blocking=False):
            return False
        info = self.result["budget"]
        info.update(budget_s=self.budget.seconds or None,
                    elapsed_s=self.budget.elapsed(), partial=partial)
        print(json.dumps(self.result), flush=True)
        return True

    def watchdog(self) -> None:
        if not self.budget.seconds:
            return
        deadline = self.budget.seconds - WATCHDOG_MARGIN_S
        while not self.done.wait(
                timeout=min(1.0, max(0.05, deadline - self.budget.elapsed()))):
            if self.budget.elapsed() >= deadline:
                stage(f"WATCHDOG: budget {self.budget.seconds:.0f}s nearly "
                      "exhausted; printing the partial result", self.budget)
                self.result["budget"]["watchdog_fired"] = True
                if self.emit(partial=True):
                    # The main thread may be inside a long call that no
                    # signal interrupts; end the process from here.
                    os._exit(0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (default) or cpu (host clock, no device metrics)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    run = _Run(Budget(float(os.environ.get("DSNT_BENCH_BUDGET_S", "540") or 0)))
    budget, res = run.budget, run.result
    threading.Thread(target=run.watchdog, daemon=True,
                     name="bench-watchdog").start()
    stage(f"bench start (budget={budget.seconds or 'none'}s)", budget)
    batch = int(os.environ.get("BENCH_BATCH", "32"))
    iters = int(os.environ.get("BENCH_ITERS", "20"))
    repeats = int(os.environ.get("BENCH_REPEATS", "7"))
    base = os.environ.get("BENCH_BASE", "hg8")
    res.update(device="cpu" if device.type == "cpu"
               else torch.cuda.get_device_name(device),
               card=card_line(device), batch=batch)
    stages_done = res["budget"]["stages"]
    rc = 0
    try:
        dev = measure_step(batch=batch, iters=iters, repeats=repeats, base=base,
                           device=device, budget=budget)
        res.update(dev)
        res["value"] = dev["median"]
        stages_done.append("device_step")
        stage(f"headline: {dev['median']:.2f} img/s "
              f"(mfu={dev['implied_mfu']})", budget)
        base_ips = baseline_ips()
        res["vs_baseline"] = dev["median"] / base_ips if base_ips else 0.0
        stages_done.append("vs_baseline")
        if not os.environ.get("BENCH_SKIP_E2E"):
            for key, resident, knob, default, need_s in (
                    ("e2e", False, "BENCH_E2E_STEPS_PER_DISPATCH", "1", 90),
                    ("e2e_resident", True, "BENCH_E2E_RESIDENT_DISPATCH", "4", 120)):
                if budget.remaining() <= need_s:
                    stage(f"skipping {key} (budget)", budget)
                    res[key] = {"skipped": "budget"}
                    continue
                e2e = measure_e2e(
                    batch=batch, base=base, resident=resident,
                    steps_per_dispatch=int(os.environ.get(knob, default)),
                    device=device, budget=budget)
                e2e["vs_device_step_pct"] = (100.0 * e2e["median"] / dev["median"]
                                             if dev["median"] else None)
                res[key] = e2e
                stages_done.append(key)
    except Exception:
        import traceback

        traceback.print_exc()
        res["error"] = traceback.format_exc(limit=3).strip().splitlines()[-1]
        rc = 1
    finally:
        run.done.set()
        run.emit(partial="device_step" not in stages_done)
    return rc


if __name__ == "__main__":
    sys.exit(main())
