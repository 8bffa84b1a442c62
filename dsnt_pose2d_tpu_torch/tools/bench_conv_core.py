"""The hg8 step's conv core under the card's levers (port of
``tools/bench_conv_core.py``).

The JAX tool A/B-tested XLA flags (the latency-hiding scheduler, a larger
scoped-VMEM budget) on the flagship step, each case in a fresh subprocess
because the flags are process-wide, after a probe with a bogus flag that
checked the flags reached the compiler at all.  On the card the
counterparts are cuDNN's algorithm search and the tensors' memory format:

1. ``baseline_b16``: :func:`..bench.step.measure_step` at batch 16, the
   port's defaults (``torch.backends.cudnn.benchmark`` off, the default
   memory format);
2. ``cudnn_benchmark_b16``: ``cudnn.benchmark`` on (cuDNN times its
   algorithms for each new shape and keeps the fastest);
3. ``channels_last_b16``: the model's weights in channels-last (NHWC), so
   the convs may take NHWC kernels (``measure_step(channels_last=True)``);
4. ``baseline_b32`` and the best lever of 2-3 at batch 32
   (``<lever>_b32``; none when the baseline won at 16).

Each case runs in a fresh subprocess (cuDNN's flag is process-wide and its
choices are cached per process).  The bogus-flag probe becomes a
``propagated`` record read inside each case's subprocess: the
``cudnn.benchmark`` flag as the step saw it, and the memory format of
every conv's input in the step's first forward (a global forward
pre-hook, removed when that forward ends, before anything is timed).  A
lever that did not reach the step (the flag not as set; for channels-last,
a conv after the stem with an input in another format) is reported
``not_propagated`` with no times.  CUDA graphs are not a case: four
things block their capture today (``ROADMAP.md``, Queue 1's step-speed
item).

Usage: python -m dsnt_pose2d_tpu_torch.tools.bench_conv_core [--repeats 5] [--report FILE] [--device cpu]

Writes one JSON report (default ``bench_conv_core.json`` in the temporary
directory): one record per case with ``measure_step``'s keys, ``case``
and ``propagated``; and ``winner_b16``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

from ..cli.common import add_device_arg
from ..device import resolve_device
from .ablation_common import REPO

# case -> (cudnn.benchmark, channels_last)
LEVERS = {"baseline": (False, False), "cudnn_benchmark": (True, False),
          "channels_last": (False, True)}


def conv_probe():
    """Install global hooks that record, during the next ``PoseNet``
    forward, each ``Conv2d`` input's memory format, and remove themselves
    when that forward ends.  Returns the record (filled in place)."""
    import torch
    from torch import nn
    from torch.nn.modules import module as nn_module

    record = {"conv_inputs": 0, "conv_inputs_channels_last": 0,
              "first_conv_input": None}
    handles = []

    def pre(mod, args):
        if isinstance(mod, nn.Conv2d) and args and torch.is_tensor(args[0]):
            cl = args[0].dim() == 4 and args[0].is_contiguous(
                memory_format=torch.channels_last) and not args[0].is_contiguous()
            record["conv_inputs"] += 1
            record["conv_inputs_channels_last"] += int(cl)
            if record["first_conv_input"] is None:
                record["first_conv_input"] = "channels_last" if cl else "contiguous"

    def post(mod, args, out):
        if type(mod).__name__ == "PoseNet":
            for h in handles:
                h.remove()

    handles += [nn_module.register_module_forward_pre_hook(pre),
                nn_module.register_module_forward_hook(post)]
    return record


def worker_code(batch: int, repeats: int, iters: int, benchmark: bool,
                channels_last: bool, device: str) -> str:
    """The case's program: one measurement, one ``RESULT`` line."""
    return (
        "import json, torch\n"
        f"torch.backends.cudnn.benchmark = {benchmark!r}\n"
        "from dsnt_pose2d_tpu_torch.bench.step import measure_step\n"
        "from dsnt_pose2d_tpu_torch.tools.bench_conv_core import conv_probe\n"
        "seen = conv_probe()\n"
        f"out = measure_step(batch={batch}, repeats={repeats}, iters={iters}, "
        f"channels_last={channels_last!r}, device={device!r})\n"
        "seen['cudnn_benchmark'] = torch.backends.cudnn.benchmark\n"
        "print('RESULT ' + json.dumps({**out, 'propagated': seen}))\n")


def reached(lever: str, seen: dict) -> bool:
    """Whether ``lever`` reached the step: the flag as set; for
    channels-last, every conv input after the stem's channels-last (the
    stem takes the image batch as the step's preprocess makes it)."""
    benchmark, channels_last = LEVERS[lever]
    if seen.get("cudnn_benchmark") != benchmark:
        return False
    if channels_last:
        later = seen["conv_inputs_channels_last"] - (
            seen["first_conv_input"] == "channels_last")
        return seen["conv_inputs"] > 1 and later == seen["conv_inputs"] - 1
    return True


def run_case(lever: str, batch: int, repeats: int, iters: int,
             device: str = "cuda", timeout: float = 1800) -> dict:
    name = f"{lever}_b{batch}"
    benchmark, channels_last = LEVERS[lever]
    try:
        r = subprocess.run(
            [sys.executable, "-c", worker_code(batch, repeats, iters, benchmark,
                                               channels_last, device)],
            capture_output=True, text=True, timeout=timeout, cwd=REPO)
    except subprocess.TimeoutExpired:
        return {"case": name, "error": "timeout"}
    for line in r.stdout.splitlines():
        if line.startswith("RESULT "):
            out = json.loads(line[len("RESULT "):])
            out["case"] = name
            if not reached(lever, out["propagated"]):
                return {"case": name, "propagated": out["propagated"],
                        "not_propagated": True}
            return out
    return {"case": name, "error": (r.stdout + r.stderr)[-500:],
            "returncode": r.returncode}


def run(repeats: int = 5, iters: int = 20, device: str = "cuda", log=print) -> dict:
    results = {}

    def case(lever, batch):
        rec = run_case(lever, batch, repeats, iters, device)
        results[rec["case"]] = rec
        log(json.dumps(rec))
        return rec

    b16 = {lever: case(lever, 16) for lever in LEVERS}
    timed = {k: r["median"] for k, r in b16.items() if "median" in r}
    winner = max(timed, key=timed.get) if timed else "baseline"
    results["winner_b16"] = winner
    case("baseline", 32)
    if winner != "baseline":
        case(winner, 32)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--report", default=os.path.join(tempfile.gettempdir(),
                                                     "bench_conv_core.json"))
    add_device_arg(ap)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    results = run(args.repeats, device=args.device)
    with open(args.report, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.report}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
