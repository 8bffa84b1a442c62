"""Sweep the hg8 train step's throughput over its knobs (port of
``tools/sweep_train_step.py``).

Runs each configuration of :func:`..bench.step.measure_step` in a fresh
subprocess (its own allocator and cuDNN state; a configuration that does
not fit on the card fails alone and stays an ``{"label", "error"}`` row),
prints one JSON line per configuration, and a final ranked summary.

    python -m dsnt_pose2d_tpu_torch.tools.sweep_train_step [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from ..cli.common import add_device_arg
from ..device import resolve_device
from .ablation_common import REPO

CONFIGS = [
    # (label, kwargs for bench.step.measure_step)
    ("b16", dict(batch=16)),
    ("b32", dict(batch=32)),
    ("b64", dict(batch=64)),
    ("b128", dict(batch=128)),
    ("b64_remat", dict(batch=64, remat=True)),
    ("b128_remat", dict(batch=128, remat=True)),
    ("b256_remat", dict(batch=256, remat=True)),
    ("b64_nopallas", dict(batch=64, use_pallas=False)),
    ("b64_k4", dict(batch=64, steps_per_dispatch=4)),
]


def worker_code(label: str, kwargs: dict, iters: int, device: str = "cuda",
                repeats: int = 3) -> str:
    """The worker's program: one measurement, one JSON line."""
    return (
        "import json\n"
        "from dsnt_pose2d_tpu_torch.bench.step import measure_step\n"
        f"r = measure_step(iters={iters}, repeats={repeats}, "
        f"device={device!r}, **{kwargs!r})\n"
        f"print(json.dumps({{'label': {label!r}, 'ips': r['median'],"
        f" 'min': r['min'], 'max': r['max'], 'mfu': r['implied_mfu'],"
        f" 'cfg': {kwargs!r}}}))\n"
    )


def parse_worker(label: str, stdout: str, stderr: str) -> dict:
    """The worker's last JSON line, or an error row with its stderr's tail."""
    line = [l for l in stdout.strip().splitlines() if l.startswith("{")]
    if not line:
        return {"label": label, "error": stderr.strip()[-500:]}
    return json.loads(line[-1])


def run_one(label: str, kwargs: dict, iters: int, device: str = "cuda",
            repeats: int = 3, timeout: float = 1800) -> dict:
    try:
        out = subprocess.run(
            [sys.executable, "-c", worker_code(label, kwargs, iters, device,
                                               repeats)],
            cwd=REPO, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"label": label, "error": "timeout"}
    return parse_worker(label, out.stdout, out.stderr)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true",
                   help="8 iterations per window instead of 20")
    add_device_arg(p)
    args = p.parse_args(argv)
    resolve_device(args.device)
    iters = 8 if args.quick else 20
    results = []
    for label, kwargs in CONFIGS:
        rec = run_one(label, kwargs, iters, args.device)
        print(json.dumps(rec), flush=True)
        results.append(rec)
    ok = [r for r in results if "ips" in r]
    ok.sort(key=lambda r: -r["ips"])
    print(json.dumps({"ranked": [(r["label"], r["ips"]) for r in ok]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
