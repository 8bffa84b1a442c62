"""Flagship multi-epoch training report: hg8 + DSNT + JS (port of
``tools/flagship_report.py``).

Runs BASELINE config #3's model (8-stack hourglass, DSNT head, JS
regularizer, bf16 backbone, the fused head's kernels) through the port's
train CLI for a multi-epoch run over a data directory on the resident path
(``--steps-per-dispatch`` 4), evaluates, and writes a report with the PCKh
table, per-epoch throughput from the run's ``metrics.jsonl``, and the
steady-state ratio to the device step's bench
(:func:`..bench.step.measure_step`) at the same batch and k, in the same
process group of runs.

Usage:

    python -m dsnt_pose2d_tpu_torch.tools.flagship_report \\
        --data-dir /tmp/dress_rehearsal --epochs 60 [--skip-device-bench]

Writes ``--report`` (default ``<out-dir>/flagship_hg8_report.json``, the
out dir defaulting to ``<data-dir>/flagship``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics

from ..cli.common import add_device_arg
from ..device import resolve_device
from . import ablation_common

EXPERIMENT = "hg8_dsnt_js"


def per_epoch_records(metrics_file: str) -> list:
    """One entry per epoch of the run's metric stream: img/s, loss, val
    PCKh, and the sustained wall rate with the epoch's boundary (eval pass
    and checkpoint) counted."""
    per_epoch = []
    with open(metrics_file) as f:
        for line in f:
            rec = json.loads(line)
            if "images_per_sec" not in rec:
                continue
            entry = {
                "epoch": rec["epoch"],
                "img_s": round(rec["images_per_sec"], 1),
                "train_loss": round(rec.get("train_loss", 0.0), 5),
                "val_pckh": round(rec["val_pckh"], 4)
                if "val_pckh" in rec else None,
            }
            wall = (rec["epoch_seconds"] + rec.get("eval_seconds", 0.0)
                    + rec.get("ckpt_seconds", 0.0))
            images = rec["images_per_sec"] * rec["epoch_seconds"]
            entry["wall_img_s"] = round(images / max(wall, 1e-9), 1)
            entry["boundary_s"] = round(wall - rec["epoch_seconds"], 2)
            per_epoch.append(entry)
    return per_epoch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--steps-per-dispatch", type=int, default=4)
    ap.add_argument("--out-dir", default="")
    ap.add_argument("--skip-device-bench", action="store_true")
    ap.add_argument("--report", default="",
                    help="report path (default: "
                         "<out-dir>/flagship_hg8_report.json)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    out_root = args.out_dir or os.path.join(args.data_dir, "flagship")
    report_path = args.report or os.path.join(out_root,
                                              "flagship_hg8_report.json")

    r = ablation_common.train_and_eval(
        args.data_dir, out_root, EXPERIMENT,
        ["--base-model", "hg8", "--output-strat", "dsnt", "--reg", "js",
         "--reg-coeff", "1.0", "--hm-sigma", "1.0", "--dtype", "bfloat16",
         "--batch-size", str(args.batch_size),
         "--steps-per-dispatch", str(args.steps_per_dispatch),
         "--epochs", str(args.epochs)], device=args.device)

    per_epoch = per_epoch_records(
        os.path.join(out_root, EXPERIMENT, "metrics.jsonl"))
    # Steady state excludes epoch 0 (kernel builds, cuDNN's searches,
    # staging) and epoch 1 (any auto-pack or residency switch).
    steady = [e["img_s"] for e in per_epoch[2:]] or [0.0]
    steady_wall = [e["wall_img_s"] for e in per_epoch[2:]] or [0.0]
    report = {
        "config": {"base": "hg8", "output_strat": "dsnt", "reg": "js",
                   "dtype": "bfloat16", "batch_size": args.batch_size,
                   "steps_per_dispatch": args.steps_per_dispatch,
                   "epochs": args.epochs, "data_dir": args.data_dir},
        "pckh_total": r["pckh_total"],
        "pckh_table": r.get("table"),
        "train_s": r["train_s"],
        "per_epoch": per_epoch,
        "steady_state_img_s_median": round(statistics.median(steady), 1),
        "steady_state_wall_img_s_median": round(
            statistics.median(steady_wall), 1),
        "steady_state_img_s_min": round(min(steady), 1),
        "boundary_s_median": round(statistics.median(
            [e["boundary_s"] for e in per_epoch[2:]] or [0.0]), 2),
    }

    if not args.skip_device_bench:
        # The device step at the SAME batch and k, right after the run, so
        # the ratio compares like with like on one card.
        from ..bench.step import measure_step

        dev = measure_step(batch=args.batch_size, repeats=3,
                           steps_per_dispatch=args.steps_per_dispatch,
                           device=args.device)
        report["device_step_img_s"] = dev["median"]
        report["steady_state_vs_device_step_pct"] = round(
            100.0 * report["steady_state_img_s_median"] / dev["median"], 1)
        report["sustained_wall_vs_device_step_pct"] = round(
            100.0 * report["steady_state_wall_img_s_median"] / dev["median"],
            1)

    os.makedirs(os.path.dirname(os.path.abspath(report_path)), exist_ok=True)
    with open(report_path, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items()
                      if k not in ("pckh_table", "per_epoch")}, indent=1))
    print(f"wrote {report_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
