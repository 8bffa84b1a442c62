"""Head-ablation sweep (BASELINE config #4): dsnt vs gauss vs fc (port of
``tools/ablation_heads.py``).

Trains the same backbone with each of the three output strategies through
the port's CLIs over a data directory (the dress-rehearsal fixture, any
prepared MPII layout, or, in a directory without one, the CLIs' synthetic
fixture) and tabulates PCKh@0.5: the paper's central ablation (DSNT >
heatmap-matching > FC at equal backbone).

Usage (after ``python -m dsnt_pose2d_tpu_torch.tools.dress_rehearsal
--stages fabricate,prepare,pack``, or over any directory):

    python -m dsnt_pose2d_tpu_torch.tools.ablation_heads \\
        --data-dir /tmp/dress_rehearsal --epochs 8 --base-model hg2 \\
        [--device cpu]

Writes <data-dir>/ablation_heads.json and prints a markdown table.
"""

from __future__ import annotations

import argparse
import json
import os

from ..cli.common import add_device_arg
from ..device import resolve_device
from . import ablation_common


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-dir", required=True)
    p.add_argument("--base-model", default="hg2")
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--out-dir", default="")
    p.add_argument("--heads", default="dsnt,gauss,fc")
    add_device_arg(p)
    args = p.parse_args(argv)
    resolve_device(args.device)
    out_root = args.out_dir or os.path.join(args.data_dir, "ablation")

    results = {}
    for head in args.heads.split(","):
        results[head] = ablation_common.train_and_eval(
            args.data_dir, out_root, head,
            ["--base-model", args.base_model, *ablation_common.HEAD_FLAGS[head],
             "--batch-size", str(args.batch_size),
             "--epochs", str(args.epochs)], device=args.device)
        print(f"== {head}: PCKh {results[head]['pckh_total']} ==", flush=True)

    path = os.path.join(args.data_dir, "ablation_heads.json")
    meta = {"base_model": args.base_model, "epochs": args.epochs,
            "batch_size": args.batch_size, "results": results}
    with open(path, "w") as f:
        json.dump(meta, f, indent=1)
    print(f"wrote {path}")
    print("| head | PCKh@0.5 total |")
    print("|---|---|")
    for head, r in results.items():
        print(f"| {head} | {r['pckh_total']} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
