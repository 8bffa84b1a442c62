"""Heatmap-resolution ablation: DSNT vs heatmap-matching as resolution drops
(port of ``tools/ablation_resolution.py``).

The companion paper's central finding: with a ResNet backbone, DSNT beats
heatmap-matching (``gauss``) by a wide margin at LOW heatmap resolutions
and the gap narrows as resolution grows, because DSNT's expectation decode
is sub-pixel while argmax plus a quarter offset quantizes to the heatmap
grid.  The resolution is swept by the ResNet ``dilate`` flag (the last N
stages' stride swapped for dilation; each dilated stage doubles the map).

This sweeps ``--dilate {0,1,2}`` x ``--output-strat {dsnt,gauss}`` on a
ResNet backbone through the port's CLIs and tabulates PCKh@0.5.  At the
ResNet's default 224-px input, dilate 0/1/2 = 7x7 / 14x14 / 28x28
heatmaps, the shapes the fused head's kernels take on this grid.  The
table's ``heatmap`` column keeps the JAX tool's label, ``8 * 2**dilate``:
the maps at a 256-px input.

Usage:

    python -m dsnt_pose2d_tpu_torch.tools.ablation_resolution \\
        --data-dir /tmp/dress_rehearsal --epochs 10 --base-model resnet34

Writes <data-dir>/ablation_resolution.json and prints a markdown table.
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
    p.add_argument("--base-model", default="resnet34")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--dilates", default="0,1,2")
    p.add_argument("--heads", default="dsnt,gauss")
    p.add_argument("--out-dir", default="")
    add_device_arg(p)
    args = p.parse_args(argv)
    resolve_device(args.device)
    out_root = args.out_dir or os.path.join(args.data_dir,
                                            "ablation_resolution")

    results = {}
    for dilate in [int(d) for d in args.dilates.split(",")]:
        for head in args.heads.split(","):
            key = f"dilate{dilate}_{head}"
            r = ablation_common.train_and_eval(
                args.data_dir, out_root, key,
                ["--base-model", args.base_model, "--dilate", str(dilate),
                 *ablation_common.HEAD_FLAGS[head],
                 "--batch-size", str(args.batch_size),
                 "--epochs", str(args.epochs)], device=args.device)
            r.pop("table", None)
            results[key] = {"dilate": dilate, "head": head, **r}
            print(f"== {key}: PCKh {results[key]['pckh_total']} ==",
                  flush=True)

    path = os.path.join(args.data_dir, "ablation_resolution.json")
    meta = {"base_model": args.base_model, "epochs": args.epochs,
            "batch_size": args.batch_size, "results": results}
    with open(path, "w") as f:
        json.dump(meta, f, indent=1)
    print(f"wrote {path}")
    print("| dilate | heatmap | dsnt PCKh | gauss PCKh | gap |")
    print("|---|---|---|---|---|")
    for dilate in [int(d) for d in args.dilates.split(",")]:
        d = results.get(f"dilate{dilate}_dsnt", {}).get("pckh_total")
        g = results.get(f"dilate{dilate}_gauss", {}).get("pckh_total")
        hm = 8 * (2 ** dilate)
        gap = (round(d - g, 2) if d is not None and g is not None else "")
        print(f"| {dilate} | {hm}x{hm} | {d} | {g} | {gap} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
