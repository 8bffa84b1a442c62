"""Regularizer ablation: none vs var vs kl vs js vs mse for the DSNT head
(port of ``tools/ablation_reg.py``).

The companion paper's regularizer table: with a DSNT output head, the
distribution regularizers order JS >= KL >= variance >= none on PCKh@0.5
(MSE against the Gaussian is swept too).  This runs that table through the
port's CLIs with a dilated-ResNet backbone, all other knobs fixed; it takes
the fused head's forward kernel through its five regularizer branches and
the backward through its four.  ``--sigmas`` adds a target-Gaussian sigma
sweep for one regularizer (the paper sweeps sigma_t in {0.5, 1, 2} px).

Usage:

    python -m dsnt_pose2d_tpu_torch.tools.ablation_reg \\
        --data-dir /tmp/dress_rehearsal --epochs 10 --base-model resnet34 \\
        --dilate 1 --sigmas 0.5,2.0

Writes <data-dir>/ablation_reg.json and prints a markdown table.
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
    p.add_argument("--dilate", type=int, default=1)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--hm-sigma", type=float, default=1.0)
    p.add_argument("--regs", default="none,var,kl,js,mse")
    p.add_argument("--sigmas", default="",
                   help="optional extra hm-sigma values swept with --sigma-reg "
                        "(paper sweeps sigma_t in {0.5,1,2} px); comma list")
    p.add_argument("--sigma-reg", default="js")
    p.add_argument("--out-dir", default="")
    add_device_arg(p)
    args = p.parse_args(argv)
    resolve_device(args.device)
    out_root = args.out_dir or os.path.join(args.data_dir, "ablation_reg")

    # (label, reg, sigma) variants: the regularizer sweep at the default
    # sigma, plus an optional sigma sweep for one regularizer.
    variants = [(f"reg_{reg}", reg, args.hm_sigma)
                for reg in args.regs.split(",") if reg]
    for s in (args.sigmas.split(",") if args.sigmas else []):
        if abs(float(s) - args.hm_sigma) < 1e-9 and args.sigma_reg in \
                args.regs.split(","):
            continue  # already covered by the reg sweep
        variants.append((f"sigma_{s}_{args.sigma_reg}", args.sigma_reg,
                         float(s)))

    results = {}
    for key, reg, sigma in variants:
        r = ablation_common.train_and_eval(
            args.data_dir, out_root, key,
            ["--base-model", args.base_model, "--dilate", str(args.dilate),
             "--output-strat", "dsnt", "--reg", reg,
             "--reg-coeff", "1.0", "--hm-sigma", str(sigma),
             "--batch-size", str(args.batch_size),
             "--epochs", str(args.epochs)], device=args.device)
        r.pop("table", None)
        results[key] = {"reg": reg, "hm_sigma": sigma, **r}
        print(f"== {key}: PCKh {results[key]['pckh_total']} ==", flush=True)

    path = os.path.join(args.data_dir, "ablation_reg.json")
    meta = {"base_model": args.base_model, "dilate": args.dilate,
            "epochs": args.epochs, "batch_size": args.batch_size,
            "hm_sigma": args.hm_sigma, "results": results}
    with open(path, "w") as f:
        json.dump(meta, f, indent=1)
    print(f"wrote {path}")
    print("| variant | reg | sigma | PCKh@0.5 total |")
    print("|---|---|---|---|")
    for key, r in results.items():
        print(f"| {key} | {r['reg']} | {r['hm_sigma']} | {r['pckh_total']} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
