"""Readings of the comparison that decides ``correct``, for setting a cell's
limits: the program's on many seeds, and the controls' on a few, all in
one process.

    python3 -m posebench.calibrate --workload <cell> --seeds 11,12,13 \\
        --controls fp8,half_batch --control-seeds 3 [--seconds 3] [--out FILE]

For each seed: the cell's set-up and warm-up (a training cell's compared
steps are taken there), a window of ``--seconds`` (a serving cell answers
its requests there; 0 for training), the program's state freed, the fp32
reference, then on the first ``--control-seeds`` seeds each control run in
the program's place and held against the same reference: ``fp8`` (the
reference on fp8-rounded conv inputs and weights, the precision below the
configuration's bf16) and ``half_batch`` (the loss over half the rows, or
half of a request's crops answered).  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import compare, harness


def readings(name: str, seed: int, seconds: float, controls: list, device="cuda",
             cell=None) -> dict:
    cell = cell or harness.load_cell(name, seed, device)
    traffic = harness.generator(cell).Traffic(cell)
    traffic.window(seconds)
    traffic.release()
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = traffic.reference()
    prog = traffic.program()
    out = {"seed": seed, "program": traffic.compare(prog, ref)}
    if isinstance(ref, dict):
        g = ref["grad1"]
        median = compare.median(g.values())
        left_out = {n for n, v in g.items() if v < compare.ROUND_OFF_SHARE * median}
        grad_gaps = compare.leaf_gaps(prog["grad1"], g, list(g))
        # Each list: the leaves that set the number compared, worst first, as
        # (name, gap, reference gradient / median leaf's, the leaf's first
        # gradient gap, program's and reference's value, elements).
        out["worst_leaves"] = {
            key: [(n, v, g[n] / median, grad_gaps[n], prog[key][n], ref[key][n],
                   traffic.weights[n].numel()) for n, v in sorted(
                compare.leaf_gaps(prog[key], ref[key],
                                  [n for n in ref[key] if key == "grad1" or n not in left_out]
                                  ).items(), key=lambda kv: -kv[1])[:4]]
            for key in ("grad1", "change")}
        out["leaves_left_out"] = sorted(left_out)
    for control in controls:
        out[control] = traffic.compare(traffic.reference(control), ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="fp8,half_batch")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    controls = [c for c in args.controls.split(",") if c]
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        row = readings(args.workload, seed, args.seconds,
                       controls if i < args.control_seeds else [])
        row["took_s"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
