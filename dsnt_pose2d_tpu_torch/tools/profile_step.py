"""A ``torch.profiler`` trace of the flagship hg8 train step (port of
``tools/profile_step.py``).

Writes a Chrome trace (Perfetto, ``chrome://tracing``) of ``--steps`` train
steps (:func:`..train.profiling.trace_calls`), with each step's spans by
layer (``train.feed`` ... ``train.optimizer``) over its kernels, to
``<out>/train_step.pt.trace.json`` (``--out`` defaulting to
``dsnt_profile_step/hg8`` in the temporary directory) and prints one JSON line: the step time
(the two-point marginal of 10 and 20 steps, CUDA events on a card), the
FLOPs of one step as ``FlopCounterMode`` counts them (convolutions and
matrix products, forward and backward; the fused head and ``row_shift``,
launched through ``ctypes``, are not counted) and the implied MFU against
the card's dense bf16 peak (``BENCH_PEAK_FLOPS``, default 989e12), as
:mod:`..bench.step` computes it.  Bytes moved are not counted.  The trace
is a breakdown, never a timing: the profiler slows the host's dispatch.

    python -m dsnt_pose2d_tpu_torch.tools.profile_step [--batch 64] \\
        [--steps 6] [--out DIR] [--remat] [--warp gather] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from ..cli.common import add_device_arg
from ..device import resolve_device

TRACE_FILE = "train_step.pt.trace.json"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--base", default="hg8")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--warp", default="gather")
    p.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "dsnt_profile_step", "hg8"))
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from ..bench.step import _flagship_config, count_flops, peak_flops
    from ..bench.timing import window_s
    from ..data.synthetic import make_synthetic_mpii
    from ..models.factory import build_pose_model
    from ..train.loop import make_train_fn
    from ..train.profiling import trace_calls

    cfg = _flagship_config(args.batch, base=args.base, remat=args.remat,
                           warp=args.warp)
    model = build_pose_model(cfg.model, device=dev, seed=0)
    train_step = make_train_fn(model, cfg, dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             make_synthetic_mpii(args.batch, canvas_size=384, seed=0).items()}
    step = lambda: train_step(batch)

    flops = count_flops(step)
    for _ in range(3):
        step()
    trace = trace_calls(step, args.steps, os.path.join(args.out, TRACE_FILE))
    # Step time: the two-point marginal, free of fixed costs.
    step_s = (window_s(step, 20, dev) - window_s(step, 10, dev)) / 10
    on_card = dev.type == "cuda"
    rec = {
        "base": args.base, "batch": args.batch, "remat": args.remat,
        "warp": args.warp,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "step_ms": step_s * 1e3,
        "images_per_sec": args.batch / step_s,
        "flop_counter_tflop_per_step": flops / 1e12,
        "implied_mfu": flops / step_s / peak_flops() if on_card else None,
        "trace_files": [trace],
    }
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
