"""Where the streaming input path's time goes, against the resident one
(port of ``tools/bench_streaming.py``).

The JAX tool asked why streaming epochs (mmap-packed archive -> loader
threads -> host-to-device copy -> step) ran far below the device step
while the resident path kept up, and measured the pieces: the raw
host-to-device bandwidth, the streaming epoch over a grid of canvas
size x prefetch depth x steps per dispatch beside its transport ceiling
(bandwidth / bytes per image), and the resident epoch.  The same pieces on
the card:

1. ``h2d``: host-to-card copies of 1, 4, 16 and 64 MiB of uint8, pinned and
   non-blocking as the port's loader copies (``data/loader.py``,
   ``prefetch_to_device``), and from pageable memory
   (``h2d_pageable``); seconds per copy from CUDA events around windows of
   copies (:func:`..bench.timing.window_s`), the median of ``repeats``.
2. ``device_step_img_s``: :func:`..bench.step.measure_step` at ``--batch``.
3. ``streaming``: :func:`..bench.step.measure_e2e` at canvas {384, 320,
   256} x prefetch depth {2, 6} x k {1, 4} (``--quick``: canvas 384 and
   256, depth 2), each cell beside its transport ceiling and its share of
   the device step; ``resident_img_s``: the resident path at k = 4.

Usage: python -m dsnt_pose2d_tpu_torch.tools.bench_streaming [--quick] [--batch 16] [--out FILE] [--device cpu]

Writes one JSON report (default ``bench_streaming.json`` in the temporary
directory) with the JAX report's keys, plus ``h2d_pageable``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile

import numpy as np
import torch

from ..cli.common import add_device_arg
from ..device import resolve_device

SIZES_MB = (1, 4, 16, 64)
COPIES_PER_WINDOW = 4
STEPS_PER_DISPATCH = (1, 4)


def measure_h2d(sizes_mb=SIZES_MB, repeats: int = 5, device="cuda",
                pinned: bool = True) -> dict:
    """Host -> ``device`` bandwidth of uint8 payloads: per size, the median
    seconds per copy and ``MBps`` (MiB/s, as the JAX report's).  ``pinned``: from page-locked memory,
    non-blocking (the loader's copy); else from pageable memory."""
    from ..bench.timing import window_s

    dev = resolve_device(device)
    out = {}
    for mb in sizes_mb:
        n = int(mb * 2**20)
        host = torch.from_numpy(np.random.default_rng(0).integers(
            0, 255, size=n, dtype=np.uint8))
        if pinned:
            host = host.pin_memory()
        dst = torch.empty(n, dtype=torch.uint8, device=dev)

        def copy():
            dst.copy_(host, non_blocking=pinned)

        copy()   # first touch: allocator, mapping
        per = [window_s(lambda: copy(), COPIES_PER_WINDOW, dev) / COPIES_PER_WINDOW
               for _ in range(repeats)]
        med = statistics.median(per)
        out[f"{mb}MB"] = {"s_per_put": med, "MBps": mb / med if med else 0.0}
    return out


def run(batch: int = 16, quick: bool = False, device="cuda", canvases=None,
        h2d_kw=None, step_kw=None, e2e_kw=None, log=print) -> dict:
    """The report (see the module docstring); ``canvases`` overrides the
    grid's canvases, ``*_kw`` the measurements' counts."""
    from ..bench.step import measure_e2e, measure_step

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    h2d_kw, step_kw, e2e_kw = h2d_kw or {}, step_kw or {}, e2e_kw or {}
    # Pinned memory needs a card; on the CPU both rows are host copies.
    report = {"h2d": measure_h2d(device=dev, pinned=on_card, **h2d_kw),
              "h2d_pageable": measure_h2d(device=dev, pinned=False, **h2d_kw)}
    log(json.dumps({"h2d": report["h2d"], "h2d_pageable": report["h2d_pageable"]}))
    best_mbps = max(v["MBps"] for v in report["h2d"].values())
    report["h2d_best_MBps"] = best_mbps

    dev_step = measure_step(batch=batch, **{"repeats": 3, **step_kw}, device=dev)
    report["device_step_img_s"] = dev_step["median"]
    log(json.dumps({"device_step": dev_step}))

    canvases = canvases or ((384, 256) if quick else (384, 320, 256))
    depths = (2,) if quick else (2, 6)
    cells = []
    for canvas in canvases:
        ceiling = best_mbps * 2**20 / (canvas * canvas * 3)
        for depth in depths:
            for k in STEPS_PER_DISPATCH:
                e = measure_e2e(batch=batch, steps_per_dispatch=k, canvas=canvas,
                                prefetch_depth=depth, device=dev, **e2e_kw)
                cell = {"canvas": canvas, "prefetch_depth": depth,
                        "steps_per_dispatch": k, "img_s": e["median"],
                        "transport_ceiling_img_s": ceiling,
                        "pct_of_ceiling": 100.0 * e["median"] / ceiling,
                        "pct_of_device_step": 100.0 * e["median"] / dev_step["median"]}
                cells.append(cell)
                log(json.dumps(cell))
    report["streaming"] = cells
    res = measure_e2e(batch=batch, steps_per_dispatch=4, resident=True,
                      device=dev, **e2e_kw)
    report["resident_img_s"] = res["median"]
    log(json.dumps({"resident": res}))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="fewer cells (canvas 384/256, depth 2, k 1/4)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "bench_streaming.json"))
    add_device_arg(ap)
    args = ap.parse_args(argv)
    report = run(args.batch, args.quick, args.device)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
