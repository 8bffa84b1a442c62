"""A/B of the row-shift kernel's two ``impl`` switches on the card (port of
``tools/bench_row_shift.py``).

The JAX tool timed its two Pallas kernels (``legacy``: a per-row dynamic
roll; ``vec``: a vectorised roll ladder) at the shapes of the hg8 batch-16
train step's shear passes: x-shear (6144, 3864) -> 2502 and y-shear (4096,
1674) -> 768, stride 3, on the same ``default_rng(0)`` inputs.  The port
has one Hopper kernel, ``ops/cuda/row_shift.cu``, which both switches of
:func:`..ops.cuda.row_shift.shift_rows` launch: expect a speedup of about
1.00 and outputs bitwise equal.  Each impl's device time per call
(:func:`..bench.timing.device_ms`: ``--iters`` calls queued back to back)
is printed beside the JAX tool's effective rate (one read of the whole
rows and one write of the output), the share of the calibrated copy
ceiling (:func:`..bench.kernel.calibrate`, the copy kernel's rate on this
card) that the JAX docstring names, and the largest difference from the
plain version :func:`..ops.cuda.row_shift.shift_rows_reference`.  The
kernel reads only each row's window of ``out + stride`` taps, so the
record also states the rate over the bytes it must move (that window, the
output, the starts and fractions: ``window_*``).

Usage: python -m dsnt_pose2d_tpu_torch.tools.bench_row_shift [--iters 50] [--device cpu]

The last line is one JSON object: ``{"cases": [...], "copy_ceiling_GBps": x}``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..cli.common import add_device_arg
from ..device import resolve_device

# (rows, row_len, out_len, stride): the two flagship shear passes.
CASES = [(6144, 3864, 2502, 3), (4096, 1674, 768, 3)]
CALIB_ROWS = 8192    # the calibration's (8192, 4096) fp32 copy


def case_inputs(r: int, length: int, out: int, stride: int, device):
    """The JAX tool's inputs (``default_rng(0)``) on ``device``."""
    rng = np.random.default_rng(0)
    rows = rng.uniform(size=(r, length)).astype(np.float32)
    starts = rng.integers(0, (length - out - stride) // stride,
                          size=(r,)).astype(np.int32) * stride
    fracs = rng.uniform(size=(r,)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (rows, starts, fracs))


def run(iters: int = 50, device="cuda", cases=CASES, calib_rows=CALIB_ROWS,
        log=print) -> dict:
    """Every case's record, and the copy ceiling they are stated against."""
    from ..bench.kernel import calibrate
    from ..bench.timing import device_ms, host_ms
    from ..ops.cuda.row_shift import shift_rows, shift_rows_reference

    dev = resolve_device(device)
    timer = device_ms if dev.type == "cuda" else host_ms
    ceiling = calibrate(calib_rows, dev, iters)["copy"]["gbps_read_write"]
    records = []
    for r, length, out, stride in cases:
        rows, starts, fracs = case_inputs(r, length, out, stride, dev)
        nbytes = (r * length + r * out) * 4
        window = (r * (out + stride) + r * out + 2 * r) * 4
        rec = {"rows": r, "l": length, "out": out, "stride": stride,
               "bytes": nbytes, "window_bytes": window}
        for impl in ("legacy", "vec"):
            ms, how = timer(lambda impl=impl: shift_rows(
                rows, starts, fracs, out, stride=stride, impl=impl), iters)
            gbps = nbytes / ms / 1e6
            window_gbps = window / ms / 1e6
            rec[impl] = {"ms": ms, "gbps": gbps,
                         "frac_of_ceiling": gbps / ceiling,
                         "window_gbps": window_gbps,
                         "window_frac_of_ceiling": window_gbps / ceiling,
                         "timing": how}
            log(f"({r},{length})->{out} s{stride}  {impl:6s} {ms:7.3f} ms  "
                f"{gbps:6.1f} GB/s-effective  {gbps / ceiling:.2f} of the "
                f"copy ceiling ({window_gbps / ceiling:.2f} over the taps' "
                "window)")
        vec = shift_rows(rows, starts, fracs, out, stride=stride, impl="vec")
        legacy = shift_rows(rows, starts, fracs, out, stride=stride, impl="legacy")
        plain = shift_rows_reference(rows, starts, fracs, out, stride=stride)
        rec["speedup"] = rec["legacy"]["ms"] / rec["vec"]["ms"]
        rec["max_abs_vec_minus_legacy"] = float((vec - legacy).abs().max())
        rec["max_abs_vec_minus_plain"] = float((vec - plain).abs().max())
        log(f"  speedup {rec['speedup']:.2f}x  max|vec-legacy| = "
            f"{rec['max_abs_vec_minus_legacy']:.2e}  max|vec-plain| = "
            f"{rec['max_abs_vec_minus_plain']:.2e}  (both impls launch the one "
            "Hopper kernel: ~1.00x expected)")
        records.append(rec)
    return {"cases": records, "copy_ceiling_GBps": ceiling}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=50)
    add_device_arg(p)
    args = p.parse_args(argv)
    print(json.dumps(run(args.iters, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
