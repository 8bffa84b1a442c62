"""Kernel roofline bench of the port (port of ``bench_kernel.py``).

Times the calibration kernels (copy, exp, row softmax over ``(rows, 4096)``
fp32: the memory rate this card reaches for the layout), ``row_shift`` at
the hg8 train step's first warp pass, and the fused DSNT head at hg8-shaped
inputs (rows = stacks x batch x joints of 64x64 fp32 heatmaps): its forward,
its forward + backward through the ``torch.autograd.Function``, the
``(rows, 64, 64)`` API call, and the plain PyTorch versions of both.  The
head's rates are stated against the measured copy rate (the ceiling) and
against the card's data-sheet memory rate.

Traffic model (the least bytes, the roofline's numerator):
  forward       : one read of the heatmaps          = rows * 4096 * 4 bytes
  fwd+bwd       : fwd read + bwd read + dh write    = 3 * rows * 4096 * 4
(coords, targets and reg are rows * O(8) bytes, negligible.)

On the card every time is device time per call from
:func:`..timing.device_ms` (CUDA events behind a spin, host time left
out); with ``--device cpu`` the host's clock times the plain versions.
PyTorch runs eagerly, so nothing needs the JAX file's accumulator chains
against hoisting and dead-code elimination.

    python -m dsnt_pose2d_tpu_torch.bench.kernel            # on the card
    BENCH_ROWS=512 python -m dsnt_pose2d_tpu_torch.bench.kernel --device cpu

Env knobs: ``BENCH_ROWS`` (default 8 * 64 * 16 = 8192: hg8 at batch 64),
``BENCH_KERNEL_ITERS`` (calls per timed window, default 16), ``BENCH_REGS``
(default ``js,none``), ``BENCH_HBM_PEAK_GBPS`` (the card's memory rate, for a
card the table below does not know).  Prints one JSON line per record.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..ops.cuda import calib, dsnt_head
from ..ops.cuda.dsnt_head import fused_dsnt_head, fused_dsnt_head_reference
from ..ops.cuda.row_shift import shift_rows
from .timing import device_ms, host_ms

H = W = 64
COLS = H * W
# Memory rate of the card, GB/s, by a substring of its name (NVIDIA's data
# sheets: H100 SXM5 HBM3, H200 SXM HBM3e).
PEAK_GBPS = {"H100 80GB HBM3": 3350.0, "H200": 4800.0}
CALIB_FNS = {"copy": calib.calib_copy, "exp": calib.calib_exp,
             "smax": calib.calib_smax}


def peak_gbps(device) -> float | None:
    """The card's data-sheet memory rate; None on the CPU.  Raises for a
    card the table does not know unless ``BENCH_HBM_PEAK_GBPS`` is set."""
    env = os.environ.get("BENCH_HBM_PEAK_GBPS")
    if env:
        return float(env)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, gbps in PEAK_GBPS.items():
        if key in name:
            return gbps
    raise ValueError(f"no memory rate known for {name!r}; set "
                     f"BENCH_HBM_PEAK_GBPS")


def card_line(device) -> str | None:
    """``nvidia-smi``'s name and power limit of the card, or None on the CPU."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _timer(device, calls: int):
    """``fn -> ms per call``: device time on the card, host time on the CPU."""
    timer = device_ms if device.type == "cuda" else host_ms
    return lambda fn: timer(fn, calls)[0]


def _inputs(rows: int, device, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, COLS), generator=g) * 2.0
    t = torch.rand((rows, 2), generator=g) * 1.8 - 0.9
    return x.to(device), t.to(device)


def calibrate(rows: int, device, iters: int) -> dict:
    """The three calibration kernels at ``(rows, 4096)`` fp32: ms per call
    and the rate of one read and one write of ``x``."""
    timed = _timer(device, iters)
    x = torch.randn((rows, COLS), generator=torch.Generator().manual_seed(0))
    x = x.to(device)
    s = torch.zeros((1,), device=device)
    nbytes = 2 * rows * COLS * 4
    out = {}
    for name, fn in CALIB_FNS.items():
        ms = timed(lambda: fn(x, s))
        out[name] = {"ms": ms, "gbps_read_write": nbytes / ms / 1e6}
    return out


def bench_fused(rows: int, reg: str, device, iters: int) -> tuple:
    """``(fwd_ms, fwdbwd_ms, api_fwd_ms)`` of the fused head.

    ``fwd`` and ``fwdbwd`` run the ``autograd.Function`` on ``(rows, 4096)``
    rows (the kernels proper); ``api_fwd`` is :func:`fused_dsnt_head` on
    ``(rows, 64, 64)`` (its reshape is a view: no copy)."""
    timed = _timer(device, iters)
    x2, t = _inputs(rows, device)
    x3 = x2.view(rows, H, W)
    args = (H, W, 1.0, reg, "softmax", 0.0)
    fused = dsnt_head._FusedDsntHead.apply

    def fwdbwd():
        x = x2.detach().requires_grad_(True)
        c, r = fused(x, t, *args)
        loss = c.sum() * 1e-6 + (0.0 if reg == "none" else r.sum() * 1e-6)
        return torch.autograd.grad(loss, x)[0]

    return (timed(lambda: fused(x2, t, *args)), timed(fwdbwd),
            timed(lambda: fused_dsnt_head(x3, t, sigma_px=1.0, reg=reg)))


def bench_oracle(rows: int, reg: str, device, iters: int) -> tuple:
    """``(fwd_ms, fwdbwd_ms)`` of the plain PyTorch head (the unfused ops)."""
    timed = _timer(device, iters)
    x2, t = _inputs(rows, device)
    x3 = x2.view(rows, H, W)

    def fwdbwd():
        x = x3.detach().requires_grad_(True)
        c, r = fused_dsnt_head_reference(x, t, sigma_px=1.0, reg=reg)
        loss = c.sum() * 1e-6 + (0.0 if r is None else r.sum() * 1e-6)
        return torch.autograd.grad(loss, x)[0]

    fwd = timed(lambda: fused_dsnt_head_reference(x3, t, sigma_px=1.0, reg=reg))
    return fwd, timed(fwdbwd)


def bench_row_shift(device, iters: int) -> dict:
    """``row_shift`` at the hg8 pass-1 shape (18432, 1354) -> 836."""
    timed = _timer(device, iters)
    r, length, out = 18432, 1354, 836
    g = torch.Generator().manual_seed(0)
    rows = torch.rand((r, length), generator=g).to(device)
    starts = torch.randint(0, length - out - 1, (r,), generator=g,
                           dtype=torch.int32).to(device)
    fracs = torch.rand((r,), generator=g).to(device)
    ms = timed(lambda: shift_rows(rows, starts, fracs, out))
    nbytes = (r * length + r * out) * 4
    return {"kernel": "row_shift", "rows": r, "l": length, "out": out,
            "ms": ms, "gbps_read_write": nbytes / ms / 1e6}


def _frac(gbps: float, of: float | None):
    return None if of is None else gbps / of


def run(device=DEFAULT_DEVICE, rows: int = 8 * 64 * 16, iters: int = 16,
        regs=("js", "none"), emit=None) -> list[dict]:
    """Every record of the bench, each passed to ``emit`` as it lands: the
    calibration, row_shift, then one record per regularizer."""
    device = resolve_device(device)
    emit = emit or (lambda rec: None)
    name = "cpu" if device.type == "cpu" else torch.cuda.get_device_name(device)
    peak = peak_gbps(device)
    card = card_line(device)
    bytes_fwd = rows * COLS * 4
    bytes_fb = 3 * bytes_fwd

    cal = calibrate(rows, device, iters)
    records = [{"calibration": cal, "rows": rows, "device": name, "card": card,
                "peak_hbm_gbps": peak}]
    emit(records[-1])
    records.append({**bench_row_shift(device, iters), "device": name})
    emit(records[-1])
    # The measured ceiling: what this card sustains for one read and one
    # write of the layout (the copy kernel), not the data-sheet rate.
    ceiling = cal["copy"]["gbps_read_write"]
    for reg in regs:
        fwd, fb, api = bench_fused(rows, reg, device, iters)
        o_fwd, o_fb = bench_oracle(rows, reg, device, iters)
        fwd_gbps, fb_gbps = bytes_fwd / fwd / 1e6, bytes_fb / fb / 1e6
        rec = {
            "kernel": "fused_dsnt_head", "reg": reg, "rows": rows, "hw": [H, W],
            "device": name, "card": card, "peak_hbm_gbps": peak,
            "measured_copy_gbps": ceiling,
            "fwd_ms": fwd, "fwd_gbps": fwd_gbps,
            "fwd_frac_of_peak": _frac(fwd_gbps, peak),
            "fwd_frac_of_ceiling": fwd_gbps / ceiling,
            "fwdbwd_ms": fb, "fwdbwd_gbps": fb_gbps,
            "fwdbwd_frac_of_peak": _frac(fb_gbps, peak),
            "fwdbwd_frac_of_ceiling": fb_gbps / ceiling,
            "api_reshape_overhead_ms": api - fwd,
            "oracle_fwd_ms": o_fwd, "oracle_fwdbwd_ms": o_fb,
            "fusion_speedup_fwd": o_fwd / fwd,
            "fusion_speedup_fwdbwd": o_fb / fb,
        }
        rec["meets_70pct_target"] = (rec["fwd_frac_of_ceiling"] >= 0.7
                                     and rec["fwdbwd_frac_of_ceiling"] >= 0.7)
        records.append(rec)
        emit(rec)
    return records


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (default) or cpu (the plain versions, host clock)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    return run(device,
               rows=int(os.environ.get("BENCH_ROWS", str(8 * 64 * 16))),
               iters=int(os.environ.get("BENCH_KERNEL_ITERS", "16")),
               regs=os.environ.get("BENCH_REGS", "js,none").split(","),
               emit=lambda rec: print(json.dumps(rec), flush=True))


if __name__ == "__main__":
    main()
