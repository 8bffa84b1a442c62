"""Kernel and step timing on the card with CUDA events, and on the host.

:func:`device_ms` is the figure the benches and ``chip_smoke.py`` report for
a kernel: device time per call with the host's time left out, from CUDA
events around calls queued behind a ``torch.cuda._sleep`` spin.  No
profiler: ``torch.profiler`` (torch 2.11, NVIDIA H100 80GB HBM3) has lost
device activities once a large step had been profiled in the process.
:func:`time_ms` times windows of calls with CUDA events and no spin, and
:func:`host_ms` with the host's clock, for tensors on the CPU;
:func:`window_s` one window of calls, by CUDA events on a card and the
host's clock on the CPU (the two-point marginals of the benches).
"""

from __future__ import annotations

import functools
import statistics
import time

import torch

REPS = 25            # timed windows per measurement (median reported)
WARMUP = 3
BACK_TO_BACK = 20    # kernel calls queued in one window: host time hidden
SPIN_RETAKES = 8


def time_ms(fn, spread: bool = False, per_window: int = 1, reps: int = REPS):
    """Median over ``reps`` CUDA-event windows, after a warm-up, of one
    window's time over ``per_window``, the number of ``fn()`` calls queued
    in it.
    With one call per window the time includes the host's work before the
    launch; with many, the card runs them back to back and that work is
    hidden.  With ``spread``, ``(median, min, max)``."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_window):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_window)
    med = statistics.median(times)
    return (med, min(times), max(times)) if spread else med


@functools.cache
def spin_cycles_per_ms() -> float:
    """Clock cycles that ``torch.cuda._sleep`` spins per ms on this card."""
    cycles = 20_000_000
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def device_ms(fn, calls: int = BACK_TO_BACK) -> tuple[float, dict]:
    """Device time per ``fn()`` call with the host's time left out: the
    median over REPS windows, each ``calls`` calls queued behind a spin
    kernel (``torch.cuda._sleep``) that holds the card until the host has
    queued them all, and timed by CUDA events around the calls, so the card
    runs them back to back.  A window counts only if the card was still
    spinning when the host had queued the last call (the start event not
    yet reached).  Otherwise the spin is doubled, the calls per window are
    halved (a full launch queue also stalls the host), and the windows are
    taken again; after SPIN_RETAKES retakes it raises.  Returns the time and
    how it was found."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    spin_ms = 2e3 * (time.perf_counter() - t0) + 1.0
    torch.cuda.synchronize()
    times, retakes = [], 0
    while len(times) < REPS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            times.append(start.elapsed_time(end) / calls)
            continue
        retakes += 1
        if retakes > SPIN_RETAKES:
            raise RuntimeError(f"the host did not queue {calls} calls within a "
                               f"{spin_ms:.1f} ms spin of the card after "
                               f"{SPIN_RETAKES} retakes")
        spin_ms, calls, times = 2 * spin_ms, max(1, calls // 2), []
    return statistics.median(times), {"calls_per_window": calls,
                                      "spin_ms": spin_ms, "retakes": retakes}


def host_ms(fn, calls: int = BACK_TO_BACK, windows: int = 3) -> tuple[float, dict]:
    """Host-clock time per ``fn()`` call for CPU tensors: the median over
    ``windows`` windows of ``calls`` calls, after one warm-up call."""
    fn()
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    return statistics.median(times), {"calls_per_window": calls,
                                      "host_clock": True}


def window_s(fn, n: int, device) -> float:
    """Seconds of one window of ``n`` back-to-back ``fn()`` calls: CUDA
    events around the window on a card (synchronised before and after), the
    host's clock on the CPU."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return time.perf_counter() - t0
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3


def kernel_times(fn, plain_fn, library_fn=None) -> dict:
    """A kernel, its plain version and (if any) the library call, each timed
    three ways: device time per call (``ms``, the figure reported: no host
    time in it, see ``device_ms``; ``<key>_spin`` says how it was found),
    back to back in one CUDA-event window with no spin (host time hidden
    only where the device outruns the host's launches), and one call per
    window (host dispatch included)."""
    out = {}
    for key, f in (("ms", fn), ("plain_ms", plain_fn), ("library_ms", library_fn)):
        if f is None:
            out[key] = None
            continue
        out[key], out[f"{key}_spin"] = device_ms(f)
        out[f"{key}_back_to_back"] = time_ms(f, per_window=BACK_TO_BACK)
        out[f"{key}_one_call"] = time_ms(f)
    return out
