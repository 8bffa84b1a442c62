"""``torch.profiler`` windows over a few steps or requests, reduced to
what the per-layer metrics and the breakdown read.

:func:`profile_device` traces the device alone: ``busy_s`` is the length of
the union of its activities (kernels, copies, fills), ``launches`` the
kernels among them, ``window_s`` the calls and a final synchronise on the
host's clock.  :func:`profile_host` traces host and device inside a named
range: each idle gap between device activities is put down to the
outermost host operation running at its middle (any thread), and the gaps
are summed by that name.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

WINDOW = "posebench.window"
_NOT_KERNELS = ("Memcpy", "Memset")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    launches: int
    kernels: list = field(default_factory=list)     # (name, seconds), in start order
    device_ops: list = field(default_factory=list)  # [(name, seconds)], top 10
    idle_gaps: list = field(default_factory=list)   # [(host op, seconds)], top 10

    def kernel_seconds(self, kernel: str) -> list:
        """Device seconds of each launch of ``kernel`` (a function name of
        the program's CUDA sources), in launch order."""
        pat = re.compile(rf"\b{re.escape(kernel)}_kernel\b")
        return [s for name, s in self.kernels if pat.search(name)]


def _on_device(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def summarize_device(events, window_s: float) -> TraceSummary:
    """A device-only trace over a window of ``window_s`` host seconds."""
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if _on_device(e))
    if not dev:
        return TraceSummary(window_s=window_s, busy_s=0.0, launches=0)
    merged = _merge(dev)
    kernels = [(n, (b - a) * 1e-6) for a, b, n in dev if not n.startswith(_NOT_KERNELS)]
    return TraceSummary(window_s=window_s,
                        busy_s=sum(b - a for a, b in merged) * 1e-6,
                        launches=len(kernels), kernels=kernels, device_ops=_top(_by_name(dev)))


def _merge(intervals) -> list:
    merged = []
    for a, b, _ in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _by_name(intervals) -> dict:
    out = defaultdict(float)
    for a, b, n in intervals:
        out[n[:160]] += (b - a) * 1e-6
    return out


def _top(d: dict) -> list:
    return sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]


def summarize(events) -> TraceSummary:
    win = next((e for e in events if e.name == WINDOW and not _on_device(e)), None)
    if win is None:
        raise RuntimeError("the profile holds no window range")
    w0, w1 = win.time_range.start, win.time_range.end
    dev = sorted(((max(e.time_range.start, w0), min(e.time_range.end, w1), e.name)
                  for e in events if _on_device(e)
                  and e.time_range.end > w0 and e.time_range.start < w1))
    kernels = [(n, (b - a) * 1e-6) for a, b, n in dev if not n.startswith(_NOT_KERNELS)]
    merged = _merge(dev)
    busy = sum(b - a for a, b in merged)
    gaps, t = [], w0
    for a, b in merged:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    outer = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                   if not _on_device(e) and e.name != WINDOW
                   and (e.cpu_parent is None or e.cpu_parent.name == WINDOW))
    starts = [o[0] for o in outer]
    by_host = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        name = "python between operations"
        best = -1.0
        for s, e, n in outer[max(0, i - 64):i]:
            if e >= mid and e - s > best:
                best, name = e - s, n
        by_host[name[:160]] += (b - a) * 1e-6
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                        launches=len(kernels), kernels=kernels,
                        device_ops=_top(_by_name(dev)), idle_gaps=_top(by_host))


def profile_device(fn) -> TraceSummary:
    """Trace ``fn()`` with the device's activities alone: every number but
    the idle gaps' host operations (tracing the host as well would slow a
    host-bound step and widen the gaps).  The window is ``fn()`` and a
    synchronise on the host's clock."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
    return summarize_device(prof.events(), took)


def profile_host(fn) -> TraceSummary:
    """Trace ``fn()`` with the host's and the device's activities, inside
    the window range: the idle gaps by host operation."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    return summarize(prof.events())
