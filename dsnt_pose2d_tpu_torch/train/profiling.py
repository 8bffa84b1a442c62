"""Profiling hooks for the Trainer and the tools (port of
``dsnt_pose2d_tpu/train/profiling.py``).

:func:`trace_calls` traces a number of calls of a function (a train step:
``python -m dsnt_pose2d_tpu_torch.tools.profile_step``).
:func:`make_profile_hook` captures a ``torch.profiler`` trace of one whole
epoch (the second by default, so that the first epoch's kernel builds and
cuDNN's algorithm searches stay out of it) into a directory, as a Chrome
trace (``epoch<N>.pt.trace.json``) that Perfetto or ``chrome://tracing``
opens.  Both record host and, on the card, device activities.  While they
record, the steps' spans by layer (:mod:`..utils.spans`: ``train.feed`` ...
``train.optimizer``, ``serve.feed`` ... ``serve.head``) are on, so the
trace carries them on the timeline of the kernels they launched.

The trace is a breakdown, never a timing: the profiler slows the host's
dispatch, and it has been seen to drop device activities in a process
that profiled a large step before.  Step and kernel times come from CUDA
events (``bench/timing.py``).
"""

from __future__ import annotations

import os

import torch
from torch.profiler import ProfilerActivity, profile


def make_profile_hook(out_dir: str, epoch_to_trace: int = 1):
    """Trainer hook ``hook(epoch, state, summary)``, called at each epoch's
    end: it starts the profiler at the end of epoch ``epoch_to_trace - 1``
    and stops it at the end of the next epoch, writing the trace; a run
    that ends in between writes none.  ``hook.close()`` stops a profiler
    still running without writing."""
    state = {"prof": None, "done": False}

    def hook(epoch: int, _train_state, _summary):
        if state["prof"] is not None:
            prof, state["prof"] = state["prof"], None
            prof.stop()
            state["done"] = True
            os.makedirs(out_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(out_dir, f"epoch{epoch}.pt.trace.json"))
        elif epoch + 1 == epoch_to_trace and not state["done"]:
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            state["prof"] = profile(activities=activities)
            state["prof"].start()

    def close():
        if state["prof"] is not None:
            state["prof"].stop()
            state["prof"] = None

    hook.close = close
    return hook


def trace_calls(fn, calls: int, path: str) -> str:
    """A Chrome trace of ``calls`` calls of ``fn`` (host and, on the card,
    device activities; synchronised at the end) written to ``path``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(calls):
            fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)
    return path
