"""Profiling hook for the Trainer (port of
``dsnt_pose2d_tpu/train/profiling.py``).

:func:`make_profile_hook` captures a ``torch.profiler`` trace of one whole
epoch (the second by default, so that the first epoch's kernel builds and
cuDNN's algorithm searches stay out of it) into a directory, as a Chrome
trace (``epoch<N>.pt.trace.json``) that Perfetto or ``chrome://tracing``
opens.  It records host and, on the card, device activities.

The trace is a breakdown, never a timing: the profiler slows the host's
dispatch, and it has been seen to drop device activities in a process
that profiled a large step before.  Step and kernel times come from CUDA
events (``bench/timing.py``).
"""

from __future__ import annotations

import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function


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


def annotate(name: str):
    """Named range on the trace's timeline: ``with annotate("stack3"): ...``"""
    return record_function(name)
