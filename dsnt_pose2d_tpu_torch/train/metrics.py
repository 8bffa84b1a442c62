"""Meters and the JSONL metric writer (port of ``dsnt_pose2d_tpu/train/metrics.py``).

Every event is one JSON line in ``<out_dir>/metrics.jsonl``, echoed to the
console.  With ``tensorboard=True`` the scalars are mirrored to TensorBoard
event files under ``<out_dir>/tb`` through ``torch.utils.tensorboard``
(the JAX package uses flax's writer), tagged as the JAX package tags them.
"""

from __future__ import annotations

import json
import os
import sys
import time


class MeanMeter:
    """Running mean."""

    def __init__(self):
        self.sum = 0.0
        self.n = 0

    def add(self, value, n: int = 1):
        self.sum += float(value) * n
        self.n += n

    @property
    def value(self) -> float:
        return self.sum / max(self.n, 1)

    def reset(self):
        self.sum, self.n = 0.0, 0


class TimeMeter:
    """Seconds since construction or the last :meth:`reset`."""

    def __init__(self):
        self.start = time.time()

    def elapsed(self) -> float:
        return time.time() - self.start

    def reset(self):
        self.start = time.time()


class MetricWriter:
    """Append-only JSONL event writer + optional console echo + TensorBoard.

    Step-level events (those with a ``step`` key) are tagged
    ``train/<name>`` and indexed by the global step; epoch summaries are
    indexed by epoch, their ``val_*`` metrics tagged ``val/`` and the rest
    ``epoch/``.  Booleans and other non-numeric values are JSONL-only.
    """

    def __init__(self, out_dir: str | None, echo: bool = True,
                 filename: str = "metrics.jsonl", tensorboard: bool = False):
        self.path = None
        self.echo = echo
        self._fh = None
        self._tb = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self.path = os.path.join(out_dir, filename)
            self._fh = open(self.path, "a")
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter

                    self._tb = SummaryWriter(os.path.join(out_dir, "tb"))
                except ImportError as e:
                    print(f"[metrics] tensorboard unavailable: {e}",
                          file=sys.stderr)

    def write(self, event: dict):
        event = {"time": time.time(), **event}
        if self._fh:
            self._fh.write(json.dumps(event) + "\n")
            self._fh.flush()
        if self._tb is not None:
            step_level = "step" in event
            idx = int(event.get("step", event.get("epoch", 0)))
            for k, v in event.items():
                if k in ("time", "step", "epoch"):
                    continue
                # bool is an int subclass: flag fields stay JSONL-only.
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                if step_level:
                    tag = f"train/{k}"
                elif k.startswith("val_"):
                    tag = f"val/{k[4:]}"
                else:
                    tag = f"epoch/{k}"
                self._tb.add_scalar(tag, float(v), idx)
            self._tb.flush()
        if self.echo:
            keys = [f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in event.items() if k != "time"]
            print("[metrics] " + " ".join(keys), file=sys.stderr)

    def close(self):
        if self._fh:
            self._fh.close()
        if self._tb is not None:
            self._tb.close()
