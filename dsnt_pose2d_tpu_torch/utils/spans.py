"""The port's spans: the host's time by layer inside the train and serve
steps, on the clock of a ``torch.profiler`` trace.

:func:`span` marks one layer of a step.  ``train/loop.py``'s train steps
open ``train.feed`` (the resident gather, the copy to the device and the
augmentation draws), ``train.preprocess``, ``train.backbone`` (the model's
forward), ``train.head`` (the head's forward and the loss),
``train.backward`` and ``train.optimizer`` (``zero_grad`` and the chain's
norm, clip and update); its serving step ``serve.feed``,
``serve.preprocess``, ``serve.backbone`` and ``serve.head`` (the decode and
the map to original-image pixels; the eval step opens the serving spans
too); every ``models/hourglass.py::BatchNorm`` call opens ``bn`` inside
them.  A span is on exactly while a ``torch.profiler`` records: off, it is
one read of torch's flag and a shared no-op context; on, it enters
``record_function(name)``, so that it lands in the profiler's trace on the
clock of the device's kernels and copies (``bn`` excepted, see
:data:`LOG_ONLY`), and logs a :class:`Span` (name, parent span, unit, start
and end on ``time.perf_counter_ns``).

:func:`unit` opens one optimizer step (``"train"``) or one request
(``"serve"``); the spans opened inside it, on any thread, are its own, and
a unit opened inside another joins it.  A span opened outside any unit and
outside any other span, such as the resident gather of a ``k``-step call,
is logged on its own, before the units it feeds.  The log keeps the last
:data:`MAX_ENTRIES` units and such spans: :func:`log` reads them, oldest
first, and :func:`clear` empties it.

This module imports torch alone, so that the models and the train loop
can both open spans.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

# Entries the log keeps: a traced segment of the benchmark logs 4 to 16
# units and a span a dispatch, an hg8 step some 360 spans.
MAX_ENTRIES = 512
# Spans that go to the log alone, without a range in the profiler's
# trace: a ``record_function`` costs ~10 us on an H100 machine's host, and
# the 354 BN calls of an hg8 forward would add 7.7% to a served request.
LOG_ONLY = frozenset({"bn"})
_OFF = nullcontext()


@dataclass(slots=True)
class Span:
    name: str
    parent: str | None      # the innermost span open when this one opened
    unit: int | None        # the id of its unit; None outside any
    start_ns: int
    end_ns: int = 0

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


@dataclass
class Unit:
    """One optimizer step (``kind`` ``"train"``) or request (``"serve"``)."""

    id: int
    kind: str
    spans: list = field(default_factory=list)


class _Log:
    def __init__(self):
        self.entries = deque(maxlen=MAX_ENTRIES)
        self.ids = itertools.count()
        self.open = []          # names of the open spans, innermost last
        self.unit = None


_LOG = _Log()


class _Span:
    __slots__ = ("name", "unit", "record", "span")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log = _LOG
        self.unit = log.unit
        self.record = None
        if self.name not in LOG_ONLY:
            self.record = record_function(self.name)
            self.record.__enter__()
        self.span = Span(self.name, log.open[-1] if log.open else None,
                         None if self.unit is None else self.unit.id,
                         time.perf_counter_ns())
        log.open.append(self.name)
        return self.span

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        log = _LOG
        log.open.pop()
        if self.record is not None:
            self.record.__exit__(*exc)
        self.span.end_ns = end
        if self.unit is not None:
            self.unit.spans.append(self.span)
        elif self.span.parent is None:
            log.entries.append(self.span)


class _Unit:
    def __init__(self, kind: str):
        self.kind = kind
        self.unit = None

    def __enter__(self):
        log = _LOG
        if log.unit is None:
            self.unit = log.unit = Unit(next(log.ids), self.kind)
        return log.unit

    def __exit__(self, *exc):
        if self.unit is not None:
            _LOG.unit = None
            _LOG.entries.append(self.unit)


def span(name: str):
    """A context that marks the layer ``name`` while a profiler records
    (the shared no-op context otherwise)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def unit(kind: str):
    """A context around one unit of ``kind`` (``"train"``: an optimizer
    step; ``"serve"``: a request), logged when it ends, while a profiler
    records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Unit(kind)


def log() -> list:
    """The logged :class:`Unit` s and the :class:`Span` s opened outside
    any, oldest first."""
    return list(_LOG.entries)


def clear():
    _LOG.entries.clear()
