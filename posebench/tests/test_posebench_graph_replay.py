"""``graph_replay_pct``: the share of the traced segment's requests that
replayed a CUDA graph, on a hand-filled span log."""

import sys

import pytest

import dsnt_pose2d_tpu_torch.utils
from dsnt_pose2d_tpu_torch.utils import spans
from dsnt_pose2d_tpu_torch.utils.spans import Span, Unit
from posebench import harness, metrics
from posebench.trace import TraceSummary

NAME = "graph_replay_pct.serve"


def _ctx(units: int) -> harness.Readings:
    return harness.Readings(trace=TraceSummary(window_s=1.0, busy_s=0.5, launches=1),
                            units=units, calls={}, window={}, peaks={},
                            compute_dtype="bf16")


def _request(uid: int, layers) -> Unit:
    u = Unit(id=uid, kind="serve")
    for i, layer in enumerate(layers):
        u.spans.append(Span(f"serve.{layer}", None, uid, i, i + 1))
    return u


EAGER = ("feed", "preprocess", "backbone", "head")
REPLAYED = ("feed", "graph")


@pytest.fixture
def log(monkeypatch):
    def fill(entries):
        monkeypatch.setattr(spans, "log", lambda: list(entries))
    return fill


def test_share_of_the_segments_requests_that_replayed(log):
    # Three segments of 4 requests: the device-only one is the middle, where
    # 3 of 4 replayed (the first segment's requests ran eagerly).
    first = [_request(i, EAGER) for i in range(4)]
    middle = [_request(4, EAGER)] + [_request(i, REPLAYED) for i in range(5, 8)]
    last = [_request(i, REPLAYED) for i in range(8, 12)]
    log(first + middle + last)
    assert metrics.reader(NAME)(_ctx(4)) == pytest.approx(75.0)
    log(middle[1:] + last + last)
    assert metrics.reader(NAME)(_ctx(4)) == pytest.approx(100.0)


def test_none_without_the_span(log):
    # The parent's serving step opens no serve.graph span: the metric is
    # left out, not read as 0.
    log([_request(i, EAGER) for i in range(8)])
    assert metrics.reader(NAME)(_ctx(4)) is None
    log([_request(i, REPLAYED) for i in range(3)])
    assert metrics.reader(NAME)(_ctx(4)) is None        # fewer than 2u units
    assert metrics.reader(NAME)(_ctx(0)) is None


def test_none_for_a_program_without_the_log(monkeypatch):
    monkeypatch.delattr(dsnt_pose2d_tpu_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "dsnt_pose2d_tpu_torch.utils.spans", None)
    assert metrics.reader(NAME)(_ctx(1)) is None
