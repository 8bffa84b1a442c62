"""The port's meters and JSONL metric writer against the JAX package's.

The same events go through both packages' ``MetricWriter``: the JSONL
records are equal key for key and in key order, apart from ``time``, and so
are the console echo lines.  Exact equality: both write the same Python
values with ``json.dumps``.  With ``tensorboard=True`` both mirror the same
tags, steps and values (the port through ``torch.utils.tensorboard``).
"""

import json
import time

import numpy as np
import pytest

from dsnt_pose2d_tpu.train import metrics as jmetrics
from dsnt_pose2d_tpu_torch.train import metrics as tmetrics

EVENTS = [
    {"epoch": 0, "step": 1, "loss": 0.8731, "grad_norm": 2.92},
    {"epoch": 0, "step": 2, "loss": np.float32(0.5).item()},
    {"epoch": 0, "train_loss": 0.87, "epoch_seconds": 1.25,
     "images_per_sec": 25.6, "val_loss": 0.83, "val_pckh": 0.0487,
     "eval_seconds": 0.04, "ckpt_seconds": 0.02},
    {"epoch": 1, "is_best": True, "note": "text", "count": 3},
    {"epoch": 1, "val_pckh": float("nan")},
]


def _records(module, out_dir, capsys):
    writer = module.MetricWriter(str(out_dir), echo=True)
    for e in EVENTS:
        writer.write(dict(e))
    writer.close()
    echo = capsys.readouterr().err.splitlines()
    with open(out_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f], echo


def test_metric_writer_records_match_jax(tmp_path, capsys):
    t0 = time.time()
    got, got_echo = _records(tmetrics, tmp_path / "t", capsys)
    exp, exp_echo = _records(jmetrics, tmp_path / "j", capsys)
    assert len(got) == len(exp) == len(EVENTS)
    for g, e in zip(got, exp):
        assert g.pop("time") >= t0 and e.pop("time") >= t0
        assert list(g) == list(e)
        assert json.dumps(g) == json.dumps(e)
    assert got_echo == exp_echo and len(got_echo) == len(EVENTS)
    assert got_echo[0] == "[metrics] epoch=0 step=1 loss=0.8731 grad_norm=2.92"


def test_metric_writer_without_dir_only_echoes(capsys):
    writer = tmetrics.MetricWriter(None, echo=True)
    assert writer.path is None
    writer.write({"epoch": 0, "loss": 1.0})
    writer.close()
    assert capsys.readouterr().err.strip() == "[metrics] epoch=0 loss=1"


def test_metric_writer_appends(tmp_path):
    for _ in range(2):
        w = tmetrics.MetricWriter(str(tmp_path), echo=False)
        w.write({"epoch": 0})
        w.close()
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 2


@pytest.mark.parametrize("module", [tmetrics, jmetrics], ids=["torch", "jax"])
def test_mean_meter(module):
    m = module.MeanMeter()
    m.add(1.0)
    m.add(3.0)
    m.add(np.float32(2.0), n=2)
    assert m.value == 2.0 and m.n == 4
    m.reset()
    assert m.n == 0 and m.value == 0.0


def test_time_meter(monkeypatch):
    clock = iter([10.0, 12.5, 20.0, 21.0])
    monkeypatch.setattr(tmetrics.time, "time", lambda: next(clock))
    t = tmetrics.TimeMeter()
    assert t.elapsed() == 2.5
    t.reset()
    assert t.elapsed() == 1.0


def test_tensorboard_mirror_matches_jax(tmp_path):
    # The port writes scalar summaries (torch.utils.tensorboard), the JAX
    # package tensor summaries (flax): the same tags, steps and values.
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    from tensorboard.util import tensor_util

    got = {}
    for name, module in (("torch", tmetrics), ("jax", jmetrics)):
        writer = module.MetricWriter(str(tmp_path / name), echo=False,
                                     tensorboard=True)
        for e in EVENTS[:4]:
            writer.write(dict(e))
        writer.close()
        acc = EventAccumulator(str(tmp_path / name / "tb"))
        acc.Reload()
        if name == "torch":
            got[name] = {t: [(e.step, e.value) for e in acc.Scalars(t)]
                         for t in acc.Tags()["scalars"]}
        else:
            got[name] = {t: [(e.step, float(tensor_util.make_ndarray(e.tensor_proto)))
                             for e in acc.Tensors(t)]
                         for t in acc.Tags()["tensors"]}
    assert got["torch"] == got["jax"]
    assert got["torch"]["train/loss"] == [(1, np.float32(0.8731)), (2, 0.5)]
    assert set(got["torch"]) == {
        "train/loss", "train/grad_norm", "epoch/train_loss",
        "epoch/epoch_seconds", "epoch/images_per_sec", "val/loss", "val/pckh",
        "epoch/eval_seconds", "epoch/ckpt_seconds", "epoch/count"}
