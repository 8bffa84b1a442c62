"""The serving step's CUDA graphs (``train/loop.py::make_infer_fn``).

On the CPU: the preprocess's constants held on the device give the bits of
a ``torch.tensor`` made anew each call, a CPU serving step leaves the graph
counters alone, and the graph cache's bookkeeping (which call runs eagerly,
captures or replays; what drops the graphs) on a stand-in graph that runs
the body eagerly.  On the card (marker ``cuda``, skipped without one; the
file imports neither JAX nor the JAX package):

    python -m pytest --noconftest -m cuda tests/test_torch_serve_graph.py

a replay against the eager step bit for bit at 1-8 crops, with and
without the mirrored pass and two crop scales, on a tiny hg1 (DSNT, heatmap
and FC heads) and a tiny ResNet-18; answers held across calls; parameters
replaced or updated in place; the ported kernels' launch counts; and the
profiler's record of a replay.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dsnt_pose2d_tpu_torch.data import augment
from dsnt_pose2d_tpu_torch.data import transforms as T
from dsnt_pose2d_tpu_torch.data.synthetic import make_synthetic_mpii
from dsnt_pose2d_tpu_torch.device import device_constant
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
from dsnt_pose2d_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
from dsnt_pose2d_tpu_torch.train import loop
from dsnt_pose2d_tpu_torch.utils import spans
from dsnt_pose2d_tpu_torch.utils.config import Config, DataConfig, ModelConfig

CANVAS = 96


def _batch(n: int, seed: int, device="cpu") -> dict:
    """``n`` synthetic records with uint8 canvases, as the benchmark's."""
    rec = make_synthetic_mpii(n, CANVAS, seed=seed)
    rec["canvases"] = np.round(rec["canvases"] * 255.0).astype(np.uint8)
    return {k: torch.from_numpy(v).to(device) for k, v in rec.items()}


def _fresh_tensor(values, dtype, device):
    return torch.tensor(list(values), dtype=dtype, device=device)


# -- the preprocess's constants ------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
def test_preprocess_constants_match_a_fresh_tensor(train, monkeypatch):
    # mean, std and the flip permutation held on the device against the
    # same preprocess with each made anew (the step's old formulation):
    # every output bitwise, with flips in the train draws.
    b = _batch(6, seed=3)
    cfg = DataConfig()
    gen = torch.Generator().manual_seed(5)
    draws = augment.sample_train_draws(6, cfg, gen) if train else None
    if train:
        draws["flip"] = torch.tensor([True, False, True, True, False, False])

    def run():
        return augment.preprocess_batch(
            b["canvases"], b["coords_px"], b["mask"], b["head_length"],
            b["canvas_from_orig"], cfg, 64, train=train,
            canvas_margin=b["canvas_margin"], draws=draws)

    got = run()
    monkeypatch.setattr(augment, "device_constant", _fresh_tensor)
    monkeypatch.setattr(T, "device_constant", _fresh_tensor)
    exp = run()
    for k in exp:
        assert torch.equal(got[k], exp[k]), k


def test_device_constant_is_made_once():
    with torch.inference_mode():
        a = device_constant((0.5, 0.25), torch.float32, "cpu")
    b = device_constant([0.5, 0.25], torch.float32, torch.device("cpu"))
    assert a is b and not a.is_inference()
    assert torch.equal(a, torch.tensor([0.5, 0.25]))
    assert device_constant((0.5, 0.25), torch.float64, "cpu") is not a
    perm = T.flip_permutation(16)
    assert perm is T.flip_permutation(16)
    assert perm.tolist() == [5, 4, 3, 2, 1, 0, 6, 7, 8, 9, 15, 14, 13, 12, 11, 10]


# -- the graph cache's bookkeeping, on a stand-in graph ----------------------


class _EagerGraph:
    """:class:`loop._ServeGraph`'s interface on the CPU: static inputs, a
    "capture" that runs the body once more and keeps its output tensor,
    and a "replay" that runs it again into that tensor."""

    @torch.inference_mode()
    def __init__(self, batch):
        self.inputs = {k: v.clone() for k, v in batch.items()}

    @staticmethod
    def shared():
        return None, None

    def capture(self, serve, pool, stream):
        self.serve = serve
        self.output = serve(self.inputs)
        return serve(self.inputs)

    @torch.inference_mode()
    def replay(self, batch):
        for k, v in batch.items():
            self.inputs[k].copy_(v)
        self.output.copy_(self.serve(self.inputs))
        return self.output.clone()


def _tiny(base="hg1", device="cpu", **model):
    cfg = Config(model=ModelConfig(base=base, hg_features=16, input_size=64,
                                   dtype="float32", **model))
    return cfg, build_pose_model(cfg.model, device=device, seed=0)


@pytest.fixture
def cpu_graphs(monkeypatch):
    """A tiny hg1's serving body behind the graph cache, on the CPU, with
    the stand-in graph."""
    monkeypatch.setattr(loop, "_ServeGraph", _EagerGraph)
    cfg, model = _tiny()
    eager = loop.make_infer_fn(model, cfg, device="cpu")
    loop.reset_serve_graph_counts()
    yield model, eager, loop._ServeGraphs(lambda b: eager(b), model.net)
    loop.reset_serve_graph_counts()


def _counts(eager, captures, replays):
    return {"eager": eager, "captures": captures, "replays": replays}


def test_a_cpu_step_leaves_the_counters_alone():
    cfg, model = _tiny()
    step = loop.make_infer_fn(model, cfg, device="cpu")
    loop.reset_serve_graph_counts()
    for _ in range(3):
        step(_batch(2, seed=1))
    assert loop.serve_graph_counts() == _counts(0, 0, 0)


def test_one_eager_call_one_capture_then_replays(cpu_graphs):
    _, eager, graphs = cpu_graphs
    k = 5
    for i in range(k):
        b = _batch(3, seed=i)
        assert torch.equal(graphs(b), eager(b))
    assert loop.serve_graph_counts() == _counts(1, 1, k - 2)
    # Another shape has its own graph.
    for i in range(3):
        graphs(_batch(2, seed=i))
    assert loop.serve_graph_counts() == _counts(2, 2, k - 1)


def test_held_answers_stay_apart(cpu_graphs):
    _, eager, graphs = cpu_graphs
    graphs(_batch(2, seed=0))
    graphs(_batch(2, seed=0))
    held = [graphs(_batch(2, seed=s)) for s in (1, 2, 3)]
    assert loop.serve_graph_counts()["replays"] == 3
    for s, answer in zip((1, 2, 3), held):
        assert torch.equal(answer, eager(_batch(2, seed=s)))


def test_a_replaced_tensor_drops_the_graphs(cpu_graphs):
    model, eager, graphs = cpu_graphs
    b = _batch(2, seed=0)
    for _ in range(3):
        graphs(b)
    conv = model.net.backbone.stem_conv
    # In place: the graph replays.
    with torch.no_grad():
        conv.weight.mul_(0.5)
    assert torch.equal(graphs(b), eager(b))
    assert loop.serve_graph_counts() == _counts(1, 1, 2)
    # A new Parameter in the module: eager, then captured anew.
    conv.weight = torch.nn.Parameter(conv.weight.detach() * 2.0)
    for _ in range(3):
        assert torch.equal(graphs(b), eager(b))
    assert loop.serve_graph_counts() == _counts(2, 2, 3)
    # A parameter's storage swapped (p.data = ...): the same.
    conv.weight.data = conv.weight.detach() + 1.0
    graphs(b)
    assert loop.serve_graph_counts() == _counts(3, 2, 3)


def test_a_sharded_model_runs_eagerly(cpu_graphs):
    model, _, graphs = cpu_graphs
    p = model.net.backbone.stem_conv.weight
    p.tp = object()          # what parallel.tp.shard_model_ tags a shard with
    try:
        for _ in range(3):
            graphs(_batch(2, seed=0))
    finally:
        del p.tp
    assert loop.serve_graph_counts() == _counts(3, 0, 0)


def test_no_capture_while_a_profiler_records(cpu_graphs):
    # A shape first and second seen while a profiler records runs eagerly
    # and is captured at the next call without one; a replay's request is
    # a serve unit with the serve.graph span.
    _, _, graphs = cpu_graphs
    b = _batch(2, seed=0)
    spans.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            with spans.unit("serve"):
                graphs(b)
    assert loop.serve_graph_counts() == _counts(2, 0, 0)
    graphs(b)
    assert loop.serve_graph_counts() == _counts(2, 1, 0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.unit("serve"):
            graphs(b)
    assert loop.serve_graph_counts() == _counts(2, 1, 1)
    units = [e for e in spans.log() if isinstance(e, spans.Unit)]
    assert [[s.name for s in u.spans if s.name == "serve.graph"]
            for u in units] == [[], [], ["serve.graph"]]
    spans.clear()


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs and the kernels have no CPU mode)")
    return torch.device("cuda")


MODELS = {
    "hg1": dict(base="hg1", dtype="bfloat16"),
    "hg1-gauss": dict(base="hg1", dtype="bfloat16", output_strat="gauss"),
    "hg1-fc": dict(base="hg1", dtype="bfloat16", output_strat="fc"),
    "resnet18": dict(base="resnet18", dtype="bfloat16"),
}
EVALS = {"one-pass": dict(), "flip-2-scales": dict(flip_eval=True, eval_scales=(0.9, 1.1))}


def _card_model(cuda, name, evals="one-pass"):
    spec = dict(MODELS[name])
    base, dtype = spec.pop("base"), spec.pop("dtype")
    cfg = Config(model=ModelConfig(base=base, hg_features=32, input_size=64,
                                   dtype=dtype, **spec))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **EVALS[evals]))
    return cfg, build_pose_model(cfg.model, device=cuda, seed=0)


@pytest.mark.cuda
@pytest.mark.parametrize("evals", list(EVALS))
@pytest.mark.parametrize("name", list(MODELS))
def test_replay_matches_the_eager_step(cuda, name, evals):
    # Per crop count 1-8: an eager call, the capture, then replays of two
    # batches against a second step's eager calls on them, bit for bit.
    cfg, model = _card_model(cuda, name, evals)
    step = loop.make_infer_fn(model, cfg, device=cuda)
    ref = loop.make_infer_fn(model, cfg, device=cuda)
    loop.reset_serve_graph_counts()
    for n in range(1, 9):
        a, b = _batch(n, seed=n), _batch(n, seed=100 + n)
        first = step(a)
        assert torch.equal(step(a), first)          # the capture's answer
        got_b, got_a = step(b), step(a)              # replays
        assert torch.equal(got_a, first)
        assert torch.equal(got_b, ref(b))
    assert loop.serve_graph_counts() == _counts(8 + 8, 8, 16)


@pytest.mark.cuda
def test_held_answers_stay_apart_on_the_card(cuda):
    # Three answers held across replays of one graph (a caller keeps
    # several queued before it reads them): each is still its own.
    cfg, model = _card_model(cuda, "hg1")
    step = loop.make_infer_fn(model, cfg, device=cuda)
    ref = loop.make_infer_fn(model, cfg, device=cuda)
    step(_batch(4, seed=0))
    step(_batch(4, seed=0))
    held = [step(_batch(4, seed=s)) for s in (1, 2, 3)]
    ptrs = {h.data_ptr() for h in held}
    torch.cuda.synchronize()
    assert len(ptrs) == 3
    for s, answer in zip((1, 2, 3), held):
        assert torch.equal(answer, ref(_batch(4, seed=s)))


@pytest.mark.cuda
def test_replaced_and_updated_parameters(cuda):
    cfg, model = _card_model(cuda, "hg1")
    step = loop.make_infer_fn(model, cfg, device=cuda)
    b = _batch(3, seed=0)
    for _ in range(3):
        step(b)
    loop.reset_serve_graph_counts()
    conv = model.net.backbone.stem_conv
    # In place (an optimizer step, load_state_dict): the graph replays.
    with torch.no_grad():
        conv.weight.copy_(conv.weight * 0.5)
    updated = step(b)
    assert loop.serve_graph_counts() == _counts(0, 0, 1)
    assert torch.equal(updated, loop.make_infer_fn(model, cfg, device=cuda)(b))
    # A new Parameter: eager, captured anew, replayed.
    conv.weight = torch.nn.Parameter(conv.weight.detach() * 2.0)
    loop.reset_serve_graph_counts()
    answers = [step(b) for _ in range(3)]
    assert loop.serve_graph_counts() == _counts(1, 1, 1)
    exp = loop.make_infer_fn(model, cfg, device=cuda)(b)
    for a in answers:
        assert torch.equal(a, exp)
    assert not torch.equal(answers[0], updated)


@pytest.mark.cuda
@pytest.mark.parametrize("evals", list(EVALS))
def test_replays_count_the_kernels_they_launch(cuda, evals):
    # k calls of one shape: 1 eager, 1 capture, k - 2 replays, and each
    # launches what one eager call launches (the head forward and
    # row_shift twice a pass).
    cfg, model = _card_model(cuda, "hg1", evals)
    step = loop.make_infer_fn(model, cfg, device=cuda)
    b = _batch(2, seed=0)
    loop.reset_serve_graph_counts()
    reset_launch_counts()
    step(b)
    once = launch_counts()
    passes = len(cfg.train.eval_scales) * (2 if cfg.train.flip_eval else 1)
    assert (once["dsnt_head_fwd"], once["row_shift"]) == (passes, 2 * len(cfg.train.eval_scales))
    k = 6
    for _ in range(k - 1):
        step(b)
    assert launch_counts() == {n: k * c for n, c in once.items()}
    assert loop.serve_graph_counts() == _counts(1, 1, k - 2)


def _profile_a_replay() -> dict:
    """The kernel names of a device-only profile (as the benchmark traces)
    of an eager call and of a replay of one shape, with the counters;
    every kernel loaded before either profile."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device("cuda")
    cfg, model = _card_model(cuda, "hg1")
    step = loop.make_infer_fn(model, cfg, device=cuda)
    step(_batch(3, seed=1))
    b = _batch(2, seed=0)

    def kernels(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith(("Memcpy", "Memset"))]

    loop.reset_serve_graph_counts()
    eager = kernels(lambda: step(b))
    step(b)
    reset_launch_counts()
    replayed = kernels(lambda: step(b))
    return {"graph_counts": loop.serve_graph_counts(), "launches": launch_counts(),
            "eager": eager, "replayed": replayed}


@pytest.mark.cuda
def test_the_profiler_sees_a_replays_kernels(cuda):
    # The ported kernels of a replay under their own names, as often as
    # the counters say, and as many kernels as an eager call's (less the
    # graph's copy nodes, which a device-only trace names memcpy32_post).
    # In a process of its own: once torch 2.11's profiler has traced a
    # replay, later profiles in the process can miss device work.
    here = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(here.parent), os.environ.get("PYTHONPATH")) if p)}
    proc = subprocess.run(
        [sys.executable, "-c", "import json, test_torch_serve_graph as t; "
         "print(json.dumps(t._profile_a_replay()))"],
        cwd=here, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["graph_counts"] == _counts(1, 1, 1)
    replayed = out["replayed"]
    for kernel in ("dsnt_head_fwd", "row_shift"):
        seen = [n for n in replayed if f"{kernel}_kernel" in n]
        assert len(seen) == out["launches"][kernel] == 1 + (kernel == "row_shift"), (
            kernel, seen)
    assert len([n for n in replayed if "memcpy32" not in n]) == len(out["eager"])
