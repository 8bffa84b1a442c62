"""Ranks of the port's data- and tensor-parallel tests
(``tests/test_torch_parallel*.py``).

This module imports torch and the port only, never JAX: the tests start
``world`` copies of it as plain processes over gloo, under the variables a
launcher sets (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), so each rank joins its group through
``parallel.mesh.initialize_distributed`` as a ``torchrun`` rank does:

    python tests/torch_dp_worker.py <job> <in_dir> <out_dir>

The parent writes a job's inputs (config JSON, weights and batches as
numpy) into ``in_dir``; each rank writes ``<out_dir>/<job>_rank<r>.pt``.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from dsnt_pose2d_tpu_torch.data.loader import ShardedLoader  # noqa: E402
from dsnt_pose2d_tpu_torch.data.mpii import ArrayDataset  # noqa: E402
from dsnt_pose2d_tpu_torch.data.resident import ResidentEvalData  # noqa: E402
from dsnt_pose2d_tpu_torch.models import heads  # noqa: E402
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model  # noqa: E402
from dsnt_pose2d_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from dsnt_pose2d_tpu_torch.parallel import tp  # noqa: E402
from dsnt_pose2d_tpu_torch.train import loop  # noqa: E402
from dsnt_pose2d_tpu_torch.utils.config import config_from_json  # noqa: E402


def launch(job: str, in_dir, out_dir, world: int = 2, timeout: float = 240.0):
    """Run ``job`` on ``world`` ranks and wait for them; raises with the
    ranks' output if one fails or the job outlasts ``timeout`` seconds."""
    return wait(start(job, in_dir, out_dir, world), timeout)


def start(job: str, in_dir, out_dir, world: int = 2):
    """Start ``job``'s ``world`` ranks; :func:`wait` collects them."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        env = {**os.environ, "WORLD_SIZE": str(world), "RANK": str(r),
               "LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, __file__, job, str(in_dir), str(out_dir)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return job, out_dir, procs


def wait(started, timeout: float = 240.0):
    """The ranks' outputs of a :func:`start`ed job, once all have exited."""
    job, out_dir, procs = started
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if any(p.returncode for p in procs):
        raise RuntimeError("\n".join(
            f"--- rank {r} exited {p.returncode}:\n{out[-4000:]}"
            for r, (p, out) in enumerate(zip(procs, outs))))
    return [torch.load(Path(out_dir) / f"{job}_rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


def load_inputs(in_dir):
    in_dir = Path(in_dir)
    cfg = config_from_json((in_dir / "cfg.json").read_text())
    with np.load(in_dir / "weights.npz") as f:
        weights = {k: f[k] for k in f.files}
    return cfg, weights


def npz(path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _state(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.net.state_dict().items()}


def _host(metrics: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in metrics.items()}


@contextlib.contextmanager
def fp64_heads():
    """The dsnt head's activation in the heatmaps' own dtype: the port casts
    them to fp32 (as the JAX package), which would cut an fp64 model's
    step to fp32 precision.  Lifted for the fp64 tests only."""
    base = heads.activate_heatmaps

    def keep_dtype(raw, preact, threshold=0.0):
        if preact == "thresholded_softmax":
            return heads.ops.thresholded_softmax(raw, threshold)
        return heads.ops.HEATMAP_ACTIVATIONS[preact](raw)

    heads.activate_heatmaps = keep_dtype
    try:
        yield
    finally:
        heads.activate_heatmaps = base


def fp64_steps(cfg, weights, batch, steps: int, mesh=None) -> dict:
    """``steps`` train steps of the port's ``make_train_fn`` in fp64 on
    ``batch`` (this rank's rows of it under ``mesh``), with its own draws:
    the step metrics and the state after each step."""
    model = build_pose_model(cfg.model, device="cpu", state_dict=weights)
    model.net.double()
    model.net.backbone.dtype = torch.float64
    model.net.register_forward_pre_hook(lambda _, args: (args[0].double(),))
    if mesh is not None:
        tp.shard_model_(model.net, mesh)
        batch = pmesh.shard_batch(mesh, batch)
    step = loop.make_train_fn(model, cfg, device="cpu")
    out = {"metrics": [], "state": []}
    with fp64_heads():
        for _ in range(steps):
            out["metrics"].append(_host(step(batch)))
            out["state"].append(_state(model))
    return out


def nan_on_one_rank(mesh, cfg) -> str | None:
    """``--debug-nans`` under the group, as a train step runs it: rank 1's
    backward makes a NaN (sqrt's gradient at 0, times 0) ahead of a
    collective in backward order (the differentiable all-reduce), which
    every rank must still reach.  Returns what this rank raised."""
    from dsnt_pose2d_tpu_torch.train.state import make_optimizer

    loop.set_debug_nans(True)
    try:
        w = torch.ones(3, requires_grad=True)
        x = pmesh.all_reduce_sum(w * 1.0) - 2.0 * mesh.rank
        loss = (torch.sqrt(x) * 0).sum()
        opt = make_optimizer([w], cfg.optim)
        try:
            loop._backward_checked(
                loss, global_loss=pmesh.all_reduce_sum_(loss.detach().clone()))
            opt.step(lambda norm: loop._check_grads([("w", w)], norm))
        except FloatingPointError as e:
            return str(e)
        return None
    finally:
        loop.set_debug_nans(False)


def job_step(mesh, in_dir) -> dict:
    """fp32: one ``make_train_fn`` step on this rank's rows of the global
    batch and of the JAX draws, with the collectives it issued; fp64: two
    steps with the port's own draws; the mask sum: ``pose_loss`` on this
    rank's rows of fixed heatmaps; last :func:`nan_on_one_rank`."""
    cfg, weights = load_inputs(in_dir)
    batch = npz(Path(in_dir) / "batch.npz")
    draws = npz(Path(in_dir) / "draws.npz")
    model = build_pose_model(cfg.model, device="cpu", state_dict=weights)
    step = loop.make_train_fn(model, cfg, device="cpu")
    b = batch["canvases"].shape[0] // mesh.world_size
    lo = mesh.rank * b
    local_draws = {k: torch.from_numpy(v[lo:lo + b]) for k, v in draws.items()}
    pmesh.reset_collective_counts()
    metrics = _host(step(pmesh.shard_batch(mesh, batch), draws=local_draws))
    counts = pmesh.collective_counts()
    bns = sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.net.modules())

    cfg64 = config_from_json((Path(in_dir) / "cfg64.json").read_text())
    fp64 = fp64_steps(cfg64, weights, batch, 2, mesh)

    case = npz(Path(in_dir) / "mask_case.npz")
    raw, t, m = (torch.from_numpy(case[k]) for k in ("raw", "coords", "mask"))
    bb = raw.shape[1] // mesh.world_size
    rows = slice(mesh.rank * bb, (mesh.rank + 1) * bb)
    share, aux = heads.pose_loss(heads.PoseOutput(raw[:, rows]), t[rows],
                                 m[rows], cfg.model)
    total = pmesh.all_reduce_sum_(share.detach().clone())
    return {"fp32": {"metrics": metrics, "state": _state(model),
                     "collectives": counts, "bns": bns},
            "fp64": fp64,
            "mask_case": {"share": share.detach(), "total": total,
                          "visible": float(m[rows].sum())},
            "debug_nans": nan_on_one_rank(mesh, cfg)}


def job_eval(mesh, in_dir) -> dict:
    """The streaming eval pass and ``EvalDriver.predict`` over this rank's
    host split, and the resident eval scan over this rank's shard."""
    cfg, weights = load_inputs(in_dir)
    ds = ArrayDataset(npz(Path(in_dir) / "split.npz"))
    model = build_pose_model(cfg.model, device="cpu", state_dict=weights)
    bs = cfg.train.batch_size
    loader = ShardedLoader(ds, bs, shuffle=False, drop_last=False,
                           num_hosts=mesh.world_size, host_id=mesh.rank)
    driver = loop.EvalDriver(model=model, cfg=cfg, loader=loader,
                             device="cpu", mesh=mesh)
    streamed = driver.evaluate()
    preds = driver.predict()
    res = ResidentEvalData(ds, bs, "cpu", num_shards=mesh.world_size,
                           shard=mesh.rank)
    scan = loop.make_resident_eval_scan(model, cfg, "cpu", driver.eval_step)
    resident = loop.run_evaluation_resident_scan(scan, res, model.cfg.num_joints)
    return {"streamed": {"loss": streamed["loss"],
                         "correct": streamed["evaluator"].correct,
                         "total": streamed["evaluator"].total},
            "resident": {"loss": resident["loss"],
                         "correct": resident["evaluator"].correct,
                         "total": resident["evaluator"].total},
            "preds": preds, "steps": loader.steps_per_epoch,
            "gidx": loader.global_index_batches(0)}


def _trainer(cfg, weights, train, val, out_dir, mesh):
    from dsnt_pose2d_tpu_torch.train.checkpoint import CheckpointManager
    from dsnt_pose2d_tpu_torch.train.metrics import MetricWriter

    model = build_pose_model(cfg.model, device="cpu", state_dict=weights)
    writer = MetricWriter(out_dir, echo=False)
    return loop.Trainer(
        model=model, cfg=cfg,
        train_loader=ShardedLoader(ArrayDataset(train), cfg.train.batch_size,
                                   shuffle=True, seed=cfg.train.seed,
                                   num_hosts=mesh.world_size, host_id=mesh.rank),
        val_loader=ShardedLoader(ArrayDataset(val), cfg.train.batch_size,
                                 shuffle=False, drop_last=False,
                                 num_hosts=mesh.world_size, host_id=mesh.rank),
        checkpointer=CheckpointManager(out_dir, cfg), metric_writer=writer,
        device="cpu", mesh=mesh)


def _full_state(state) -> dict:
    opt = state.optimizer.optimizer.state_dict()["state"]
    return {"model": {k: v.clone() for k, v in state.model.net.state_dict().items()},
            "opt": {i: {k: v.clone() for k, v in s.items()} for i, s in opt.items()},
            "count": state.optimizer.count, "step": state.step}


def job_trainer(mesh, in_dir) -> dict:
    """``Trainer.run`` over resident shards (run A, 2 epochs with step
    checkpoints), a resume of A's older mid-epoch save on a fresh Trainer
    (run B), then ``cli.train`` -> ``cli.evaluate`` -> ``cli.infer`` over
    the ranks."""
    from dsnt_pose2d_tpu_torch.cli import evaluate, infer
    from dsnt_pose2d_tpu_torch.cli import train as train_cli
    from dsnt_pose2d_tpu_torch.train.checkpoint import CheckpointManager

    cfg, weights = load_inputs(in_dir)
    train, val = npz(Path(in_dir) / "train.npz"), npz(Path(in_dir) / "val.npz")
    work = Path(in_dir)
    a = _trainer(cfg, weights, train, val, str(work / "run_a"), mesh)
    summaries = []
    a.hooks = (lambda epoch, state, summary: summaries.append(summary),)
    state_a, best_a = a.run()
    steps = sorted(int(s) for s in os.listdir(work / "run_a" / "ckpt_step")
                   if s.isdigit())

    fresh = build_pose_model(cfg.model, device="cpu", seed=99).net.state_dict()
    b = _trainer(cfg, fresh, train, val, str(work / "run_b"), mesh)
    meta = CheckpointManager(str(work / "run_a")).step_mgr.restore(
        steps[0], b.init_state())
    state_b, _ = b.run(start_epoch=int(meta["epoch"]),
                       start_step=int(meta["step_in_epoch"]))

    recorded = {}

    class RecordingDriver(loop.EvalDriver):
        def evaluate(self, *args, **kw):
            result = super().evaluate(*args, **kw)
            recorded["pckh"] = result["pckh"]
            return result

    evaluate.EvalDriver = RecordingDriver
    data = ["--device", "cpu", "--data-source", "synthetic",
            "--synthetic-size", "32", "--canvas-size", "48"]
    out = work / "cli"
    cli = {}
    with open(work / f"cli_rank{mesh.rank}.log", "w") as log, \
            contextlib.redirect_stdout(log):
        cli["train"] = train_cli.main(
            data + ["--base-model", "hg1", "--reg", "js", "--hg-features",
                    "16", "--input-size", "64", "--dtype", "float32",
                    "--workers", "1", "--batch-size", "8", "--epochs", "1",
                    "--lr", "1e-3", "--out-dir", str(out),
                    "--experiment-id", "dp", "--device-resident", "off"])
        cli["evaluate"] = evaluate.main(["--model-dir", str(out / "dp"), *data])
        cli["infer"] = infer.main(["--model-dir", str(out / "dp"), *data,
                                   "--preds-file", str(out / "preds.mat")])
    cli["evaluate_pckh"] = recorded["pckh"]
    return {"a": _full_state(state_a), "b": _full_state(state_b),
            "best_a": best_a, "summaries": summaries, "ckpt_steps": steps,
            "resumed_from": meta, "cli": cli,
            "resident": (a.resident.num_shards, a.resident.shard,
                         a.val_resident.num_shards),
            "shard_rows": {k: tuple(v.shape) for k, v in a.resident.resident.items()}}


def _moments(state) -> dict:
    """``{parameter name: {state key: tensor}}`` of the optimizer."""
    names = {id(p): n for n, p in state.model.net.named_parameters()}
    opt = state.optimizer.optimizer
    return {names[id(p)]: {k: v.clone() for k, v in opt.state[p].items()}
            for g in opt.param_groups for p in g["params"] if p in opt.state}


def job_tp(mesh, in_dir) -> dict:
    """``model_parallel=2`` over 2 ranks.  For each model of ``models.json``
    its shards as loaded, then one train step on the whole batch (the JAX
    draws where the job has them) with its metrics, state, optimizer
    moments and collectives; the hg model's fp64 steps; a checkpoint of the
    hg state after its step (``ckpt_t2``) and the restore of the one-process
    checkpoint ``ckpt_t1``; then ``cli.train --model-parallel 2`` ->
    ``cli.evaluate`` -> ``cli.infer`` at t = 2."""
    from dsnt_pose2d_tpu_torch.cli import evaluate, infer
    from dsnt_pose2d_tpu_torch.cli import train as train_cli
    from dsnt_pose2d_tpu_torch.train.checkpoint import CheckpointManager

    work = Path(in_dir)
    out = {}
    for name in json.loads((work / "models.json").read_text()):
        cfg = config_from_json((work / f"{name}_cfg.json").read_text())
        weights = npz(work / f"{name}_weights.npz")
        batch = npz(work / f"{name}_batch.npz")
        draws = work / f"{name}_draws.npz"
        draws = ({k: torch.from_numpy(v) for k, v in npz(draws).items()}
                 if draws.exists() else None)
        model = build_pose_model(cfg.model, device="cpu", state_dict=weights)
        tp.shard_model_(model.net, mesh)
        loaded = _state(model)
        step = loop.make_train_fn(model, cfg, device="cpu")
        pmesh.reset_collective_counts()
        metrics = _host(step(pmesh.shard_batch(mesh, batch), draws=draws))
        out[name] = {"loaded": loaded, "metrics": metrics, "state": _state(model),
                     "moments": _moments(step.state),
                     "collectives": {a: pmesh.collective_counts(a)
                                     for a in ("data", "model", None)}}
        if name == "hg":
            CheckpointManager(str(work / "ckpt_t2")).save_step(
                step.state, epoch=0, step_in_epoch=1)
            fresh = build_pose_model(cfg.model, device="cpu", seed=7)
            tp.shard_model_(fresh.net, mesh)
            restored = loop.make_train_fn(fresh, cfg, device="cpu").state
            meta = CheckpointManager(str(work / "ckpt_t1")).step_mgr.restore(
                1, restored)
            out["restored"] = {"state": _state(fresh), "moments": _moments(restored),
                               "count": restored.optimizer.count,
                               "step": restored.step, "meta": meta}
            cfg64 = config_from_json((work / "hg_cfg64.json").read_text())
            out["fp64"] = fp64_steps(cfg64, weights, batch, 2, mesh)

    recorded = {}

    class RecordingDriver(loop.EvalDriver):
        def evaluate(self, *args, **kw):
            result = super().evaluate(*args, **kw)
            recorded["pckh"] = result["pckh"]
            return result

    evaluate.EvalDriver = RecordingDriver
    data = ["--device", "cpu", "--data-source", "synthetic",
            "--synthetic-size", "32", "--canvas-size", "48"]
    cli_dir = work / "cli"
    cli = {}
    with open(work / f"cli_rank{mesh.rank}.log", "w") as log, \
            contextlib.redirect_stdout(log):
        cli["train"] = train_cli.main(
            data + ["--base-model", "hg1", "--reg", "js", "--hg-features",
                    "16", "--input-size", "64", "--dtype", "float32",
                    "--workers", "1", "--batch-size", "8", "--epochs", "1",
                    "--lr", "1e-3", "--out-dir", str(cli_dir),
                    "--experiment-id", "tp", "--device-resident", "off",
                    "--model-parallel", "2"])
        cli["evaluate"] = evaluate.main(["--model-dir", str(cli_dir / "tp"), *data])
        cli["infer"] = infer.main(["--model-dir", str(cli_dir / "tp"), *data,
                                   "--preds-file", str(cli_dir / "preds.mat")])
    cli["evaluate_pckh"] = recorded["pckh"]
    out["cli"] = cli
    return out


def job_tp4(mesh, in_dir) -> dict:
    """``model_parallel=2`` over 4 ranks (data 2 x model 2): the fp64 step
    of ``hg_cfg64_remat.json`` (each hourglass stack under remat, whose
    recompute repeats the stack's collectives) on this data index's rows,
    with its collectives."""
    cfg64 = config_from_json((Path(in_dir) / "hg_cfg64_remat.json").read_text())
    weights = npz(Path(in_dir) / "hg_weights.npz")
    batch = npz(Path(in_dir) / "hg_batch.npz")
    pmesh.reset_collective_counts()
    out = fp64_steps(cfg64, weights, batch, 1, mesh)
    out["collectives"] = {a: pmesh.collective_counts(a)
                          for a in ("data", "model", None)}
    out["mesh"] = (mesh.data_index, mesh.model_index, mesh.shape)
    return out


JOBS = {"step": job_step, "eval": job_eval, "trainer": job_trainer,
        "tp": job_tp, "tp4": job_tp4}
# The model-parallel width of each job's mesh (1 where not named).
MODEL_PARALLEL = {"tp": 2, "tp4": 2}


def main(argv):
    job, in_dir, out_dir = argv
    torch.set_num_threads(1)
    pmesh.initialize_distributed("cpu")
    mesh = pmesh.make_mesh(MODEL_PARALLEL.get(job, 1), device="cpu")
    assert mesh.world_size == int(os.environ["WORLD_SIZE"]) > 1, mesh
    try:
        out = JOBS[job](mesh, in_dir)
        out["world"] = {"backend": torch.distributed.get_backend(),
                        "rank": mesh.rank, "world_size": mesh.world_size}
        torch.save(out, Path(out_dir) / f"{job}_rank{mesh.rank}.pt")
    finally:
        torch.distributed.destroy_process_group()
    print(json.dumps({"rank": mesh.rank, "job": job, "ok": True}))


if __name__ == "__main__":
    main(sys.argv[1:])
