"""A tiny JAX run, converted for the port, and the JAX package's numbers on
it: the fixture ``tests/fixtures/jax_ckpt_hg1/`` that ``chip_smoke.py``'s
``jax_ckpt`` phase drives on the card (which has no JAX), and the run that
``tests/test_torch_jax_ckpt.py`` holds the port's CLIs against.

The run (:func:`train_run`): hg1 at 32 features, a 64-px input, fp32, the
fused head with JS, RMSProp, on the synthetic fixture (32 train rows of
96-px canvases, 8 val rows), batch 8, seed 7; made with the JAX package's
``create_train_state``, its jitted train step and its
``CheckpointManager``: 4 steps, the epoch-0 save (and, for the tests, the
best slot with ``best.json`` and a mid-epoch save 2 steps into epoch 1).
:func:`reference` reads, from JAX on the CPU: ``cli.evaluate``'s per-joint
counts with and without ``--flip-eval``, the normalised distance of every
val joint, ``predict``'s original-px preds, and one train step resumed from
the epoch-0 save (loss, its ``grad_norm``, and the norm with flax's BN
statistics in fp64, as ``tests/test_torch_train_step.py`` holds the port's
norm), with that step's augmentation draws.

The committed fixture holds the epoch-0 save alone (the port's layout is
~1.1 MB a key), ``jax_reference.json`` and ``resumed_step.npz`` (the
draws; the batch is rows 0-7 of the synthetic train split, which the port
makes bitwise equal).  Rewrite it with

    JAX_PLATFORMS=cpu python tests/jax_ckpt_fixture.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "jax_ckpt_hg1"
REFERENCE = "jax_reference.json"
DRAWS = "resumed_step.npz"
SEED, BATCH, ROWS, STEPS_PER_EPOCH = 7, 8, 32, 4
RESUMED_ROWS = list(range(BATCH))   # of the synthetic train split
for p in (ROOT, ROOT / "tests", ROOT / "tools"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def jax_config():
    from dsnt_pose2d_tpu.utils import config as jconfig

    return jconfig.Config(
        model=jconfig.ModelConfig(base="hg1", hg_features=32, input_size=64,
                                  dtype="float32", reg="js", use_pallas=True),
        optim=jconfig.OptimConfig(lr=1e-3),
        data=jconfig.DataConfig(source="synthetic", synthetic_size=ROWS,
                                workers=1),
        train=jconfig.TrainConfig(batch_size=BATCH, epochs=3, seed=SEED))


@functools.cache
def jax_parts():
    """The run's JAX config, model, splits and jitted train step (made
    once a process: the run and the resumed step share the compile)."""
    import jax

    from dsnt_pose2d_tpu.cli.common import make_datasets
    from dsnt_pose2d_tpu.models.factory import build_pose_model
    from dsnt_pose2d_tpu.train import loop as jloop

    cfg = jax_config()
    model = build_pose_model(cfg.model)
    step = jax.jit(jloop._build_step_bodies(model, cfg, STEPS_PER_EPOCH)[0])
    return cfg, model, make_datasets(cfg), step


def _rows(ds, idx) -> dict:
    """Rows ``idx`` of an in-memory (synthetic) split."""
    return {k: np.asarray(v)[idx] for k, v in ds.arrays.items()}


def train_run(run_dir: str, full: bool = True) -> None:
    """The JAX run in ``run_dir``: the epoch-0 save, and with ``full`` the
    best slot (``best.json``) and the step-6 save (epoch 1, step 2 in it)."""
    import jax
    import jax.numpy as jnp

    from dsnt_pose2d_tpu.cli.common import make_loaders
    from dsnt_pose2d_tpu.parallel.mesh import make_mesh
    from dsnt_pose2d_tpu.train import loop as jloop
    from dsnt_pose2d_tpu.train.checkpoint import CheckpointManager
    from dsnt_pose2d_tpu.train.metrics import MetricWriter
    from dsnt_pose2d_tpu.train.state import create_train_state

    cfg, model, (train_ds, val_ds), step = jax_parts()
    # One jitted program (the CPU path of create_train_state is eager, op
    # by op).
    state = jax.jit(lambda key: create_train_state(
        model, cfg.optim, key, steps_per_epoch=STEPS_PER_EPOCH,
        epochs=cfg.train.epochs))(jax.random.PRNGKey(SEED))
    ckpt = CheckpointManager(run_dir, cfg)
    writer = MetricWriter(run_dir, echo=False)
    losses = []
    for i in range(STEPS_PER_EPOCH):
        batch = _rows(train_ds, list(range(i * BATCH, (i + 1) * BATCH)))
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(m["loss"]))
    metrics = {"train_loss": float(np.mean(losses))}
    if full:
        _, val_loader = make_loaders(cfg, val_ds, val_ds)
        driver = jloop.EvalDriver(model=model, cfg=cfg, mesh=make_mesh(),
                                  loader=val_loader)
        result = driver.evaluate(state)
        metrics.update(val_pckh=float(result["pckh"]),
                       val_loss=float(result["loss"]))
    writer.write({"epoch": 0, **metrics})
    ckpt.save(0, state, is_best=full, metrics=metrics)
    if full:
        for i in range(2):
            batch = _rows(train_ds, list(range(i * BATCH, (i + 1) * BATCH)))
            state, _ = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        ckpt.save_step(state, epoch=1, step_in_epoch=2)
    ckpt.wait()
    ckpt.close()
    writer.close()


class _Recording:
    """Wraps a CLI module's ``EvalDriver`` so that each driver it makes, the
    state it evaluated and the result are kept."""

    def __init__(self, module):
        self.module, self.runs = module, []
        base = module.EvalDriver
        runs = self.runs

        class Driver(base):
            def evaluate(self, state, *a, **k):
                result = super().evaluate(state, *a, **k)
                runs.append((self, state, result))
                return result

        self.driver = Driver

    def __enter__(self):
        self.saved = self.module.EvalDriver
        self.module.EvalDriver = self.driver
        return self

    def __exit__(self, *exc):
        self.module.EvalDriver = self.saved


def normalised_distances(preds, val) -> np.ndarray:
    """``|pred - true| / head_length`` per val row and joint, NaN where the
    joint is not visible."""
    d = np.linalg.norm(np.asarray(preds, np.float64) - val["coords_px"], axis=-1)
    d = d / val["head_length"][:, None]
    return np.where(val["mask"] > 0, d, np.nan)


def jax_evaluate(run_dir: str, flip: bool) -> dict:
    """The JAX ``cli.evaluate`` on ``run_dir`` (``--flip-eval`` if
    ``flip``): its per-joint counts, loss and table, and its driver's
    ``predict`` on the state it evaluated."""
    from dsnt_pose2d_tpu.cli import evaluate as jevaluate
    from dsnt_pose2d_tpu.data.synthetic import make_synthetic_mpii

    argv = ["--model-dir", run_dir, "--platform", "cpu"] + (
        ["--flip-eval"] if flip else [])
    out = io.StringIO()
    with _Recording(jevaluate) as rec, contextlib.redirect_stdout(out):
        assert jevaluate.main(argv) == 0
    (driver, state, result), = rec.runs
    preds = np.asarray(driver.predict(state), np.float64)
    cfg = driver.cfg
    val = make_synthetic_mpii(max(cfg.data.synthetic_size // 4, 8),
                              canvas_size=cfg.data.canvas_size or 96, seed=2)
    ev = result["evaluator"]
    return {"correct": ev.correct.tolist(), "total": ev.total.tolist(),
            "loss": float(result["loss"]), "table": out.getvalue(),
            "preds": preds.tolist(),
            "norm_dist": normalised_distances(preds, val).tolist()}


def resumed_step(run_dir: str) -> tuple[dict, dict]:
    """One JAX train step from the epoch-0 save on rows RESUMED_ROWS of the
    train split: ``(numbers, draws)``."""
    import jax
    import jax.numpy as jnp
    import optax

    from dsnt_pose2d_tpu.models.factory import build_pose_model
    from dsnt_pose2d_tpu.train import loop as jloop
    from dsnt_pose2d_tpu.train.checkpoint import CheckpointManager
    from jax_ckpt_to_torch import restore_template
    from port_helpers import bn_statistics_in_fp64, jax_train_draws

    cfg, _, (train_ds, _), step = jax_parts()
    ckpt = CheckpointManager(run_dir)
    state, _ = ckpt.restore(restore_template(cfg), epoch=0)
    ckpt.close()
    batch = {k: jnp.asarray(v) for k, v in _rows(train_ds, RESUMED_ROWS).items()}
    _, metrics = step(state, batch)
    key = jax.random.fold_in(state.rng, state.step)

    # The step's gradients recomputed with the plain head, with flax's BN
    # statistics in fp64 (tests/test_torch_train_step.py's reference norm).
    plain = build_pose_model(dataclasses.replace(cfg.model, use_pallas=False))
    pre = jloop._build_eval_body(plain, cfg)[0](key, batch, True)

    def loss_fn(params):
        out, _ = plain.module.apply(
            {"params": params, "batch_stats": state.batch_stats},
            pre["images"], train=True, mutable=["batch_stats"])
        return plain.loss(out, pre["coords"], pre["mask"])[0]

    with jax.enable_x64(True), bn_statistics_in_fp64():
        norm_bn64 = float(optax.global_norm(jax.jit(jax.grad(loss_fn))(
            state.params)))
    draws = jax_train_draws(key, BATCH, cfg.data)
    numbers = {"step": int(state.step), "rows": RESUMED_ROWS,
               "synthetic": {"num_samples": ROWS, "canvas": 96, "seed": 1},
               **{k: float(metrics[k]) for k in ("loss", "euclidean", "reg",
                                                   "grad_norm")},
               "grad_norm_bn64": norm_bn64}
    return numbers, {k: v for k, v in draws.items() if v is not None}


def reference(run_dir: str) -> tuple[dict, dict]:
    """``(jax_reference.json's content, the resumed step's draws)``."""
    import jax
    import optax

    numbers, draws = resumed_step(run_dir)
    return {"jax": jax.__version__, "optax": optax.__version__,
            "evaluate": jax_evaluate(run_dir, flip=False),
            "evaluate_flip": jax_evaluate(run_dir, flip=True),
            "resumed_step": numbers}, draws


def write_fixture(dest: Path = FIXTURE, work: str | None = None) -> None:
    """The epoch-0 JAX run converted into ``dest`` by
    ``tools/jax_ckpt_to_torch.py``, with the reference numbers beside it."""
    import tempfile

    from jax_ckpt_to_torch import convert

    with tempfile.TemporaryDirectory(dir=work) as tmp:
        run = os.path.join(tmp, "jax_run")
        train_run(run, full=False)
        shutil.rmtree(dest, ignore_errors=True)
        convert(run, str(dest), log=lambda line: None)
        ref, draws = reference(run)
    with open(dest / REFERENCE, "w") as f:
        json.dump(ref, f, indent=1)
    np.savez(dest / DRAWS, **draws)


if __name__ == "__main__":
    os.environ.setdefault("DSNT_NO_COMPILE_CACHE", "1")
    write_fixture()
    print(f"wrote {FIXTURE}")
