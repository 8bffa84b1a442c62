"""Train CLI (port of ``dsnt_pose2d_tpu/cli/train.py``).

Example (the flagship, BASELINE config #3), on the card:

    python -m dsnt_pose2d_tpu_torch.cli.train --base-model hg8 \
        --output-strat dsnt --reg js --reg-coeff 1.0 --hm-sigma 1.0 \
        --batch-size 32 --epochs 120

On N cards of one host, data parallel (``--batch-size`` is the global
batch; each rank trains ``1/N`` of it):

    torchrun --nproc_per_node=N -m dsnt_pose2d_tpu_torch.cli.train ...

``--model-parallel t`` (or a config's ``train.model_parallel``) lays the N
ranks out as ``(N / t, t)`` as ``(data, model)`` and shards the model's
kernels over the ``t`` ranks of each model group (:mod:`..parallel.tp`);
on the CPU, two ranks over gloo:

    torchrun --nproc_per_node=2 -m dsnt_pose2d_tpu_torch.cli.train \
        --device cpu --model-parallel 2 ...

``--config configs/vit_s16_dsnt_2x.json`` runs a config file (the flags
given beside it override its fields).  ``--device cpu`` runs it on the
host (over gloo under a launcher).  ``--dashboard-port`` serves the
live dashboard (:mod:`..train.dashboard`) while the run lasts,
``--profile-dir`` writes a ``torch.profiler`` trace of the second epoch
(:mod:`..train.profiling`), both from rank 0, and ``--debug-nans`` stops
at the first NaN (:func:`..train.loop.set_debug_nans`, process-wide as
JAX's ``jax_debug_nans``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses

import torch.distributed as dist

from ..models.factory import build_pose_model
from ..train.checkpoint import CheckpointManager
from ..train.loop import Trainer, set_debug_nans
from ..train.metrics import MetricWriter
from ..utils.config import MODEL_VERSION, config_from_json
from .common import (
    add_config_arg,
    add_data_args,
    add_device_arg,
    add_model_args,
    add_train_args,
    config_from_args,
    config_with_flags,
    experiment_dir,
    make_datasets,
    make_loaders,
    start_distributed,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dsnt-pose2d-tpu-torch train")
    add_model_args(p)
    add_data_args(p)
    add_train_args(p)
    add_device_arg(p)
    add_config_arg(p)
    p.add_argument("--dashboard-port", type=int, default=0,
                   help="serve a live metrics dashboard on this port while "
                        "the run lasts")
    p.add_argument("--tensorboard", action="store_true",
                   help="also mirror scalar metrics to <out-dir>/tb "
                        "TensorBoard event files")
    p.add_argument("--debug-nans", action="store_true",
                   help="stop at the first NaN with FloatingPointError: "
                        "autograd's anomaly mode, and each train step checks "
                        "its loss and gradients (unlike jax_debug_nans, a NaN "
                        "made in the forward pass is caught at the loss, not "
                        "at its op); process-wide")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace of the second epoch "
                        "here (a breakdown, not a timing)")
    return p


def run_config(args, parser, argv):
    """The run's config: ``--config``'s file with the given flags over its
    fields, else the flags'."""
    if not args.config:
        return config_from_args(args)
    with open(args.config) as f:
        cfg = config_with_flags(config_from_json(f.read()), args, parser, argv)
    # A preset without the field reads as model_version 0 (a checkpoint of
    # an older graph); this run builds the current graph.
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, model_version=MODEL_VERSION))


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    cfg = run_config(args, parser, argv)
    with start_distributed(args.device, cfg.train.model_parallel) as mesh:
        return _train(args, cfg, mesh)


def _train(args, cfg, mesh):
    device = mesh.device
    if args.debug_nans:
        set_debug_nans(True)
    model = build_pose_model(cfg.model, device=device, seed=cfg.train.seed)
    out_dir = experiment_dir(cfg)

    train_ds, val_ds = make_datasets(cfg)
    train_loader, val_loader = make_loaders(cfg, train_ds, val_ds, mesh)
    if mesh.group is not None and mesh.rank == 0:
        print(f"distributed: backend={dist.get_backend()} "
              f"world_size={mesh.world_size} device={device}"
              + (f" model_parallel={mesh.model_parallel}"
                 if mesh.model_parallel > 1 else ""), flush=True)

    ckpt = CheckpointManager(out_dir, cfg, max_to_keep=cfg.train.keep_checkpoints)
    # Rank 0 writes the metric records (the JAX package's process 0).
    writer = (MetricWriter(out_dir, echo=True, tensorboard=args.tensorboard)
              if mesh.rank == 0 else None)
    trainer = Trainer(model=model, cfg=cfg, train_loader=train_loader,
                      val_loader=val_loader, checkpointer=ckpt,
                      metric_writer=writer, device=device, mesh=mesh)

    state = None
    start_epoch = 0
    start_step = 0
    best_pckh = -1.0
    if args.resume:
        restored, meta = ckpt.restore_latest(trainer.init_state())
        if restored is not None:
            state = restored
            if meta.get("step_in_epoch", 0):
                # A mid-epoch save: enter the same epoch at its offset.
                start_epoch = int(meta["epoch"])
                start_step = int(meta["step_in_epoch"])
            else:
                start_epoch = int(meta["epoch"]) + 1
            # Seed the best-model tracker, so that a worse resumed model
            # does not take the recorded best's slot.
            best_pckh = float(ckpt.best_metrics().get("val_pckh", -1.0))
            if mesh.rank == 0:
                print(f"resumed from epoch {meta['epoch']}"
                      + (f" step {start_step}" if start_step else ""))

    with contextlib.ExitStack() as telemetry:
        if mesh.rank == 0:
            trainer.hooks = start_telemetry(args, out_dir, telemetry)
        state, best = trainer.run(state, start_epoch=start_epoch,
                                  best_pckh=best_pckh, start_step=start_step)
    if mesh.rank == 0:
        print(f"done; best val PCKh@0.5 = {100 * best:.2f}")
    if writer is not None:
        writer.close()
    ckpt.close()
    return 0


def start_telemetry(args, out_dir: str, stack: contextlib.ExitStack) -> tuple:
    """Start the dashboard server and make the profile hook that the flags
    ask for, each stopped when ``stack`` closes (the server when the run
    ends; a profile still running, unwritten); returns the Trainer's
    hooks.  Rank 0 serves the dashboard and profiles (the JAX package's
    process 0)."""
    hooks = ()
    if args.dashboard_port:
        from ..train.dashboard import serve

        server = serve(out_dir, args.dashboard_port)
        stack.callback(server.server_close)
        stack.callback(server.shutdown)
        print(f"dashboard: http://localhost:{args.dashboard_port}/")
    if args.profile_dir:
        from ..train.profiling import make_profile_hook

        hook = make_profile_hook(args.profile_dir)
        stack.callback(hook.close)
        hooks = (hook,)
    return hooks


if __name__ == "__main__":
    raise SystemExit(main())
