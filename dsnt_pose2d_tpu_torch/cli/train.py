"""Train CLI (port of ``dsnt_pose2d_tpu/cli/train.py``).

Example (the flagship, BASELINE config #3), on the card:

    python -m dsnt_pose2d_tpu_torch.cli.train --base-model hg8 \
        --output-strat dsnt --reg js --reg-coeff 1.0 --hm-sigma 1.0 \
        --batch-size 32 --epochs 120

``--device cpu`` runs it on the host.  ``--dashboard-port``,
``--profile-dir``, ``--debug-nans`` and ``--model-parallel`` > 1 are not
ported yet and raise ``NotImplementedError`` when given.
"""

from __future__ import annotations

import argparse

from ..device import resolve_device
from ..models.factory import build_pose_model
from ..train.checkpoint import CheckpointManager
from ..train.loop import Trainer
from ..train.metrics import MetricWriter
from .common import (
    add_data_args,
    add_device_arg,
    add_model_args,
    add_train_args,
    config_from_args,
    experiment_dir,
    make_datasets,
    make_loaders,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dsnt-pose2d-tpu-torch train")
    add_model_args(p)
    add_data_args(p)
    add_train_args(p)
    add_device_arg(p)
    p.add_argument("--dashboard-port", type=int, default=0,
                   help="serve a live metrics dashboard on this port "
                        "(not ported yet)")
    p.add_argument("--tensorboard", action="store_true",
                   help="also mirror scalar metrics to <out-dir>/tb "
                        "TensorBoard event files")
    p.add_argument("--debug-nans", action="store_true",
                   help="stop at the first NaN (not ported yet)")
    p.add_argument("--profile-dir", default="",
                   help="capture a profiler trace of early steps here "
                        "(not ported yet)")
    return p


def refuse_unported(args):
    """Raise for the flags whose machinery is not ported yet, naming the
    ROADMAP item that brings it."""
    for flag, given in (("--dashboard-port", args.dashboard_port),
                        ("--profile-dir", args.profile_dir),
                        ("--debug-nans", args.debug_nans)):
        if given:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP Queue 1, Telemetry)")
    if args.model_parallel > 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel} is not ported yet "
            "(ROADMAP Queue 1, Data parallel)")


def main(argv=None):
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    device = resolve_device(args.device)
    cfg = config_from_args(args)
    model = build_pose_model(cfg.model, device=device, seed=cfg.train.seed)
    out_dir = experiment_dir(cfg)

    train_ds, val_ds = make_datasets(cfg)
    train_loader, val_loader = make_loaders(cfg, train_ds, val_ds)

    ckpt = CheckpointManager(out_dir, cfg, max_to_keep=cfg.train.keep_checkpoints)
    writer = MetricWriter(out_dir, echo=True, tensorboard=args.tensorboard)
    trainer = Trainer(model=model, cfg=cfg, train_loader=train_loader,
                      val_loader=val_loader, checkpointer=ckpt,
                      metric_writer=writer, device=device)

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
            print(f"resumed from epoch {meta['epoch']}"
                  + (f" step {start_step}" if start_step else ""))

    state, best = trainer.run(state, start_epoch=start_epoch,
                              best_pckh=best_pckh, start_step=start_step)
    print(f"done; best val PCKh@0.5 = {100 * best:.2f}")
    writer.close()
    ckpt.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
