"""Evaluate CLI (port of ``dsnt_pose2d_tpu/cli/evaluate.py``): load a
checkpoint, run the validation split, print the PCKh@0.5 table with the
split's provenance and the val loss.

    python -m dsnt_pose2d_tpu_torch.cli.evaluate --model-dir out/<exp> \
        [--flip-eval] [--eval-scales 0.9,1.0,1.1] [--device cpu]

On N cards (each rank scores its share of the split; rank 0 prints):

    torchrun --nproc_per_node=N -m dsnt_pose2d_tpu_torch.cli.evaluate ...

The mesh's model axis is the run's ``train.model_parallel`` (config.json),
as the JAX CLI reads it.  The checkpoint is whole, so it scores at any
width that divides N: set the field in config.json to change it.
"""

from __future__ import annotations

import argparse

from ..models.factory import build_pose_model
from ..train.checkpoint import CheckpointManager
from ..train.loop import EvalDriver
from .common import (add_data_args, add_device_arg, dataset_split_method,
                     make_datasets, make_loaders, merge_cli_overrides,
                     start_distributed)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dsnt-pose2d-tpu-torch evaluate")
    p.add_argument("--model-dir", required=True,
                   help="experiment dir containing config.json + ckpt/")
    p.add_argument("--epoch", type=int, default=None,
                   help="checkpoint epoch (default: best if recorded, else latest)")
    p.add_argument("--batch-size", type=int, default=0,
                   help="override eval batch size")
    p.add_argument("--flip-eval", action="store_true",
                   help="average predictions with a horizontally-flipped pass")
    p.add_argument("--eval-scales", default="1.0",
                   help="comma-separated crop scales to average predictions "
                        "over (multi-scale eval), e.g. '0.9,1.0,1.1'")
    add_data_args(p)
    add_device_arg(p)
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    ckpt = CheckpointManager(args.model_dir)
    cfg = ckpt.load_config()
    if cfg is None:
        raise SystemExit(f"no config.json in {args.model_dir}")
    cfg = merge_cli_overrides(cfg, args, p, argv)
    # The run's model-parallel width, as the JAX CLIs read it.
    with start_distributed(args.device, cfg.train.model_parallel) as mesh:
        return _evaluate(args, cfg, ckpt, mesh)


def _evaluate(args, cfg, ckpt, mesh):
    device = mesh.device

    model = build_pose_model(cfg.model, device=device)
    _, val_ds = make_datasets(cfg)
    _, val_loader = make_loaders(cfg, val_ds, val_ds, mesh)

    driver = EvalDriver(model=model, cfg=cfg, loader=val_loader, device=device,
                        mesh=mesh)
    epoch = args.epoch if args.epoch is not None else ckpt.best_epoch()
    state, _ = ckpt.restore(driver.init_state(), epoch=epoch)
    if state is None:
        raise SystemExit("no checkpoint found")
    result = driver.evaluate(state)   # the global counts, on every rank
    if mesh.rank == 0:
        result["evaluator"].provenance = dataset_split_method(val_ds)
        print(result["evaluator"].table())
        print(f"val loss {result['loss']:.5f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
