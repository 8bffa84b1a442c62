"""Infer CLI (port of ``dsnt_pose2d_tpu/cli/infer.py``): load a checkpoint,
run a subset, and write the predicted coordinates in original-image pixels
for the external ``eval-mpii-pose`` MATLAB harness: dataset ``preds`` of
shape (N, 16, 2), in an HDF5 file (``h5py``) or a ``.mat`` file
(``scipy.io.savemat``), stamped with the split's provenance and the subset.

    python -m dsnt_pose2d_tpu_torch.cli.infer --model-dir out/<exp> \
        --subset val --preds-file preds.h5 [--device cpu]

On N cards (each rank predicts its share; rank 0 writes the file):

    torchrun --nproc_per_node=N -m dsnt_pose2d_tpu_torch.cli.infer ...

The mesh's model axis is the run's ``train.model_parallel`` (config.json),
as in :mod:`.evaluate`.
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
    p = argparse.ArgumentParser("dsnt-pose2d-tpu-torch infer")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--epoch", type=int, default=None)
    p.add_argument("--subset", default="val", choices=["train", "val", "test"])
    p.add_argument("--preds-file", default="preds.h5",
                   help=".h5 or .mat output (layout for eval-mpii-pose)")
    p.add_argument("--batch-size", type=int, default=0,
                   help="override inference batch size")
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
        return _infer(args, cfg, ckpt, mesh)


def _infer(args, cfg, ckpt, mesh):
    device = mesh.device

    model = build_pose_model(cfg.model, device=device)
    if args.subset == "test":
        # The MPII test split (labels withheld upstream; predictions go to
        # the external MATLAB harness).
        from ..data import MPIIDataset

        ds = MPIIDataset(cfg.data.data_dir, "test",
                         canvas_size=cfg.data.canvas_size or 384)
    else:
        train_ds, val_ds = make_datasets(cfg)
        ds = val_ds if args.subset != "train" else train_ds
    _, loader = make_loaders(cfg, ds, ds, mesh)

    driver = EvalDriver(model=model, cfg=cfg, loader=loader, device=device,
                        mesh=mesh)
    epoch = args.epoch if args.epoch is not None else ckpt.best_epoch()
    state, _ = ckpt.restore(driver.init_state(), epoch=epoch)
    if state is None:
        raise SystemExit("no checkpoint found")

    preds = driver.predict(state)  # dataset order, every row, every rank
    if mesh.rank != 0:
        return 0

    # Stamp the split's provenance: a preds file from a hash-holdout val
    # split must not pass for a Tompson-split one.
    split_method = dataset_split_method(ds)
    if args.preds_file.endswith(".mat"):
        from scipy.io import savemat

        savemat(args.preds_file, {"preds": preds,
                                  "split_method": split_method or "unknown",
                                  "subset": args.subset})
    else:
        import h5py

        with h5py.File(args.preds_file, "w") as f:
            d = f.create_dataset("preds", data=preds)
            d.attrs["split_method"] = split_method or "unknown"
            d.attrs["subset"] = args.subset
    print(f"wrote {preds.shape} predictions to {args.preds_file} "
          f"(subset={args.subset}, split_method={split_method or 'unknown'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
