"""Shared CLI plumbing (port of ``dsnt_pose2d_tpu/cli/common.py``): the
argparse surface of the reference's flags, the config it builds, the
datasets and the loaders.

The JAX package's ``--platform`` and XLA compilation cache have no
counterpart here; ``--device {cuda,cpu}`` (default ``cuda``) takes the
place of ``--platform``.  Without a card and without ``--device cpu`` the
entry points raise (:func:`..device.resolve_device`).
"""

from __future__ import annotations

import argparse
import os

from ..data import ArrayDataset, MPIIDataset, ShardedLoader, make_synthetic_mpii
from ..device import DEFAULT_DEVICE
from ..utils.config import Config, DataConfig, ModelConfig, OptimConfig, TrainConfig


def add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default=DEFAULT_DEVICE, choices=["cuda", "cpu"],
                   help="run on the card (default) or, with 'cpu', on the host")


def add_model_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("model")
    g.add_argument("--base-model", default="hg1",
                   help="hg{1,2,4,8} | resnet{18,34,50,101}")
    g.add_argument("--dilate", type=int, default=0)
    g.add_argument("--truncate", type=int, default=0)
    g.add_argument("--output-strat", default="dsnt",
                   choices=["dsnt", "gauss", "fc"])
    g.add_argument("--preact", default="softmax",
                   choices=["softmax", "thresholded_softmax", "relu", "abs",
                            "sigmoid"])
    g.add_argument("--reg", default="none",
                   choices=["none", "var", "kl", "js", "mse"])
    g.add_argument("--reg-coeff", type=float, default=1.0)
    g.add_argument("--hm-sigma", type=float, default=1.0)
    g.add_argument("--hm-threshold", type=float, default=0.0,
                   help="logit cutoff for --preact thresholded_softmax")
    g.add_argument("--coord-loss", default="euclidean",
                   choices=["euclidean", "l1", "mse"])
    g.add_argument("--no-pallas", action="store_true",
                   help="disable the fused DSNT head kernel (plain ops head)")
    g.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    g.add_argument("--hg-features", type=int, default=256)
    g.add_argument("--input-size", type=int, default=0)


WORKERS_DEFAULT = 4


def add_data_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("data")
    g.add_argument("--data-dir", default="data/mpii")
    g.add_argument("--data-source", default="auto",
                   choices=["auto", "h5", "synthetic"])
    g.add_argument("--synthetic-size", type=int, default=256)
    g.add_argument("--canvas-size", type=int, default=0,
                   help="host canvas px (0 = auto)")
    g.add_argument("--warp-method", default="shear",
                   choices=["gather", "shear"],
                   help="on-device bilinear warp implementation (shear = "
                        "row_shift kernel + resampling matmuls; gather = "
                        "direct 2-D reference)")
    g.add_argument("--workers", type=int, default=WORKERS_DEFAULT,
                   help="loader sample-fetch threads (native decode is GIL-free)")
    g.add_argument("--pretrained-resnet", default="",
                   help="torchvision ResNet state_dict (.pth/.npz) to "
                        "initialize the ResNet backbone from")
    g.add_argument("--device-resident", default="auto",
                   choices=["auto", "on", "off"],
                   help="stage the packed train split in device memory and "
                        "gather batches there (no per-step host-to-device "
                        "copy); auto = when it fits the budget")
    g.add_argument("--no-auto-pack", action="store_true",
                   help="disable pack-as-you-stream (epoch 0 writing the "
                        "packed archive while streaming a raw MPII layout)")


def add_train_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("train")
    g.add_argument("--batch-size", type=int, default=32)
    g.add_argument("--epochs", type=int, default=120)
    g.add_argument("--lr", type=float, default=2.5e-4)
    g.add_argument("--optimizer", default="rmsprop",
                   choices=["rmsprop", "adam", "sgd"])
    g.add_argument("--schedule", default="step",
                   choices=["step", "constant", "cosine"])
    g.add_argument("--seed", type=int, default=12345)
    g.add_argument("--out-dir", default="out")
    g.add_argument("--experiment-id", default="")
    g.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in out-dir")
    g.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="optimizer steps per dispatch group (resident input)")
    g.add_argument("--model-parallel", type=int, default=1,
                   help="tensor-parallel width (1 = one device; >1 is not "
                        "ported yet)")


def config_from_args(args) -> Config:
    model = ModelConfig(
        base=args.base_model, dilate=args.dilate, truncate=args.truncate,
        output_strat=args.output_strat, preact=args.preact, reg=args.reg,
        reg_coeff=args.reg_coeff, hm_sigma=args.hm_sigma,
        hm_threshold=getattr(args, "hm_threshold", 0.0),
        coord_loss=getattr(args, "coord_loss", "euclidean"),
        use_pallas=not args.no_pallas, dtype=args.dtype,
        hg_features=args.hg_features, input_size=args.input_size)
    data = DataConfig(
        data_dir=args.data_dir, source=args.data_source,
        synthetic_size=args.synthetic_size,
        canvas_size=getattr(args, "canvas_size", 0),
        warp_method=getattr(args, "warp_method", "shear"),
        workers=getattr(args, "workers", 1),
        pretrained_resnet=getattr(args, "pretrained_resnet", ""),
        device_resident=getattr(args, "device_resident", "auto"),
        auto_pack=not getattr(args, "no_auto_pack", False))
    optim = OptimConfig(lr=args.lr, optimizer=args.optimizer,
                        schedule=getattr(args, "schedule", "step"))
    train = TrainConfig(
        batch_size=args.batch_size, epochs=args.epochs, seed=args.seed,
        out_dir=args.out_dir, experiment_id=args.experiment_id,
        steps_per_dispatch=getattr(args, "steps_per_dispatch", 1),
        model_parallel=getattr(args, "model_parallel", 1))
    return Config(model=model, optim=optim, data=data, train=train)


def explicit_cli_args(parser: argparse.ArgumentParser, argv=None) -> set:
    """Dest names of the options present on the command line.

    Comparing parsed values with the parser's defaults cannot tell "typed
    the default" from "left out", so a flag set explicitly to its default
    could never override a checkpoint's config.  Parsing again with every
    default suppressed leaves only the dests the user gave.
    """
    import sys

    argv = list(sys.argv[1:]) if argv is None else list(argv)
    saved = [(a, a.default) for a in parser._actions]
    try:
        for a in parser._actions:
            a.default = argparse.SUPPRESS
        ns, _ = parser.parse_known_args(argv)
        return set(vars(ns))
    finally:
        for a, d in saved:
            a.default = d


def parse_eval_scales(spec) -> tuple:
    """'0.9,1.0,1.1' -> (0.9, 1.0, 1.1); sequences pass through."""
    if isinstance(spec, str):
        parts = [p for p in spec.replace(";", ",").split(",") if p.strip()]
        scales = tuple(float(p) for p in parts)
    else:
        scales = tuple(float(s) for s in spec)
    if not scales or any(s <= 0 for s in scales):
        raise ValueError(f"eval scales must be positive: {spec!r}")
    return scales


def merge_cli_overrides(cfg: Config, args, parser: argparse.ArgumentParser,
                        argv=None) -> Config:
    """Apply the explicit data and eval flags onto a checkpoint's config.

    evaluate and infer rebuild ``cfg`` from the checkpoint's config.json;
    every data flag given on the command line (``--data-dir``,
    ``--data-source``, ``--canvas-size``, ``--warp-method``, ``--workers``)
    and ``--batch-size``, ``--flip-eval`` and ``--eval-scales`` land in it.
    ``--data-dir`` without ``--data-source`` resets the source to ``auto``,
    so the layout is detected again at the new place.
    """
    import dataclasses

    explicit = explicit_cli_args(parser, argv)

    def changed(name: str) -> bool:
        return name in explicit and hasattr(args, name)

    data_fields = {"data_dir": "data_dir", "data_source": "source",
                   "canvas_size": "canvas_size", "warp_method": "warp_method",
                   "workers": "workers"}
    data_kw = {field: getattr(args, arg)
               for arg, field in data_fields.items() if changed(arg)}
    if "data_dir" in data_kw and "source" not in data_kw:
        data_kw["source"] = "auto"
    if data_kw:
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, **data_kw))
    train_kw = {}
    if getattr(args, "batch_size", 0):
        train_kw["batch_size"] = args.batch_size
    if getattr(args, "flip_eval", False):
        train_kw["flip_eval"] = True
    if changed("eval_scales"):
        train_kw["eval_scales"] = parse_eval_scales(args.eval_scales)
    if train_kw:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **train_kw))
    return cfg


def experiment_dir(cfg: Config) -> str:
    exp = cfg.train.experiment_id
    if not exp:
        import time

        exp = time.strftime("%Y%m%d-%H%M%S")
    return os.path.join(cfg.train.out_dir, exp)


def make_datasets(cfg: Config):
    """``(train_ds, val_ds)`` from the config: MPII (packed when the archive
    is there) or the synthetic fixture."""
    src = cfg.data.source
    if src == "auto":
        has_mpii = any(
            os.path.exists(os.path.join(cfg.data.data_dir, p))
            for p in ("annot", "annot.h5", "train.h5"))
        src = "h5" if has_mpii else "synthetic"
    if src == "h5":
        from ..data.pack import PackedDataset, packed_available

        canvas = cfg.data.canvas_size or 384
        packed = os.path.join(cfg.data.data_dir, "packed")

        def split(name):
            if packed_available(cfg.data.data_dir, name):
                return PackedDataset(packed, name)
            return MPIIDataset(cfg.data.data_dir, name, canvas_size=canvas)

        train_ds, val_ds = split("train"), split("val")
        _surface_split_provenance(val_ds)
        return train_ds, val_ds
    n = cfg.data.synthetic_size
    canvas = cfg.data.canvas_size or 96
    return (ArrayDataset(make_synthetic_mpii(n, canvas_size=canvas, seed=1)),
            ArrayDataset(make_synthetic_mpii(max(n // 4, 8), canvas_size=canvas,
                                             seed=2)))


def _surface_split_provenance(val_ds):
    """Say which method built the val split: PCKh numbers are comparable to
    published (Tompson-split) results only for a --val-list h5."""
    method = dataset_split_method(val_ds)
    if method.startswith("hash-holdout"):
        print(f"NOTE: val split = {method} (data.prepare default), NOT the "
              "Tompson split; PCKh will not be comparable to published "
              "numbers. Rebuild with --val-list for parity.")
    elif method:
        print(f"val split: {method}")


def dataset_split_method(ds) -> str:
    """Split provenance of any dataset flavor ("" when unrecorded):
    MPIIDataset keeps it on its annotation table, PackedDataset in the
    archive's meta."""
    method = getattr(ds, "split_method", "")
    if not method:
        annot = getattr(ds, "annot", None)
        method = getattr(annot, "split_method", "") if annot is not None else ""
    return method or ""


def make_loaders(cfg: Config, train_ds, val_ds):
    """The train loader (shuffled, seeded) and the val loader (in order,
    every row once: the last batch padded with masked rows)."""
    workers = getattr(cfg.data, "workers", 1)
    train_loader = ShardedLoader(
        train_ds, cfg.train.batch_size, shuffle=True, seed=cfg.train.seed,
        workers=workers)
    val_loader = ShardedLoader(
        val_ds, cfg.train.batch_size, shuffle=False, drop_last=False,
        workers=workers)
    return train_loader, val_loader
