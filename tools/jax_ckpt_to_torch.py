"""Convert a JAX run's checkpoints into the PyTorch port's layout.

The JAX package saves orbax ``CheckpointManager`` stores (``ckpt/``,
``ckpt_best/``, ``ckpt_step/``), each key a whole ``TrainState``; the port
(``dsnt_pose2d_tpu_torch``) reads ``state.pt`` + ``meta.json`` per key in
the same three stores.  This script, the one place where the two packages
meet outside ``tests/``:

1. reads ``config.json`` through the JAX package and builds the restore
   template with its ``create_train_state`` (abstractly, on one CPU device:
   a run saved under model parallelism restores whole);
2. restores every retained key of the three stores through the package's
   own ``CheckpointManager``, reading the source directory and writing
   nothing into it;
3. turns each state into numpy and maps it with
   ``dsnt_pose2d_tpu_torch.train.from_jax.state_payload_from_jax``
   (weights, BN statistics, the optimizer's moments, counts and step);
4. writes the port's layout under ``--out-dir``: the same keys, each with
   ``meta.json`` (``step`` from the state and ``step_in_epoch`` 0 where the
   JAX meta lacks them), and ``config.json``, ``best.json`` and
   ``metrics.jsonl`` copied verbatim, so both packages' model-version
   warnings still fire.

It prints one line per converted key and what the conversion cannot carry
(the JAX rng: the port draws by (seed, step)).  The port's ``cli.evaluate``,
``cli.infer`` and ``cli.train --resume`` then take ``--model-dir <out>``.

Usage: python tools/jax_ckpt_to_torch.py --model-dir <jax run> --out-dir <port run>
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # script lives in tools/; the packages at the root
    sys.path.insert(0, REPO)

STORES = ("ckpt", "ckpt_best", "ckpt_step")
COPIED = ("config.json", "best.json", "metrics.jsonl")


def restore_template(jcfg):
    """The abstract ``TrainState`` of ``jcfg`` placed on the first CPU
    device (no weights are initialised)."""
    import jax

    from dsnt_pose2d_tpu.models.factory import build_pose_model
    from dsnt_pose2d_tpu.train.state import create_train_state

    model = build_pose_model(jcfg.model)
    shapes = jax.eval_shape(
        lambda key: create_train_state(model, jcfg.optim, key),
        jax.random.PRNGKey(jcfg.train.seed))
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    return jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=cpu), shapes)


def _check_source(model_dir: str):
    if not os.path.isfile(os.path.join(model_dir, "config.json")):
        raise FileNotFoundError(f"no config.json in {model_dir}: not a JAX run "
                                "directory")
    missing = [s for s in STORES if not os.path.isdir(os.path.join(model_dir, s))]
    if missing:
        # The package's CheckpointManager would create them: a write into
        # the source.
        raise FileNotFoundError(f"{model_dir} has no {', '.join(missing)}: not "
                                "a JAX run directory (its CheckpointManager "
                                "makes all of " + ", ".join(STORES) + ")")


def convert(model_dir: str, out_dir: str, log=print) -> list[dict]:
    """Convert every retained key of ``model_dir``'s stores into
    ``out_dir``; returns one record per key (store, key, meta)."""
    import jax
    import orbax.checkpoint as ocp

    from dsnt_pose2d_tpu.train.checkpoint import CheckpointManager
    from dsnt_pose2d_tpu.utils import config as jconfig
    from dsnt_pose2d_tpu_torch.train.checkpoint import _Store
    from dsnt_pose2d_tpu_torch.train.from_jax import state_payload_from_jax
    from dsnt_pose2d_tpu_torch.utils import config as tconfig

    model_dir, out_dir = os.path.abspath(model_dir), os.path.abspath(out_dir)
    if out_dir == model_dir or out_dir.startswith(model_dir + os.sep):
        raise ValueError(f"--out-dir {out_dir} lies in the source {model_dir}")
    _check_source(model_dir)
    with open(os.path.join(model_dir, "config.json")) as f:
        text = f.read()
    jcfg, tcfg = jconfig.config_from_json(text), tconfig.config_from_json(text)
    ckpt = CheckpointManager(model_dir)
    try:
        stores = dict(zip(STORES, (ckpt.mgr, ckpt.best_mgr, ckpt.step_mgr)))
        keys = [(name, key) for name, mgr in stores.items()
                for key in mgr.all_steps()]
        if not keys:
            raise FileNotFoundError(f"no checkpoints in {model_dir} "
                                    f"({', '.join(STORES)} are empty)")
        template = restore_template(jcfg)
        # The port's stores, each keeping every key it is given (the JAX
        # run's retention already chose them).
        out = {name: _Store(os.path.join(out_dir, name), len(keys))
               for name in STORES}
        records, note = [], None
        for name, key in keys:
            restored = stores[name].restore(key, args=ocp.args.Composite(
                state=ocp.args.StandardRestore(template),
                meta=ocp.args.JsonRestore()))
            state = jax.device_get(restored["state"])
            payload, note = state_payload_from_jax(state, tcfg)
            meta = dict(restored["meta"])
            meta.setdefault("step", payload["step"])
            meta.setdefault("step_in_epoch", 0)
            meta.setdefault("metrics", {})
            out[name].save(key, payload, meta)
            records.append({"store": name, "key": key, "meta": meta})
            log(f"{name}/{key} -> {out[name].root}/{key}: epoch {meta['epoch']}, step "
                f"{meta['step']}, step_in_epoch {meta['step_in_epoch']}, "
                f"optimizer count {payload['count']}")
    finally:
        ckpt.close()
    for name in COPIED:
        if os.path.exists(os.path.join(model_dir, name)):
            shutil.copyfile(os.path.join(model_dir, name),
                            os.path.join(out_dir, name))
    log(f"note: {note}")
    return records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-dir", required=True,
                   help="the JAX run: config.json and its checkpoint stores")
    p.add_argument("--out-dir", required=True,
                   help="the port's run directory to write")
    args = p.parse_args(argv)
    import jax

    # One CPU device restores any run whole, TPU or model-parallel.
    jax.config.update("jax_platforms", "cpu")
    convert(args.model_dir, args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
