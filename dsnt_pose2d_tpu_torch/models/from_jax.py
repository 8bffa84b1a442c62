"""Map flax ``PoseNet`` / ``HourglassNet`` / ``ResNetPose`` / ``ViTPose``
variables onto the port's state dict.

The port's submodules carry the flax names, so the mapping is a walk over
the same tree with these layout changes: conv kernels HWIO -> OIHW; BN
``scale/bias`` + ``batch_stats{mean,var}`` -> ``weight/bias/running_mean/
running_var``; LayerNorm ``scale/bias`` -> ``weight/bias``; dense kernels
``(in, out)`` -> ``(out, in)``, the ViT's ``qkv`` kernel ``(D, 3, H, hd)``
flattened to ``(D, 3D)`` first (bias ``(3, H, hd)`` to ``(3D,)``).  The fc
head's ``fc_head_kernel`` (J, H*W, 2) and ``fc_head_bias`` (J, 2) keep
their names and layout.  The variables are nested dicts of numpy arrays
(``params``, and ``batch_stats`` where the model has BN; a ViT has none);
numpy only, so it needs no JAX at run time.  flax's ``nn.remat`` keeps the
module names, so variables of a model made with ``remat=True`` map the
same.  :func:`pose_net_from_jax` picks the walk by the config's base;
:func:`params_from_jax` walks a parameter-shaped tree alone (an optimizer's
moments), with the same transforms and no BN statistics.
"""

from __future__ import annotations

import numpy as np


def _conv(kernel) -> np.ndarray:
    """HWIO -> OIHW."""
    return np.ascontiguousarray(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


class _NoStats:
    """The batch statistics of a params-only walk: every lookup gives it
    back, and :func:`_put_bn` writes no running statistics for it."""

    def __getitem__(self, key):
        return self

    def get(self, key, default=None):
        return self


def _put_bn(out: dict, prefix: str, p: dict, bs: dict):
    out[f"{prefix}.weight"] = np.asarray(p["scale"])
    out[f"{prefix}.bias"] = np.asarray(p["bias"])
    if isinstance(bs, _NoStats):
        return
    out[f"{prefix}.running_mean"] = np.asarray(bs["mean"])
    out[f"{prefix}.running_var"] = np.asarray(bs["var"])
    out[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def _put_conv(out: dict, prefix: str, p: dict):
    out[f"{prefix}.weight"] = _conv(p["kernel"])
    if "bias" in p:
        out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _put_bottleneck(out: dict, prefix: str, p: dict, bs: dict):
    for i in (1, 2, 3):
        _put_bn(out, f"{prefix}.bn{i}", p[f"bn{i}"], bs[f"bn{i}"])
        _put_conv(out, f"{prefix}.conv{i}", p[f"conv{i}"])
    if "proj" in p:
        _put_conv(out, f"{prefix}.proj", p["proj"])


def _backbone(variables: dict):
    """``(params, batch_stats, key prefix)`` of the backbone: under
    ``backbone`` for a flax ``PoseNet`` (keys for the port's ``PoseNet``),
    else the variables themselves (keys for the bare backbone)."""
    p, bs = variables["params"], variables.get("batch_stats", {})
    if "backbone" in p:
        return p["backbone"], bs.get("backbone", {}), "backbone."
    return p, bs, ""


def hourglass_from_jax(variables: dict, num_stacks: int, depth: int = 4) -> dict:
    """flax variables -> state dict of numpy arrays.

    Accepts the variables of a flax ``PoseNet`` (hourglass under
    ``backbone``; keys come out prefixed ``backbone.`` for the port's
    ``PoseNet``) or of a bare ``HourglassNet`` (keys for the port's
    ``HourglassNet``).
    """
    p, bs, prefix = _backbone(variables)
    out: dict = {}
    _put_conv(out, "stem_conv", p["stem_conv"])
    _put_bn(out, "stem_bn", p["stem_bn"], bs["stem_bn"])
    for name in ("stem_res1", "stem_res2", "stem_res3"):
        _put_bottleneck(out, name, p[name], bs[name])
    for i in range(num_stacks):
        hp, hb = p[f"hg{i}"], bs[f"hg{i}"]
        for d in range(depth, 0, -1):
            for name in (f"up1_d{d}", f"low1_d{d}", f"low3_d{d}"):
                _put_bottleneck(out, f"hg{i}.{name}", hp[name], hb[name])
        _put_bottleneck(out, f"hg{i}.low2_d1", hp["low2_d1"], hb["low2_d1"])
        _put_bottleneck(out, f"post_res{i}", p[f"post_res{i}"],
                        bs[f"post_res{i}"])
        _put_conv(out, f"fc{i}_conv", p[f"fc{i}_conv"])
        _put_bn(out, f"fc{i}_bn", p[f"fc{i}_bn"], bs[f"fc{i}_bn"])
        _put_conv(out, f"score{i}", p[f"score{i}"])
        if i < num_stacks - 1:
            _put_conv(out, f"fc_back{i}", p[f"fc_back{i}"])
            _put_conv(out, f"score_back{i}", p[f"score_back{i}"])
    return {prefix + k: v for k, v in out.items()}


def resnet_from_jax(variables: dict) -> dict:
    """flax ``ResNetPose`` (or ``PoseNet`` over one) variables -> state dict
    of numpy arrays; the blocks are those the variables hold."""
    p, bs, prefix = _backbone(variables)
    out: dict = {}
    _put_conv(out, "stem_conv", p["stem_conv"])
    _put_bn(out, "stem_bn", p["stem_bn"], bs["stem_bn"])
    for name in sorted(k for k in p if k.startswith("stage")):
        for sub in p[name]:
            if sub.startswith("bn"):
                _put_bn(out, f"{name}.{sub}", p[name][sub], bs[name][sub])
            else:
                _put_conv(out, f"{name}.{sub}", p[name][sub])
    _put_conv(out, "score", p["score"])
    return {prefix + k: v for k, v in out.items()}


def _put_dense(out: dict, prefix: str, p: dict):
    kernel = np.asarray(p["kernel"])
    fan_in = kernel.shape[0]
    out[f"{prefix}.weight"] = np.ascontiguousarray(kernel.reshape(fan_in, -1).T)
    out[f"{prefix}.bias"] = np.asarray(p["bias"]).reshape(-1)


def _put_ln(out: dict, prefix: str, p: dict):
    out[f"{prefix}.weight"] = np.asarray(p["scale"])
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def vit_from_jax(variables: dict) -> dict:
    """flax ``ViTPose`` (or ``PoseNet`` over one) variables -> state dict of
    numpy arrays; the blocks are those the variables hold."""
    p, _, prefix = _backbone(variables)
    out: dict = {}
    for name in ("patch_embed", "up_proj", "refine", "score"):
        _put_conv(out, name, p[name])
    for name in ("pos_row", "pos_col"):
        out[name] = np.asarray(p[name])
    blocks = sorted((k for k in p if k.startswith("block")),
                    key=lambda k: int(k[len("block"):]))
    for name in blocks:
        for ln in ("ln1", "ln2"):
            _put_ln(out, f"{name}.{ln}", p[name][ln])
        for dense in ("qkv", "proj", "fc1", "fc2"):
            _put_dense(out, f"{name}.{dense}", p[name][dense])
    _put_ln(out, "ln_out", p["ln_out"])
    return {prefix + k: v for k, v in out.items()}


def pose_net_from_jax(variables: dict, cfg) -> dict:
    """flax ``PoseNet`` variables of ``cfg`` (a ``ModelConfig``) -> the
    port's ``PoseNet`` state dict, fc head included."""
    if cfg.base.startswith("hg"):
        out = hourglass_from_jax(variables, int(cfg.base[2:]), cfg.hg_depth)
    elif cfg.base.startswith("resnet"):
        out = resnet_from_jax(variables)
    elif cfg.base.startswith("vit"):
        out = vit_from_jax(variables)
    elif cfg.base.startswith("hrnet"):
        raise ValueError(f"the JAX package has no HRNet: {cfg.base!r} has no flax "
                         "variables to convert")
    else:
        raise ValueError(f"unknown base model {cfg.base!r}")
    for name in ("fc_head_kernel", "fc_head_bias"):
        if name in variables["params"]:
            out[name] = np.asarray(variables["params"][name])
    return out


def params_from_jax(params: dict, cfg) -> dict:
    """A tree shaped as the flax ``PoseNet``'s ``params`` of ``cfg`` (the
    parameters themselves, or an optimizer moment of them) -> the port's
    parameter names, each leaf under the transform of its parameter."""
    return pose_net_from_jax({"params": params, "batch_stats": _NoStats()}, cfg)
