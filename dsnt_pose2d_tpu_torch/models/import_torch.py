"""Import torchvision ResNet weights into the port's ResNet backbone
(port of ``dsnt_pose2d_tpu/models/import_torch.py``).

A torchvision ``resnet{18,34,50,101}`` ``state_dict`` (or an ``.npz`` of
the same keys) maps onto :class:`.resnet.ResNetPose` under ``PoseNet``'s
``backbone.`` prefix; both layouts are OIHW, so only the names change:

    conv1.weight                 -> backbone.stem_conv.weight
    bn1.{weight,bias,running_*}  -> backbone.stem_bn.*
    layer{L}.{B}.conv{N}.weight  -> backbone.stage{L-1}_block{B}.conv{N}.weight
    layer{L}.{B}.bn{N}.*         -> backbone.stage{L-1}_block{B}.bn{N}.*
    layer{L}.{B}.downsample.0/1  -> proj / bn_proj
    fc.*                         -> dropped (the classifier is unused)

The score conv (and an fc head) keep their initialization; the blocks of a
truncated stage are skipped.  A missing key raises ``KeyError`` and a shape
mismatch ``ValueError``, so a partial import cannot pass silently.  No
torchvision is needed.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_BN_FIELDS = ("weight", "bias", "running_mean", "running_var")
_BLOCK = re.compile(r"^layer(\d+)\.(\d+)\.")
_PREFIX = "backbone."


def read_state_dict(path: str) -> dict:
    """A torchvision state dict from ``.npz`` (numpy) or a ``torch.save``
    file (``weights_only``)."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    return torch.load(path, map_location="cpu", weights_only=True)


def _torch_to_port_names(port_blocks: set, sd: dict) -> dict:
    """``{port key: torchvision key}`` for every tensor the import sets."""
    names = {f"{_PREFIX}stem_conv.weight": "conv1.weight"}
    names.update({f"{_PREFIX}stem_bn.{f}": f"bn1.{f}" for f in _BN_FIELDS})
    torch_blocks = sorted({(int(m.group(1)), int(m.group(2)))
                           for k in sd if (m := _BLOCK.match(k))})
    missing = port_blocks - {f"stage{l - 1}_block{b}" for l, b in torch_blocks}
    if missing:
        raise ValueError(
            f"state_dict does not cover model blocks {sorted(missing)}: wrong "
            "ResNet depth? (the import would be partial)")
    for layer, b in torch_blocks:
        block = f"stage{layer - 1}_block{b}"
        if block not in port_blocks:
            continue                                   # a truncated stage
        src, dst = f"layer{layer}.{b}", f"{_PREFIX}{block}"
        n = 1
        while f"{src}.conv{n}.weight" in sd:
            names[f"{dst}.conv{n}.weight"] = f"{src}.conv{n}.weight"
            names.update({f"{dst}.bn{n}.{f}": f"{src}.bn{n}.{f}"
                          for f in _BN_FIELDS})
            n += 1
        if f"{src}.downsample.0.weight" in sd:
            names[f"{dst}.proj.weight"] = f"{src}.downsample.0.weight"
            names.update({f"{dst}.bn_proj.{f}": f"{src}.downsample.1.{f}"
                          for f in _BN_FIELDS})
    return names


def load_torchvision_resnet(state_dict: dict, torchvision_sd) -> dict:
    """A new state dict: ``state_dict`` (a ResNet ``PoseNet``'s) with its
    backbone replaced by the torchvision weights."""
    sd = {k: v.detach().cpu() if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
          for k, v in dict(torchvision_sd).items()}
    port_blocks = {k[len(_PREFIX):].split(".")[0] for k in state_dict
                   if re.match(rf"{re.escape(_PREFIX)}stage\d+_block\d+\.", k)}
    out = dict(state_dict)
    for dst, src in _torch_to_port_names(port_blocks, sd).items():
        if dst not in out:
            raise KeyError(f"{src} maps to {dst}, which the model lacks")
        value = sd[src]
        if tuple(value.shape) != tuple(out[dst].shape):
            raise ValueError(f"{src}: shape {tuple(value.shape)} != "
                             f"{tuple(out[dst].shape)} of {dst}")
        out[dst] = value.to(out[dst].dtype).clone()
    return out
