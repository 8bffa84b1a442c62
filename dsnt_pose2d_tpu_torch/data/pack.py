"""The packed canvas archive: memory-mapped uint8 canvases plus meta.

A copy of the reader side of ``dsnt_pose2d_tpu/data/pack.py`` (numpy only):
``<subset>_canvases.npy`` (uint8 ``(N, C, C, 3)``, memory-mappable) and
``<subset>_meta.npz`` (coords, mask, head length, affines, margin).
:class:`PackedDataset` serves a sample as an mmap slice: no decode, no
resize.  The JAX package's ``pack_split`` and ``AutoPackDataset`` need the
MPII reader and are not ported yet.
"""

from __future__ import annotations

import os

import numpy as np

CANVAS_FILE = "{subset}_canvases.npy"
META_FILE = "{subset}_meta.npz"


class PackedDataset:
    """mmap-backed canvas dataset: the zero-decode train-time reader."""

    def __init__(self, packed_dir: str, subset: str):
        self.canvases = np.load(
            os.path.join(packed_dir, CANVAS_FILE.format(subset=subset)),
            mmap_mode="r")
        meta = np.load(os.path.join(packed_dir, META_FILE.format(subset=subset)))
        self.meta = {k: meta[k] for k in meta.files}
        # "" for archives packed before provenance was recorded.
        self.split_method = str(self.meta.pop("split_method", ""))

    def __len__(self):
        return len(self.canvases)

    def __getitem__(self, i: int) -> dict:
        return {
            "canvases": np.asarray(self.canvases[i]),
            "coords_px": self.meta["coords_px"][i],
            "mask": self.meta["mask"][i],
            "head_length": self.meta["head_length"][i],
            "canvas_from_orig": self.meta["canvas_from_orig"][i],
            "canvas_margin": self.meta["canvas_margin"][i],
        }


def packed_available(data_dir: str, subset: str) -> bool:
    p = os.path.join(data_dir, "packed")
    return (os.path.exists(os.path.join(p, CANVAS_FILE.format(subset=subset)))
            and os.path.exists(os.path.join(p, META_FILE.format(subset=subset))))
