"""MPII dataset: annotations + images -> fixed-size host canvases
(port of ``dsnt_pose2d_tpu/data/mpii.py``, numpy on the host).

HDF5 annotations in the stacked-hourglass / Tompson train/val layout (per
sample: image name, person center, scale, 16 joint (x, y), visibility, head
length) plus JPEG images.  The host only decodes and resizes one square
person region to the *canvas*; every augmentation step runs on the device
(:mod:`.augment`).

Canvas construction: a square of side ``canvas_margin * scale * 200`` px
around the person center is resampled to ``canvas_size`` px, and the affine
``canvas_from_orig`` is recorded per sample, so predictions map back to
original-image pixels exactly.

Annotation layouts accepted: ``annot/<split>.h5``, ``<split>.h5``, or one
``annot.h5`` with a group per split; datasets ``imgname`` (bytes),
``center`` (N, 2), ``scale`` (N,), ``part`` (N, 16, 2), ``visible`` (N, 16),
``normalize`` (N,).

``h5py`` and PIL are imported where they are used: a machine without them
fails there, with their import error.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .transforms import MPII_SCALE_BOX_PX

TRAIN, VAL, TEST = "train", "val", "test"


@dataclass
class MPIIAnnotations:
    imgnames: list[str]
    centers: np.ndarray      # (N, 2)
    scales: np.ndarray       # (N,)
    parts: np.ndarray        # (N, 16, 2) original-image px, (x, y)
    visible: np.ndarray      # (N, 16)
    head_lengths: np.ndarray  # (N,)
    # Provenance stamped by data.prepare ('' for files built elsewhere):
    # 'val-list:<file>' (Tompson-comparable) or 'hash-holdout:<frac>'.
    split_method: str = ""

    def __len__(self):
        return len(self.imgnames)


def load_annotations(data_dir: str, subset: str) -> MPIIAnnotations:
    import h5py

    candidates = [
        os.path.join(data_dir, "annot", f"{subset}.h5"),
        os.path.join(data_dir, f"{subset}.h5"),
        os.path.join(data_dir, "annot.h5"),
    ]
    path = next((p for p in candidates if os.path.exists(p)), None)
    if path is None:
        raise FileNotFoundError(
            f"no MPII annotations for subset {subset!r} under {data_dir!r} "
            f"(tried {candidates})")
    with h5py.File(path, "r") as f:
        g = f[subset] if subset in f else f
        imgnames = [
            n.decode() if isinstance(n, bytes) else str(n)
            for n in np.asarray(g["imgname"])
        ]
        centers = np.asarray(g["center"], np.float32)
        scales = np.asarray(g["scale"], np.float32).reshape(-1)
        parts = np.asarray(g["part"], np.float32)
        visible = np.asarray(g["visible"], np.float32) if "visible" in g else \
            np.ones(parts.shape[:2], np.float32)
        head = np.asarray(g["normalize"], np.float32).reshape(-1) if "normalize" in g \
            else np.full((len(imgnames),), 60.0, np.float32)
        split_method = str(f.attrs.get("split_method", ""))
    return MPIIAnnotations(imgnames, centers, scales, parts, visible, head,
                           split_method)


class MPIIDataset:
    """Host-side MPII sample producer (decode + canvas resize only).

    ``__getitem__`` returns the canvas record that
    :func:`.augment.preprocess_batch` takes.  PIL decodes by default; the
    native decoder (:mod:`..native`) with ``use_native=True`` or
    ``DSNT_NATIVE_DECODE=1`` when it builds, and PIL again for a file that
    the native decoder rejects.
    """

    def __init__(self, data_dir: str, subset: str = TRAIN,
                 canvas_size: int = 384, canvas_margin: float = 1.5,
                 use_native: bool | None = None):
        self.data_dir = data_dir
        self.subset = subset
        self.canvas_size = canvas_size
        self.canvas_margin = canvas_margin
        self.annot = load_annotations(data_dir, subset)
        self.images_dir = os.path.join(data_dir, "images")
        self._native_pref = use_native

    def _use_native(self) -> bool:
        if self._native_pref is not None:
            return self._native_pref
        if os.environ.get("DSNT_NATIVE_DECODE", "") not in ("", "0"):
            from .. import native

            return native.available()
        return False

    def __len__(self):
        return len(self.annot)

    def __getitem__(self, i: int) -> dict:
        a = self.annot
        path = os.path.join(self.images_dir, a.imgnames[i])
        cx, cy = a.centers[i]
        box = float(a.scales[i]) * MPII_SCALE_BOX_PX * self.canvas_margin
        half = box / 2.0
        left, top, side = float(cx - half), float(cy - half), float(box)

        canvas = None
        if self._use_native():
            from .. import native

            try:
                with open(path, "rb") as f:
                    canvas = native.decode_crop_resize(
                        f.read(), left, top, side, self.canvas_size)
            except ValueError:
                canvas = None  # not a JPEG, or corrupt: PIL below
        if canvas is None:
            from PIL import Image

            img = Image.open(path).convert("RGB")
            li, ti, si = int(round(left)), int(round(top)), int(round(side))
            crop = img.crop((li, ti, li + si, ti + si))
            crop = crop.resize((self.canvas_size, self.canvas_size),
                               Image.BILINEAR)
            canvas = np.asarray(crop, np.uint8)
            left, top, side = float(li), float(ti), float(si)

        # Pixel-center affine of the crop/resize: output pixel ox samples
        # input x = left + (ox + 0.5) * side/S - 0.5, hence
        # x_canvas = s * x_orig + (0.5 * s - 0.5 - left * s),  s = S / side.
        s = self.canvas_size / side
        tx = 0.5 * s - 0.5 - left * s
        ty = 0.5 * s - 0.5 - top * s
        canvas_from_orig = np.asarray(
            [[s, 0, tx], [0, s, ty], [0, 0, 1]], np.float32)
        parts_canvas = a.parts[i] * s + np.asarray([tx, ty], np.float32)
        # Unannotated joints are stored as (0, 0) or negatives in the h5;
        # their visibility flag already masks them.
        return {
            "canvases": canvas,
            "coords_px": parts_canvas.astype(np.float32),
            "mask": a.visible[i].astype(np.float32),
            "head_length": np.float32(a.head_lengths[i]),
            "canvas_from_orig": canvas_from_orig,
            # The person box (scale * 200 px) fills the central
            # 1/canvas_margin of the canvas; the device crop maps that box
            # to the model input at scale_aug = 1.
            "canvas_margin": np.float32(self.canvas_margin),
        }


class ArrayDataset:
    """In-memory dict-of-arrays dataset (synthetic fixture or packed MPII)."""

    def __init__(self, arrays: dict):
        self.arrays = arrays
        self._n = len(next(iter(arrays.values())))

    def __len__(self):
        return self._n

    def __getitem__(self, i: int) -> dict:
        return {k: v[i] for k, v in self.arrays.items()}
