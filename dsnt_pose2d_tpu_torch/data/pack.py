"""Pack an MPII split into a memory-mapped canvas archive
(port of ``dsnt_pose2d_tpu/data/pack.py``, numpy on the host).

Host JPEG decode is the end-to-end bottleneck of training on real MPII on a
small host.  Packing computes every sample's fixed-size canvas once:

    python -m dsnt_pose2d_tpu_torch.data.pack --data-dir data/mpii --subset train

writes ``<data_dir>/packed/<subset>_canvases.npy`` (uint8 ``(N, C, C, 3)``,
memory-mappable) and ``<subset>_meta.npz`` (coords, mask, head length,
affines, margin, split provenance).  :class:`PackedDataset` serves a sample
as an mmap slice: no decode, no resize.  :class:`AutoPackDataset` writes the
same archive as a side effect of streaming the decode-backed split once
(the Trainer's auto-pack).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

CANVAS_FILE = "{subset}_canvases.npy"
META_FILE = "{subset}_meta.npz"


def pack_split(data_dir: str, subset: str, canvas_size: int = 384,
               canvas_margin: float = 1.5, out_dir: str | None = None,
               workers: int = 0) -> str:
    """Compute every canvas of a split; returns the output directory."""
    from .mpii import MPIIDataset

    ds = MPIIDataset(data_dir, subset, canvas_size=canvas_size,
                     canvas_margin=canvas_margin)
    out_dir = out_dir or os.path.join(data_dir, "packed")
    os.makedirs(out_dir, exist_ok=True)
    n = len(ds)

    canvases = np.lib.format.open_memmap(
        os.path.join(out_dir, CANVAS_FILE.format(subset=subset)), mode="w+",
        dtype=np.uint8, shape=(n, canvas_size, canvas_size, 3))
    coords = np.zeros((n, 16, 2), np.float32)
    mask = np.zeros((n, 16), np.float32)
    head = np.zeros((n,), np.float32)
    affines = np.zeros((n, 3, 3), np.float32)
    margins = np.zeros((n,), np.float32)

    def fill(i):
        s = ds[i]
        canvases[i] = s["canvases"]
        coords[i] = s["coords_px"]
        mask[i] = s["mask"]
        head[i] = s["head_length"]
        affines[i] = s["canvas_from_orig"]
        margins[i] = s["canvas_margin"]

    if workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(fill, range(n)))
    else:
        for i in range(n):
            fill(i)

    canvases.flush()
    # Split provenance rides along, so that evaluate/infer on the packed
    # path stamp it too (a hash-holdout split is not Tompson-comparable).
    split_method = getattr(getattr(ds, "annot", None), "split_method", "")
    np.savez(os.path.join(out_dir, META_FILE.format(subset=subset)),
             coords_px=coords, mask=mask, head_length=head,
             canvas_from_orig=affines, canvas_margin=margins,
             split_method=np.array(split_method or ""))
    return out_dir


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


class AutoPackDataset:
    """Pack-as-you-stream: every decoded sample is also written into an
    archive under construction.

    Each ``__getitem__`` returns the sample and writes it into ``*.building``
    files, which :meth:`finalize` renames into place, so the Trainer can
    swap to :class:`PackedDataset` (and, per ``device_resident``, to the
    resident steps) from epoch 1 on.

    The loader's fetch threads write distinct rows (a row written twice by
    the tail padding gets the same bytes), and ``done`` is one byte flag per
    row: no lock is needed.
    """

    def __init__(self, inner, out_dir: str, subset: str = "train"):
        self.inner = inner
        self.out_dir = out_dir
        self.subset = subset
        os.makedirs(out_dir, exist_ok=True)
        n = len(inner)
        cs = int(inner.canvas_size)
        self._canvas_path = os.path.join(out_dir,
                                         CANVAS_FILE.format(subset=subset))
        self._meta_path = os.path.join(out_dir,
                                       META_FILE.format(subset=subset))
        self.canvases = np.lib.format.open_memmap(
            self._canvas_path + ".building", mode="w+", dtype=np.uint8,
            shape=(n, cs, cs, 3))
        self.coords = np.zeros((n, 16, 2), np.float32)
        self.mask = np.zeros((n, 16), np.float32)
        self.head = np.zeros((n,), np.float32)
        self.affines = np.zeros((n, 3, 3), np.float32)
        self.margins = np.zeros((n,), np.float32)
        self.done = np.zeros(n, np.uint8)

    # Split provenance keeps flowing through the wrapper (PCKh tables stamp
    # it: cli.common.dataset_split_method).
    @property
    def annot(self):
        return getattr(self.inner, "annot", None)

    @property
    def split_method(self) -> str:
        return getattr(self.inner, "split_method", "")

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i: int) -> dict:
        s = self.inner[i]
        if not self.done[i]:
            self.canvases[i] = s["canvases"]
            self.coords[i] = s["coords_px"]
            self.mask[i] = s["mask"]
            self.head[i] = s["head_length"]
            self.affines[i] = s["canvas_from_orig"]
            self.margins[i] = s["canvas_margin"]
            self.done[i] = 1
        return s

    def finalize(self) -> str:
        """Fill the rows the epoch never fetched (drop_last tails), then
        publish.  Returns the packed directory, ready for
        :class:`PackedDataset`."""
        for i in np.flatnonzero(self.done == 0):
            self[int(i)]
        self.canvases.flush()
        annot = getattr(self.inner, "annot", None)
        split_method = (getattr(self.inner, "split_method", "")
                        or getattr(annot, "split_method", "") or "")
        np.savez(self._meta_path + ".building", coords_px=self.coords,
                 mask=self.mask, head_length=self.head,
                 canvas_from_orig=self.affines, canvas_margin=self.margins,
                 split_method=np.array(split_method))
        # np.savez appends .npz to a bare path.
        os.rename(self._meta_path + ".building.npz", self._meta_path)
        os.rename(self._canvas_path + ".building", self._canvas_path)
        return self.out_dir


def packed_available(data_dir: str, subset: str) -> bool:
    p = os.path.join(data_dir, "packed")
    return (os.path.exists(os.path.join(p, CANVAS_FILE.format(subset=subset)))
            and os.path.exists(os.path.join(p, META_FILE.format(subset=subset))))


def main(argv=None):
    p = argparse.ArgumentParser("dsnt-pose2d-tpu-torch pack")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--subset", default="train",
                   choices=["train", "val", "test"])
    p.add_argument("--canvas-size", type=int, default=384)
    p.add_argument("--canvas-margin", type=float, default=1.5)
    p.add_argument("--workers", type=int, default=0)
    args = p.parse_args(argv)
    out = pack_split(args.data_dir, args.subset, args.canvas_size,
                     args.canvas_margin, workers=args.workers)
    print(f"packed {args.subset} -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
