"""MPII data preparation: official release .mat -> the annot h5 layout
(port of ``dsnt_pose2d_tpu/data/prepare.py``, numpy on the host).

The reference consumed a preprocessed HDF5 of the stacked-hourglass/Tompson
split (SURVEY.md C10).  This tool produces that layout from the official MPII
release (``mpii_human_pose_v1_u12_1.mat`` + the images directory), so users
coming from the reference can build the same ``annot/{train,val}.h5`` files:

    python -m dsnt_pose2d_tpu_torch.data.prepare \
        --mat mpii_human_pose_v1_u12_1.mat --out data/mpii/annot

Split: MPII ships train/test only; the community validation split (Tompson's
~2958 single-person samples) is reproduced from a ``--val-list`` file of
``imgname person_idx`` lines when provided, else a deterministic hash-based
~3k holdout of the train set (documented deviation — the exact Tompson list
is a separate download).

Per-sample fields written (all float32 unless noted):
    imgname   bytes      image file name
    center    (N, 2)     person center, original px
    scale     (N,)       person scale (box side = scale * 200 px)
    part      (N, 16, 2) joint (x, y), original px; 0 where unannotated
    visible   (N, 16)    1 visible / 0 not
    normalize (N,)       PCKh head size (0.6 x head-bbox diagonal, MPII rule)
"""

from __future__ import annotations

import argparse
import hashlib
import os

import numpy as np

NUM_JOINTS = 16
HEAD_SIZE_RATIO = 0.6  # MPII convention: headsize = 0.6 * head bbox diagonal


def _field(obj, name):
    """scipy mat_struct / ndarray tolerant field access."""
    if hasattr(obj, name):
        return getattr(obj, name)
    if hasattr(obj, "dtype") and obj.dtype.names and name in obj.dtype.names:
        return obj[name]
    raise KeyError(name)


def _as_list(x):
    x = np.atleast_1d(np.squeeze(np.asarray(x, dtype=object)))
    return list(x)


def parse_release(mat_path: str):
    """Yield per-person annotation dicts from the official release."""
    from scipy.io import loadmat

    release = loadmat(mat_path, squeeze_me=True, struct_as_record=False)["RELEASE"]
    annolist = _as_list(_field(release, "annolist"))
    img_train = np.atleast_1d(np.asarray(_field(release, "img_train"))).astype(int)

    for i, entry in enumerate(annolist):
        imgname = str(_field(_field(entry, "image"), "name"))
        is_train = bool(img_train[i])
        try:
            rects = _as_list(_field(entry, "annorect"))
        except (KeyError, AttributeError):
            continue
        for ridx, rect in enumerate(rects):
            if rect is None or isinstance(rect, np.ndarray) and rect.size == 0:
                continue
            try:
                scale = float(np.squeeze(_field(rect, "scale")))
                objpos = _field(rect, "objpos")
                cx = float(np.squeeze(_field(objpos, "x")))
                cy = float(np.squeeze(_field(objpos, "y")))
            except (KeyError, AttributeError, TypeError, ValueError):
                continue
            if not np.isfinite(scale) or scale <= 0:
                continue

            part = np.zeros((NUM_JOINTS, 2), np.float32)
            visible = np.zeros((NUM_JOINTS,), np.float32)
            if is_train:
                try:
                    points = _as_list(_field(_field(rect, "annopoints"), "point"))
                except (KeyError, AttributeError, TypeError):
                    continue
                for p in points:
                    j = int(np.squeeze(_field(p, "id")))
                    if not 0 <= j < NUM_JOINTS:
                        continue
                    part[j, 0] = float(np.squeeze(_field(p, "x")))
                    part[j, 1] = float(np.squeeze(_field(p, "y")))
                    try:
                        v = np.squeeze(_field(p, "is_visible"))
                        visible[j] = 1.0 if (v.size if hasattr(v, "size") else 1) and str(v) in ("1", "1.0", "True") else 0.0
                    except (KeyError, AttributeError):
                        visible[j] = 1.0
                    # Annotated joints count for training/eval masks even when
                    # occluded; is_visible only marks occlusion.
                    if part[j, 0] != 0 or part[j, 1] != 0:
                        visible[j] = max(visible[j], 1.0)

            # PCKh normalizer from the head rectangle.
            try:
                x1 = float(np.squeeze(_field(rect, "x1")))
                y1 = float(np.squeeze(_field(rect, "y1")))
                x2 = float(np.squeeze(_field(rect, "x2")))
                y2 = float(np.squeeze(_field(rect, "y2")))
                normalize = HEAD_SIZE_RATIO * float(np.hypot(x2 - x1, y2 - y1))
            except (KeyError, AttributeError, TypeError, ValueError):
                normalize = scale * 200.0 * 0.1  # fallback, flagged below

            yield {
                "imgname": imgname,
                "person": ridx,
                "is_train": is_train,
                "center": np.asarray([cx, cy], np.float32),
                "scale": np.float32(scale),
                "part": part,
                "visible": visible,
                "normalize": np.float32(normalize),
            }


def _hash_holdout(imgname: str, frac: float) -> bool:
    h = int(hashlib.sha1(imgname.encode()).hexdigest()[:8], 16)
    return (h % 10_000) < frac * 10_000


def write_h5(samples: list[dict], path: str, attrs: dict | None = None):
    import h5py

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset("imgname",
                         data=np.asarray([s["imgname"].encode() for s in samples]))
        for key in ("center", "scale", "part", "visible", "normalize"):
            f.create_dataset(key, data=np.stack([s[key] for s in samples]))
        for k, v in (attrs or {}).items():
            f.attrs[k] = v


def prepare(mat_path: str, out_dir: str, val_list: str | None = None,
            val_frac: float = 0.115):
    train, val, test = [], [], []
    val_keys = None
    if val_list:
        with open(val_list) as f:
            val_keys = {tuple(line.split()[:2]) for line in f if line.strip()}

    for s in parse_release(mat_path):
        if not s["is_train"]:
            test.append(s)
        elif val_keys is not None:
            key = (s["imgname"], str(s["person"]))
            (val if key in val_keys else train).append(s)
        elif _hash_holdout(s["imgname"], val_frac):
            val.append(s)
        else:
            train.append(s)

    # Stamp split provenance into the files: only a --val-list split is
    # comparable to the published (Tompson) PCKh numbers, and consumers
    # (train CLI) surface which method built the h5.
    split_method = (f"val-list:{os.path.basename(val_list)}" if val_list
                    else f"hash-holdout:{val_frac}")
    attrs = {"split_method": split_method,
             "source_mat": os.path.basename(mat_path)}
    for name, subset in (("train", train), ("val", val), ("test", test)):
        if subset:
            write_h5(subset, os.path.join(out_dir, f"{name}.h5"), attrs)
        print(f"{name}: {len(subset)} samples (split: {split_method})")


def main(argv=None):
    p = argparse.ArgumentParser("dsnt-pose2d-tpu-torch data prep")
    p.add_argument("--mat", required=True,
                   help="path to mpii_human_pose_v1_u12_1.mat")
    p.add_argument("--out", default="data/mpii/annot")
    p.add_argument("--val-list", default=None,
                   help="file of 'imgname person_idx' lines for the val split")
    p.add_argument("--val-frac", type=float, default=0.115,
                   help="hash-holdout val fraction when no --val-list given")
    args = p.parse_args(argv)
    prepare(args.mat, args.out, args.val_list, val_frac=args.val_frac)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
