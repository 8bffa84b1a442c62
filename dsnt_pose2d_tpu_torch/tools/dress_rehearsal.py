"""Scale dress rehearsal of the real-data path (port of
``tools/dress_rehearsal.py``).

Fabricates a realistic-sized MPII stand-in (thousands of JPEG images of
varying sizes + a release-layout ``.mat``), then drives the whole user
chain of the port as a user would:

    fabricate -> prepare (--val-list) -> pack -> loader bench
              -> train (hg2+DSNT+JS) -> evaluate (PCKh) -> infer (.h5/.mat)

Each person is a 16-joint MPII-convention stick figure rendered as
distinct-colored Gaussian blobs (the idea of data/synthetic.py, so joint
locations are learnable from pixels), placed on a textured background at a
random center/scale/rotation; ~15% of images carry two people to exercise
multi-rect parsing.  The renderer is the JAX tool's, line for line: the
same seed and flags write the same JPEG bytes and the same ``.mat`` arrays.

PIL and h5py are imported where a stage uses them (fabricate, prepare,
pack, loader and the ``.h5`` preds need them); a stage run without one
raises ``ImportError`` naming the stage.

Usage:
    python -m dsnt_pose2d_tpu_torch.tools.dress_rehearsal --root /tmp/dress \
        --n-images 5000 [--device cpu]
    python -m dsnt_pose2d_tpu_torch.tools.dress_rehearsal --root /tmp/dress \
        --stages fabricate,prepare
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

import numpy as np

from ..cli.common import add_device_arg
from ..device import resolve_device
from . import ablation_common

NUM_JOINTS = 16

# Canonical stick figure in person-box units (x right, y down), MPII ids:
# 0 r-ankle 1 r-knee 2 r-hip 3 l-hip 4 l-knee 5 l-ankle 6 pelvis 7 thorax
# 8 upper-neck 9 head-top 10 r-wrist 11 r-elbow 12 r-shoulder 13 l-shoulder
# 14 l-elbow 15 l-wrist
_SKELETON = np.array([
    [-0.12, 0.45], [-0.10, 0.22], [-0.08, 0.00], [0.08, 0.00], [0.10, 0.22],
    [0.12, 0.45], [0.00, 0.00], [0.00, -0.28], [0.00, -0.35], [0.00, -0.47],
    [-0.30, 0.05], [-0.25, -0.12], [-0.14, -0.27], [0.14, -0.27],
    [0.25, -0.12], [0.30, 0.05],
], np.float32)

_PALETTE = np.random.default_rng(20260816).uniform(
    0.5, 1.0, size=(NUM_JOINTS, 3)).astype(np.float32)

# Appearance-ambiguity palette: every L/R joint
# pair shares ONE color, so local appearance cannot tell left from right —
# only global skeleton context (which side of the figure) can.  Combined
# with --hard and flip augmentation this manufactures a genuinely
# MULTIMODAL per-joint posterior (mass at both the true joint and its
# contralateral twin), the mechanism the paper's regularizer table needs:
# an unregularized DSNT expectation averages the modes, while a
# distribution regularizer (JS/KL toward a compact unimodal Gaussian)
# forces commitment to one.
_LR_PAIRS = ((0, 5), (1, 4), (2, 3), (10, 15), (11, 14), (12, 13))
_PALETTE_LR = _PALETTE.copy()
for _r, _l in _LR_PAIRS:
    _PALETTE_LR[_l] = _PALETTE_LR[_r]


def _make_person(rng, img_w, img_h):
    """Random placement of the canonical skeleton; returns annotation dict."""
    scale = rng.uniform(0.6, 1.6)              # person box = 200*scale px
    box = 200.0 * scale
    cx = rng.uniform(0.3 * img_w, 0.7 * img_w)
    cy = rng.uniform(0.35 * img_h, 0.65 * img_h)
    theta = rng.uniform(-0.4, 0.4)
    rot = np.array([[np.cos(theta), -np.sin(theta)],
                    [np.sin(theta), np.cos(theta)]], np.float32)
    jitter = rng.normal(0, 0.02, size=(NUM_JOINTS, 2)).astype(np.float32)
    pts = (_SKELETON + jitter) @ rot.T * box + np.array([cx, cy], np.float32)
    visible = (rng.uniform(size=NUM_JOINTS) > 0.05).astype(np.float32)
    # Head rect around neck..head-top for the PCKh normalizer.
    head_c = 0.5 * (pts[8] + pts[9])
    head_r = max(float(np.linalg.norm(pts[9] - pts[8])), 8.0)
    return {
        "center": np.array([cx, cy], np.float32), "scale": float(scale),
        "pts": pts, "visible": visible,
        "head_rect": (head_c[0] - 0.5 * head_r, head_c[1] - 0.7 * head_r,
                      head_c[0] + 0.5 * head_r, head_c[1] + 0.7 * head_r),
    }


def _splat(img, x, y, sigma, color):
    img_h, img_w = img.shape[:2]
    r = int(3 * sigma)
    xi, yi = int(round(x)), int(round(y))
    x0, x1 = max(xi - r, 0), min(xi + r + 1, img_w)
    y0, y1 = max(yi - r, 0), min(yi + r + 1, img_h)
    if x0 >= x1 or y0 >= y1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
    blob = np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * sigma ** 2))
    img[y0:y1, x0:x1] = np.clip(
        img[y0:y1, x0:x1] + blob[..., None] * color, 0.0, 1.0)


def _render(rng, persons, img_w, img_h, hard: bool = False,
            lr_ambiguous: bool = False):
    """Paint joints as colored Gaussians; ``hard`` makes localization earn
    its PCKh instead of saturating:

    - blobs are ~2.5x smaller and dimmer (0.7x amplitude) on a noisier,
      higher-amplitude textured background — pixel evidence is weak;
    - every visible joint ALSO spawns 2-3 SAME-COLOR distractor blobs at
      MATCHED brightness placed INSIDE the person box, so per-color pixel
      evidence alone is genuinely ambiguous — only skeleton context (where
      joint j sits relative to the figure) identifies the true mode.  (A
      first cut used dim out-of-crop distractors; resnet34 still hit 99.07
      PCKh in 15 epochs — brightness was a trivial discriminator.)  Raw
      per-color heatmap responses are multimodal; an unregularized DSNT
      expectation is pulled toward spurious modes, while a distribution
      regularizer (JS/KL toward a compact unimodal Gaussian) forces the
      model to commit to one — the mechanism the paper's regularizer table
      measures.
    """
    palette = _PALETTE_LR if lr_ambiguous else _PALETTE
    bg_hi, tex, amp = (0.35, 0.12, 0.7) if hard else (0.25, 0.08, 1.0)
    img = rng.uniform(0.0, bg_hi, size=(img_h, img_w, 3)).astype(np.float32)
    # Low-frequency texture so JPEGs are not flat noise.
    gy = np.linspace(0, np.pi * rng.uniform(1, 4), img_h, dtype=np.float32)
    gx = np.linspace(0, np.pi * rng.uniform(1, 4), img_w, dtype=np.float32)
    img += tex * (np.sin(gy)[:, None] * np.cos(gx)[None, :])[..., None]
    for p in persons:
        sigma_frac = 0.014 if hard else 0.035
        sigma = max(200.0 * p["scale"] * sigma_frac, 2.0)
        box = 200.0 * p["scale"]
        cx, cy = p["center"]
        for j in range(NUM_JOINTS):
            if p["visible"][j] == 0:
                continue
            x, y = p["pts"][j]
            _splat(img, x, y, sigma, amp * palette[j])
            if hard:
                for _ in range(int(rng.integers(2, 4))):
                    # In-crop, brightness-matched: land within the person
                    # box but at least 4 sigma from the true joint so the
                    # GT mode stays well-defined.
                    for _try in range(8):
                        dx = rng.uniform(-0.55, 0.55) * box
                        dy = rng.uniform(-0.55, 0.55) * box
                        if (dx - (x - cx)) ** 2 + (dy - (y - cy)) ** 2 \
                                >= (4 * sigma) ** 2:
                            break
                    _splat(img, cx + dx, cy + dy, sigma,
                           rng.uniform(0.85, 1.0) * amp * palette[j])
    if hard:  # sensor-style noise on top of everything
        img += rng.normal(0.0, 0.03, size=img.shape).astype(np.float32)
        img = np.clip(img, 0.0, 1.0)
    return (img * 255).astype(np.uint8)


def fabricate(root: str, n_images: int, seed: int = 0, test_frac: float = 0.1,
              val_frac: float = 0.12, hard: bool = False,
              lr_ambiguous: bool = False) -> dict:
    """Images + release-layout .mat + Tompson-style val list."""
    _require("fabricate", "PIL", "scipy")
    from PIL import Image

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    annolist, img_train, val_lines = [], [], []
    t0 = time.time()
    for i in range(n_images):
        img_w = int(rng.integers(480, 961))
        img_h = int(rng.integers(360, 721))
        n_persons = 2 if rng.uniform() < 0.15 else 1
        persons = [_make_person(rng, img_w, img_h) for _ in range(n_persons)]
        name = f"dress_{i:06d}.jpg"
        is_train = rng.uniform() >= test_frac
        img = _render(rng, persons, img_w, img_h, hard=hard,
                      lr_ambiguous=lr_ambiguous)
        Image.fromarray(img).save(os.path.join(img_dir, name), quality=90)

        rects = []
        for p in persons:
            rect = {
                "scale": p["scale"],
                "objpos": {"x": float(p["center"][0]),
                           "y": float(p["center"][1])},
                "x1": p["head_rect"][0], "y1": p["head_rect"][1],
                "x2": p["head_rect"][2], "y2": p["head_rect"][3],
            }
            if is_train:
                rect["annopoints"] = {"point": np.array([
                    {"id": j, "x": float(p["pts"][j, 0]),
                     "y": float(p["pts"][j, 1]),
                     "is_visible": "1" if p["visible"][j] else "0"}
                    for j in range(NUM_JOINTS)], dtype=object)}
            rects.append(rect)
        annolist.append({"image": {"name": name},
                         "annorect": np.array(rects, dtype=object)})
        img_train.append(1 if is_train else 0)
        if is_train and rng.uniform() < val_frac:
            for ridx in range(n_persons):
                val_lines.append(f"{name} {ridx}")
        if (i + 1) % 500 == 0:
            print(f"  fabricate {i + 1}/{n_images} "
                  f"({(i + 1) / (time.time() - t0):.1f} img/s)", flush=True)

    from scipy.io import savemat

    mat_path = os.path.join(root, "release.mat")
    savemat(mat_path, {"RELEASE": {
        "annolist": np.array(annolist, dtype=object),
        "img_train": np.array(img_train),
    }})
    val_list = os.path.join(root, "val_list.txt")
    with open(val_list, "w") as f:
        f.write("\n".join(val_lines) + "\n")
    return {"images": n_images, "hard": hard, "lr_ambiguous": lr_ambiguous,
            "mat": mat_path,
            "val_list": val_list, "val_persons": len(val_lines),
            "fabricate_s": round(time.time() - t0, 1)}


def _require(stage: str, *modules: str):
    """Import ``modules`` or raise ``ImportError`` naming the stage."""
    for name in modules:
        try:
            importlib.import_module(name)
        except ImportError as e:
            raise ImportError(f"dress rehearsal stage {stage!r} needs "
                              f"{name}, which is not installed") from e


def run_prepare(root: str) -> dict:
    _require("prepare", "scipy", "h5py")
    from ..data.prepare import prepare

    t0 = time.time()
    prepare(os.path.join(root, "release.mat"),
            os.path.join(root, "annot"),
            val_list=os.path.join(root, "val_list.txt"))
    return {"prepare_s": round(time.time() - t0, 1)}


def run_pack(root: str, canvas_size: int = 384) -> dict:
    _require("pack", "h5py", "PIL")
    from ..data.pack import pack_split

    out = {}
    for subset in ("train", "val"):
        t0 = time.time()
        pack_split(root, subset, canvas_size=canvas_size)
        out[f"pack_{subset}_s"] = round(time.time() - t0, 1)
    return out


def bench_loader(root: str, batch: int = 32, max_batches: int = 40) -> dict:
    """Host input-pipeline throughput: packed mmap vs JPEG decode paths,
    each over loader threads in {1, 4, 8} (the native decoder's case is
    GIL-free multi-thread scaling, so single-thread numbers alone cannot
    judge it)."""
    _require("loader", "h5py", "PIL")
    from .. import native as native_mod
    from ..data.loader import ShardedLoader
    from ..data.mpii import MPIIDataset
    from ..data.pack import PackedDataset, packed_available

    out = {}

    def measure(ds, label, workers):
        loader = ShardedLoader(ds, batch, shuffle=True, seed=0,
                               drop_last=True, workers=workers)
        it = iter(loader.epoch(0))
        next(it)  # warm (open files, first faults, spin up the pool)
        t0 = time.time()
        n = 0
        for _, _b in zip(range(max_batches), it):
            n += batch
        dt = time.time() - t0
        out[f"{label}_w{workers}"] = round(n / dt, 1) if dt > 0 else float("inf")

    for workers in (1, 4, 8):
        if packed_available(root, "train"):
            measure(PackedDataset(os.path.join(root, "packed"), "train"),
                    "loader_packed_img_s", workers)
        if native_mod.available():
            measure(MPIIDataset(root, "train", use_native=True),
                    "loader_native_img_s", workers)
        measure(MPIIDataset(root, "train", use_native=False),
                "loader_pil_img_s", workers)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default="/tmp/dress_rehearsal")
    p.add_argument("--n-images", type=int, default=5000)
    p.add_argument("--hard", action="store_true",
                   help="non-saturating variant: small dim blobs + same-color"
                        " distractors + noise (for the regularizer ablation)")
    p.add_argument("--lr-ambiguous", action="store_true",
                   help="appearance-ambiguity variant: L/R joint pairs share "
                        "one color, so only skeleton context identifies the "
                        "side (manufactures a multimodal posterior; combine "
                        "with --hard for the regularizer ablation)")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--stages", default="all",
                   help="comma list: fabricate,prepare,pack,loader,train,"
                        "evaluate,infer")
    add_device_arg(p)
    args = p.parse_args(argv)
    stages = (args.stages.split(",") if args.stages != "all" else
              ["fabricate", "prepare", "pack", "loader", "train", "evaluate",
               "infer"])
    if {"train", "evaluate", "infer"} & set(stages):
        resolve_device(args.device)
    os.makedirs(args.root, exist_ok=True)
    report_path = os.path.join(args.root, "report.json")
    report = {}
    if os.path.exists(report_path):
        with open(report_path) as f:
            report = json.load(f)

    def save():
        with open(report_path, "w") as f:
            json.dump(report, f, indent=1)
        print(json.dumps(report), flush=True)

    def cli(name, *flags):
        return ablation_common.run(
            [sys.executable, "-m", f"dsnt_pose2d_tpu_torch.cli.{name}", *flags,
             "--device", args.device], timeout=7200)

    if "fabricate" in stages:
        print("== fabricate ==", flush=True)
        report.update(fabricate(args.root, args.n_images, hard=args.hard,
                                lr_ambiguous=args.lr_ambiguous))
        save()
    if "prepare" in stages:
        print("== prepare ==", flush=True)
        report.update(run_prepare(args.root))
        save()
    if "pack" in stages:
        print("== pack ==", flush=True)
        report.update(run_pack(args.root))
        save()
    if "loader" in stages:
        print("== loader bench ==", flush=True)
        report.update(bench_loader(args.root, batch=args.batch_size))
        save()

    model_dir = os.path.join(args.root, "out")
    if "train" in stages:
        print("== train (hg2 + DSNT + JS) ==", flush=True)
        t0 = time.time()
        out = cli("train", "--data-dir", args.root, "--data-source", "auto",
                  "--base-model", "hg2", "--output-strat", "dsnt",
                  "--reg", "js", "--reg-coeff", "1.0",
                  "--batch-size", str(args.batch_size),
                  "--epochs", str(args.epochs),
                  "--out-dir", model_dir, "--experiment-id", "dress")
        report["train_s"] = round(time.time() - t0, 1)
        report["train_tail"] = out.strip().splitlines()[-3:]
        metrics_file = os.path.join(model_dir, "dress", "metrics.jsonl")
        if os.path.exists(metrics_file):
            with open(metrics_file) as f:
                for line in f:
                    rec = json.loads(line)
                    if "images_per_sec" in rec:
                        report["train_img_s_epoch%d" % rec["epoch"]] = round(
                            rec["images_per_sec"], 1)
        save()
    if "evaluate" in stages:
        print("== evaluate ==", flush=True)
        out = cli("evaluate", "--model-dir", os.path.join(model_dir, "dress"),
                  "--data-dir", args.root)
        report["evaluate_tail"] = out.strip().splitlines()[-22:]
        save()
    if "infer" in stages:
        print("== infer ==", flush=True)
        preds = os.path.join(args.root, "preds.h5")
        _require("infer", "h5py")
        for path in (preds, preds.replace(".h5", ".mat")):
            cli("infer", "--model-dir", os.path.join(model_dir, "dress"),
                "--data-dir", args.root, "--subset", "val",
                "--preds-file", path)
        report["preds_h5"] = os.path.exists(preds)
        report["preds_mat"] = os.path.exists(preds.replace(".h5", ".mat"))
        if report["preds_h5"]:
            # The val split's provenance rides the preds file (the
            # rehearsal's --val-list split stamps "val-list:...").
            import h5py

            with h5py.File(preds) as f:
                report["preds_split_method"] = str(
                    f["preds"].attrs.get("split_method", ""))
        save()
    print("dress rehearsal complete")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
