"""The host data path: the MPII reader, the native canvas decoder, the packer
(``pack_split``, ``AutoPackDataset``) and ``prepare``, the port against the
JAX package on the same files.

A tiny MPII layout is built here the way ``tests/test_pack.py::mini_mpii``
builds it (random JPEGs written with PIL, h5 annotations), and a fake
release ``.mat`` with ``tests/test_prepare.py::_fake_release_mat``.  Every
comparison is exact: the same decoders run on the same bytes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
pytest.importorskip("scipy")

from dsnt_pose2d_tpu import native as jnative
from dsnt_pose2d_tpu.data import mpii as jmpii
from dsnt_pose2d_tpu.data import pack as jpack
from dsnt_pose2d_tpu.data import prepare as jprepare
from dsnt_pose2d_tpu_torch import native
from dsnt_pose2d_tpu_torch.data import mpii, pack, prepare
from dsnt_pose2d_tpu_torch.data.loader import ShardedLoader
from test_native import _numpy_crop_resize
from test_prepare import _fake_release_mat

KEYS = ("canvases", "coords_px", "mask", "head_length", "canvas_from_orig",
        "canvas_margin")
N = 6


def _write_layout(base, layout: str, rng, n=N, split_method=""):
    """A tiny MPII layout: ``n`` random JPEGs (one PNG when ``layout`` is
    'png') and the train annotations in one of the three h5 layouts."""
    from PIL import Image

    (base / "images").mkdir(parents=True)
    names = []
    for i in range(n):
        img = rng.integers(0, 255, size=(150, 180, 3), dtype=np.uint8)
        name = f"p{i}.png" if layout == "png" and i == 1 else f"p{i}.jpg"
        Image.fromarray(img).save(base / "images" / name, quality=92)
        names.append(name.encode())
    fields = {"imgname": np.asarray(names),
              "center": np.tile([90.0, 75.0], (n, 1)) + rng.uniform(-9, 9, (n, 2)),
              "scale": rng.uniform(0.35, 0.55, n),
              "part": rng.uniform(40, 140, size=(n, 16, 2)),
              "visible": (rng.uniform(size=(n, 16)) > 0.2).astype(np.float64),
              "normalize": rng.uniform(18, 26, n)}
    if layout == "annot.h5":
        path, group = base / "annot.h5", "train"
    elif layout == "flat":
        path, group = base / "train.h5", None
    else:
        (base / "annot").mkdir()
        path, group = base / "annot" / "train.h5", None
    with h5py.File(path, "w") as f:
        g = f.create_group(group) if group else f
        for k, v in fields.items():
            g.create_dataset(k, data=v)
        if split_method:
            f.attrs["split_method"] = split_method
    return str(base)


@pytest.fixture(scope="module")
def mini_mpii(tmp_path_factory):
    return _write_layout(tmp_path_factory.mktemp("mpii"), "annot/",
                         np.random.default_rng(9), split_method="hash-holdout:0.1")


def _assert_samples_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b) == sorted(KEYS)
    for k in KEYS:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("layout", ["annot/", "flat", "annot.h5"])
def test_load_annotations_matches_jax(tmp_path, layout):
    base = _write_layout(tmp_path, layout, np.random.default_rng(1),
                         split_method="val-list:tompson.txt")
    got = mpii.load_annotations(base, "train")
    exp = jmpii.load_annotations(base, "train")
    assert got.imgnames == exp.imgnames and len(got) == len(exp) == N
    for k in ("centers", "scales", "parts", "visible", "head_lengths"):
        x, y = getattr(got, k), getattr(exp, k)
        assert x.dtype == y.dtype == np.float32, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert got.split_method == exp.split_method == "val-list:tompson.txt"
    # A missing split: no file for it (KeyError from the shared annot.h5),
    # in both packages alike.
    errors = []
    for load in (mpii.load_annotations, jmpii.load_annotations):
        with pytest.raises((FileNotFoundError, KeyError)) as e:
            load(base, "val")
        errors.append(e.type)
    assert errors[0] is errors[1] is (
        KeyError if layout == "annot.h5" else FileNotFoundError)


def test_mpii_dataset_pil_path_matches_jax(mini_mpii, monkeypatch):
    monkeypatch.delenv("DSNT_NATIVE_DECODE", raising=False)
    got = mpii.MPIIDataset(mini_mpii, "train", canvas_size=64)
    exp = jmpii.MPIIDataset(mini_mpii, "train", canvas_size=64)
    assert not got._use_native()
    assert (len(got), got.images_dir, got.subset) == (len(exp), exp.images_dir, "train")
    for i in range(N):
        _assert_samples_equal(got[i], exp[i])


def test_h5py_and_pil_fail_with_their_import_error(mini_mpii, monkeypatch):
    # Where h5py or PIL is missing (the card machine has neither), the
    # reader raises their import error; it takes no other path.
    ds = mpii.MPIIDataset(mini_mpii, "train", canvas_size=32, use_native=False)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        mpii.load_annotations(mini_mpii, "train")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        ds[0]


# -- native decoder -----------------------------------------------------------


def _has_jpeglib() -> bool:
    try:
        proc = subprocess.run([native._cxx(), "-E", "-x", "c++", "-"],
                              input="#include <jpeglib.h>\n", text=True,
                              capture_output=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return False
    return proc.returncode == 0


needs_jpeglib = pytest.mark.skipif(not _has_jpeglib(),
                                   reason="no jpeglib.h for the native build")


@needs_jpeglib
def test_native_builds_into_its_own_directory():
    assert native.available() and jnative.available()
    path = native.lib_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parent.name == "native"
    assert "dsnt_pose2d_tpu_torch" in path.parts


@needs_jpeglib
def test_native_decode_matches_reference_build(mini_mpii):
    from PIL import Image

    for i in (0, 3):
        with open(os.path.join(mini_mpii, "images", f"p{i}.jpg"), "rb") as f:
            data = f.read()
        got = native.decode_jpeg(data)
        np.testing.assert_array_equal(got, jnative.decode_jpeg(data))
        with Image.open(os.path.join(mini_mpii, "images", f"p{i}.jpg")) as img:
            np.testing.assert_array_equal(got, np.asarray(img.convert("RGB")))
        for args in [(10.0, 5.0, 120.0, 64), (-30.5, -12.25, 200.0, 48)]:
            np.testing.assert_array_equal(native.decode_crop_resize(data, *args),
                                          jnative.decode_crop_resize(data, *args))
    for bad in (b"not a jpeg at all", b""):
        with pytest.raises(ValueError):
            native.decode_jpeg(bad)
        with pytest.raises(ValueError):
            native.decode_crop_resize(bad, 0.0, 0.0, 10.0, 8)


@needs_jpeglib
def test_native_crop_resize_matches_reference_and_numpy():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, size=(40, 50, 3), dtype=np.uint8)
    for args in [(5.0, 3.0, 30.0, 16), (-10.0, -5.0, 60.0, 32),
                 (20.5, 10.25, 15.5, 8), (0.0, 0.0, 40.0, 40)]:
        got = native.crop_resize(img, *args)
        np.testing.assert_array_equal(got, jnative.crop_resize(img, *args))
        # tests/test_native.py's bar: float rounding at exact .5 boundaries.
        diff = np.abs(got.astype(int) - _numpy_crop_resize(img, *args).astype(int))
        assert diff.max() <= 1
    assert native.crop_resize(np.full((8, 8, 3), 200, np.uint8),
                              -100.0, -100.0, 10.0, 4).max() == 0


@needs_jpeglib
def test_mpii_dataset_native_path_matches_jax(tmp_path, monkeypatch):
    # DSNT_NATIVE_DECODE=1: the native path in both packages; the PNG row is
    # refused by the native decoder and read by PIL in both.
    base = _write_layout(tmp_path, "png", np.random.default_rng(3))
    monkeypatch.setenv("DSNT_NATIVE_DECODE", "1")
    got = mpii.MPIIDataset(base, "train", canvas_size=48)
    exp = jmpii.MPIIDataset(base, "train", canvas_size=48)
    pil = mpii.MPIIDataset(base, "train", canvas_size=48, use_native=False)
    assert got._use_native() and exp._use_native()
    for i in range(N):
        _assert_samples_equal(got[i], exp[i])
    _assert_samples_equal(got[1], pil[1])
    assert not np.array_equal(got[0]["canvases"], pil[0]["canvases"])


# -- packer -------------------------------------------------------------------


def _archive(out_dir, subset="train"):
    with open(os.path.join(out_dir, pack.CANVAS_FILE.format(subset=subset)), "rb") as f:
        canvas_bytes = f.read()
    with np.load(os.path.join(out_dir, pack.META_FILE.format(subset=subset))) as m:
        meta = {k: m[k] for k in m.files}
    return canvas_bytes, meta


def _assert_archives_equal(a, b):
    assert a[0] == b[0]                          # the .npy, byte for byte
    assert sorted(a[1]) == sorted(b[1])
    for k in a[1]:
        assert a[1][k].dtype == b[1][k].dtype, k
        np.testing.assert_array_equal(a[1][k], b[1][k], err_msg=k)


@pytest.mark.parametrize("workers", [0, 3])
def test_pack_split_matches_jax(mini_mpii, tmp_path, workers):
    got = pack.pack_split(mini_mpii, "train", canvas_size=64,
                          out_dir=str(tmp_path / "t"), workers=workers)
    exp = jpack.pack_split(mini_mpii, "train", canvas_size=64,
                           out_dir=str(tmp_path / "j"), workers=workers)
    _assert_archives_equal(_archive(got), _archive(exp))
    packed = pack.PackedDataset(got, "train")
    assert packed.split_method == "hash-holdout:0.1"
    raw = mpii.MPIIDataset(mini_mpii, "train", canvas_size=64)
    for i in range(N):
        _assert_samples_equal(packed[i], raw[i])


def test_pack_main_writes_beside_the_layout(tmp_path):
    base = _write_layout(tmp_path / "mpii", "annot/", np.random.default_rng(5))
    assert not pack.packed_available(base, "train")
    assert pack.main(["--data-dir", base, "--canvas-size", "32"]) == 0
    assert pack.packed_available(base, "train")
    assert pack.PackedDataset(os.path.join(base, "packed"), "train").canvases.shape == (
        N, 32, 32, 3)


def test_autopack_finalize_publishes_the_source(mini_mpii, tmp_path):
    raw = mpii.MPIIDataset(mini_mpii, "train", canvas_size=64)
    ap = pack.AutoPackDataset(raw, str(tmp_path / "t"), subset="train")
    jap = jpack.AutoPackDataset(jmpii.MPIIDataset(mini_mpii, "train", canvas_size=64),
                                str(tmp_path / "j"), subset="train")
    assert (ap.split_method, ap.annot) == ("", raw.annot)
    # One drop_last epoch at batch 4 on 3 fetch threads sees 4 of the 6 rows.
    loader = ShardedLoader(ap, 4, shuffle=True, seed=0, workers=3)
    assert len(list(loader.epoch(0))) == 1
    assert int(ap.done.sum()) == 4
    canvas = os.path.join(str(tmp_path / "t"), pack.CANVAS_FILE.format(subset="train"))
    assert not os.path.exists(canvas) and os.path.exists(canvas + ".building")
    assert ap.finalize() == str(tmp_path / "t") and jap.finalize()
    assert os.path.exists(canvas) and not os.path.exists(canvas + ".building")
    _assert_archives_equal(_archive(str(tmp_path / "t")), _archive(str(tmp_path / "j")))
    packed = pack.PackedDataset(str(tmp_path / "t"), "train")
    assert packed.split_method == "hash-holdout:0.1"
    for i in range(N):
        _assert_samples_equal(packed[i], raw[i])


# -- prepare ------------------------------------------------------------------


def _h5_contents(path):
    with h5py.File(path, "r") as f:
        return ({k: np.asarray(f[k]) for k in f}, dict(f.attrs))


@pytest.mark.parametrize("split", ["hash-holdout", "val-list"])
def test_prepare_matches_jax(tmp_path, split, capsys):
    mat = str(tmp_path / "release.mat")
    _fake_release_mat(mat)
    kw = {"val_frac": 0.4}
    if split == "val-list":
        (tmp_path / "val.txt").write_text("img_0001.jpg 0\nimg_0004.jpg 0\n")
        kw = {"val_list": str(tmp_path / "val.txt")}
    prepare.prepare(mat, str(tmp_path / "t"), **kw)
    got_out = capsys.readouterr().out
    jprepare.prepare(mat, str(tmp_path / "j"), **kw)
    assert got_out == capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names and "train.h5" in names
    for name in names:
        got, exp = _h5_contents(tmp_path / "t" / name), _h5_contents(tmp_path / "j" / name)
        assert sorted(got[0]) == sorted(exp[0])
        for k in exp[0]:
            assert got[0][k].dtype == exp[0][k].dtype, k
            np.testing.assert_array_equal(got[0][k], exp[0][k], err_msg=k)
        assert got[1] == exp[1]
        assert got[1]["split_method"] == (
            "val-list:val.txt" if split == "val-list" else "hash-holdout:0.4")
    # The prepared layout reads back through the port's reader.
    annot = mpii.load_annotations(str(tmp_path / "t"), "train")
    assert annot.split_method == got[1]["split_method"] and len(annot) > 0


def test_prepare_main_and_hash_holdout_match_jax(tmp_path):
    mat = str(tmp_path / "release.mat")
    _fake_release_mat(mat, n_train=12, n_test=1)
    assert prepare.main(["--mat", mat, "--out", str(tmp_path / "annot"),
                         "--val-frac", "0.5"]) == 0
    assert sorted(os.listdir(tmp_path / "annot")) == ["test.h5", "train.h5", "val.h5"]
    for i in range(50):
        name = f"img_{i:04d}.jpg"
        for frac in (0.115, 0.5):
            assert prepare._hash_holdout(name, frac) == jprepare._hash_holdout(name, frac)
