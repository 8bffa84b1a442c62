"""The port's dress rehearsal (``dsnt_pose2d_tpu_torch/tools/dress_rehearsal.py``)
against the JAX tool's (``tools/dress_rehearsal.py``) on the CPU.

- ``fabricate`` with seed 0 and 4 images, plain, ``--hard`` and
  ``--lr-ambiguous``: the same JPEG bytes, the same ``.mat`` data (the
  bytes after the file's 128-byte header, which carries the time it was
  written) and the same val list as the JAX tool's.
- The port's whole chain at a tiny size: fabricate -> prepare -> pack ->
  loader bench -> train (one epoch; the CLIs in this process, the model cut
  to hg1 at 16 features and a 64-px input by flags appended to the train
  CLI's argv) -> evaluate -> infer (``.h5`` and ``.mat``).  The report has
  the keys of ``docs/dress_rehearsal_report.json`` (one epoch's rate in
  place of three, plus the keys the JAX tool has written since that record:
  ``hard``, ``lr_ambiguous`` and ``preds_split_method``), and the preds
  file carries the val list's provenance.
"""

import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch

from dsnt_pose2d_tpu_torch import native
from dsnt_pose2d_tpu_torch.tools import ablation_common, dress_rehearsal

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--hg-features", "16", "--input-size", "64", "--dtype", "float32",
        "--workers", "1"]


@pytest.fixture(scope="module")
def jax_dress():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_dress_rehearsal", ROOT / "tools" / "dress_rehearsal.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted((root / "images").iterdir())}


@pytest.mark.parametrize("flags", [{}, {"hard": True}, {"lr_ambiguous": True}],
                         ids=["plain", "hard", "lr_ambiguous"])
def test_fabricate_writes_the_jax_tools_bytes(flags, jax_dress, tmp_path):
    got = dress_rehearsal.fabricate(str(tmp_path / "t"), 4, seed=0, **flags)
    exp = jax_dress.fabricate(str(tmp_path / "j"), 4, seed=0, **flags)
    for key in ("images", "hard", "lr_ambiguous", "val_persons"):
        assert got[key] == exp[key], key
    assert set(got) == set(exp)
    t, j = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert list(t) == list(j) and len(t) == 4
    for name in t:
        assert t[name] == j[name], name
    mat_t = (tmp_path / "t" / "release.mat").read_bytes()
    mat_j = (tmp_path / "j" / "release.mat").read_bytes()
    assert len(mat_t) == len(mat_j) and mat_t[128:] == mat_j[128:]
    assert (tmp_path / "t" / "val_list.txt").read_text() == \
        (tmp_path / "j" / "val_list.txt").read_text()


def test_whole_chain_on_cpu(monkeypatch, tmp_path):
    def tiny(argv, timeout=None):
        if argv[2].endswith("cli.train"):
            argv = [*argv, *TINY]
        return ablation_common.run_in_process(argv, timeout)

    monkeypatch.setattr(ablation_common, "run", tiny)
    root = tmp_path / "dress"
    assert dress_rehearsal.main(["--root", str(root), "--n-images", "16",
                                 "--epochs", "1", "--batch-size", "2",
                                 "--device", "cpu"]) == 0
    report = json.loads((root / "report.json").read_text())
    doc = json.loads((ROOT / "docs" / "dress_rehearsal_report.json").read_text())
    expected = (set(doc) - {"train_img_s_epoch1", "train_img_s_epoch2"}
                | {"hard", "lr_ambiguous", "preds_split_method"})
    if not native.available():
        expected -= {k for k in doc if k.startswith("loader_native")}
    assert set(report) == expected
    assert report["images"] == 16 and report["preds_h5"] and report["preds_mat"]
    assert report["preds_split_method"].startswith("val-list")
    assert any(line.strip().startswith("total") for line in report["evaluate_tail"])
    assert report["train_img_s_epoch0"] > 0
    assert report["loader_packed_img_s_w1"] > 0


def test_a_stage_without_its_module_names_the_stage(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "h5py", None)    # import raises
    with pytest.raises(ImportError, match="stage 'prepare' needs h5py"):
        dress_rehearsal.run_prepare(str(tmp_path))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="stage 'fabricate' needs PIL"):
        dress_rehearsal.fabricate(str(tmp_path), 1)
