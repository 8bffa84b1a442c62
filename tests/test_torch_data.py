"""The port's host data path against the JAX package's, on the CPU.

A packed archive is written once from a seed and read by both packages'
``PackedDataset``; both ``ShardedLoader``s must give the same batches (the
``(seed, epoch)`` permutation, the padding of the last batch and its zeroed
mask), and both ``ResidentTrainData``s the same index streams (the JAX one
on a 1-device mesh), all exactly.
"""

import numpy as np
import pytest
import torch

from dsnt_pose2d_tpu.data import loader as jloader
from dsnt_pose2d_tpu.data import pack as jpack
from dsnt_pose2d_tpu.data import resident as jresident
from dsnt_pose2d_tpu.parallel.mesh import make_mesh
from dsnt_pose2d_tpu_torch.data import loader, pack, resident

N, CANVAS, BATCH = 14, 12, 4


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """A 14-sample archive with random uint8 canvases and meta."""
    out = tmp_path_factory.mktemp("packed")
    rng = np.random.default_rng(3)
    np.save(out / pack.CANVAS_FILE.format(subset="train"),
            rng.integers(0, 256, (N, CANVAS, CANVAS, 3), dtype=np.uint8))
    np.savez(out / pack.META_FILE.format(subset="train"),
             coords_px=rng.uniform(0, CANVAS, (N, 16, 2)).astype(np.float32),
             mask=(rng.uniform(size=(N, 16)) > 0.2).astype(np.float32),
             head_length=rng.uniform(3, 6, (N,)).astype(np.float32),
             canvas_from_orig=rng.normal(size=(N, 3, 3)).astype(np.float32),
             canvas_margin=np.full((N,), 1.5, np.float32),
             split_method=np.array("seeded"))
    return str(out)


def test_packed_file_names_match():
    assert (pack.CANVAS_FILE, pack.META_FILE) == (jpack.CANVAS_FILE,
                                                  jpack.META_FILE)


def test_packed_dataset_samples_equal(packed):
    ours, theirs = pack.PackedDataset(packed, "train"), jpack.PackedDataset(packed, "train")
    assert len(ours) == len(theirs) == N
    assert ours.split_method == theirs.split_method == "seeded"
    for i in range(N):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")


def test_packed_available(packed, tmp_path):
    assert not pack.packed_available(str(tmp_path), "train")
    (tmp_path / "packed").symlink_to(packed)
    assert pack.packed_available(str(tmp_path), "train")
    assert pack.packed_available(str(tmp_path), "train") == \
        jpack.packed_available(str(tmp_path), "train")


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("seed", [0, 7])
def test_loader_batches_equal_jax(packed, seed, epoch, workers, drop_last):
    ds = pack.PackedDataset(packed, "train")
    kw = dict(shuffle=True, seed=seed, drop_last=drop_last, workers=workers)
    ours = loader.ShardedLoader(ds, BATCH, **kw)
    theirs = jloader.ShardedLoader(jpack.PackedDataset(packed, "train"), BATCH, **kw)
    assert ours.steps_per_epoch == theirs.steps_per_epoch == (3 if drop_last else 4)
    got, exp = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
    assert len(got) == len(exp) == ours.steps_per_epoch
    for a, b in zip(got, exp):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if not drop_last:      # 14 = 3 * 4 + 2: the last two rows are padding
        assert not got[-1]["mask"][2:].any() and got[-1]["mask"][:2].any()


def test_loader_resumes_mid_epoch(packed):
    ds = pack.PackedDataset(packed, "train")
    ld = loader.ShardedLoader(ds, BATCH, shuffle=True, seed=1)
    full = list(ld.epoch(2))
    for a, b in zip(full[1:], ld.epoch(2, start_step=1)):
        np.testing.assert_array_equal(a["canvases"], b["canvases"])


def test_prefetch_to_device_keeps_order(packed):
    ds = pack.PackedDataset(packed, "train")
    ld = loader.ShardedLoader(ds, BATCH, shuffle=False)
    host = list(ld.epoch(0))
    moved = list(loader.prefetch_to_device(ld.epoch(0), "cpu", depth=2))
    assert len(moved) == len(host)
    for h, d in zip(host, moved):
        for k in h:
            assert isinstance(d[k], torch.Tensor)
            np.testing.assert_array_equal(d[k].numpy(), h[k])


def _resident_pair(packed, seed, batch=2):
    ours = resident.ResidentTrainData(pack.PackedDataset(packed, "train"), batch,
                                      "cpu", seed=seed)
    theirs = jresident.ResidentTrainData(jpack.PackedDataset(packed, "train"),
                                         batch, make_mesh(1), seed=seed)
    return ours, theirs


@pytest.mark.parametrize("epoch", [0, 3])
def test_resident_epoch_indices_equal_jax(packed, epoch):
    ours, theirs = _resident_pair(packed, seed=5)
    assert ours.steps_per_epoch == theirs.steps_per_epoch == 7
    got, exp = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
    assert len(got) == len(exp) == 7
    for a, b in zip(got, exp):
        assert a.dtype == torch.int64
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_resident_epoch_groups_equal_jax(packed):
    # 7 steps in groups of 3: two "multi" (3, B) stacks and a ragged tail of
    # one "single" step.
    ours, theirs = _resident_pair(packed, seed=9)
    got, exp = list(ours.epoch_groups(1, 3)), list(theirs.epoch_groups(1, 3))
    assert [k for k, _ in got] == [k for k, _ in exp] == ["multi", "multi", "single"]
    for (_, a), (_, b) in zip(got, exp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0][1].shape == (3, 2)


def test_resident_gathered_rows_equal_dataset_rows(packed):
    ds = pack.PackedDataset(packed, "train")
    rd = resident.ResidentTrainData(ds, 4, "cpu", seed=2)
    assert rd.resident["canvases"].dtype == torch.uint8
    assert rd.nbytes == resident.resident_nbytes(ds)
    for idx in rd.epoch(0):
        for pos, row in enumerate(idx.tolist()):
            sample = ds[rd.dataset_row(0, row)]
            for k, v in sample.items():
                np.testing.assert_array_equal(rd.resident[k][idx][pos].numpy(), v)


def test_resident_budget(packed, monkeypatch):
    ds = pack.PackedDataset(packed, "train")
    monkeypatch.setenv("DSNT_RESIDENT_BUDGET_BYTES", str(resident.resident_nbytes(ds)))
    assert resident.resident_fits(ds, "cpu")
    assert not resident.resident_fits(ds, "cpu", extra_nbytes=1)
    monkeypatch.delenv("DSNT_RESIDENT_BUDGET_BYTES")
    assert resident.resident_budget_bytes("cpu") > resident.resident_nbytes(ds)
    assert resident.resident_arrays(object()) is None
    with pytest.raises(ValueError, match="array-backed"):
        resident.ResidentTrainData(object(), 2, "cpu")
    with pytest.raises(ValueError, match="cannot fill"):
        resident.ResidentTrainData(ds, N + 1, "cpu")
