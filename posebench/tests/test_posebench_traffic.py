"""The traffic and the inputs are a function of the seed."""

import numpy as np
import pytest
import torch

from posebench import harness, inputs
from posebench.generators.resident_train import epoch_rows


def test_records_follow_the_seed():
    a = inputs.make_split(6, 48, 11, "cpu")
    b = inputs.make_split(6, 48, 11, "cpu")
    c = inputs.make_split(6, 48, 12, "cpu")
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["canvases"], c["canvases"])
    assert a["canvases"].dtype == np.uint8 and a["canvases"].shape == (6, 48, 48, 3)
    assert a["coords_px"].shape == (6, 16, 2) and a["canvas_from_orig"].shape == (6, 3, 3)


def test_large_seeds():
    inputs.make_split(2, 16, 2 ** 31 + 12345, "cpu")
    assert epoch_rows(8, 2 ** 33 + 1, 0).shape == (8,)


def test_weights_follow_the_seed(tiny):
    cell = tiny("hg8-train-resident")
    calib = inputs.make_split(4, inputs.canvas_side(cell.config), 3, "cpu")
    made = cell.config_file["weights"]["made"]
    a = inputs.make_weights(cell.config, 5, calib, "cpu", **made)
    b = inputs.make_weights(cell.config, 5, calib, "cpu", **made)
    c = inputs.make_weights(cell.config, 6, calib, "cpu", **made)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["backbone.stem_conv.weight"], c["backbone.stem_conv.weight"])


def test_photo_request_sizes():
    w = harness.load_cell("hg8-serve-photos", 1, "cpu").traffic["size_weights"]
    block = harness.load_cell("hg8-serve-photos", 1, "cpu").traffic["size_block"]
    sizes = inputs.request_sizes(w, block, 3, 2 * block)
    # Each block holds n crops with P(n) proportional to 0.375^(n-1): a
    # geometric law with MPII's mean of 1.6 people an image, every size
    # present at least once.
    for one in sizes.reshape(2, block):
        counts = np.bincount(one, minlength=9)[1:]
        np.testing.assert_array_equal(counts, [1283, 480, 180, 67, 25, 9, 3, 1])
    assert sizes.mean() == pytest.approx(3259 / 2048)
    again = inputs.request_sizes(w, block, 3, 2 * block)
    other = inputs.request_sizes(w, block, 4, 2 * block)
    np.testing.assert_array_equal(sizes, again)
    assert not np.array_equal(sizes, other)
    np.testing.assert_array_equal(np.sort(sizes), np.sort(other))


def test_epoch_order_is_the_resident_splits():
    from dsnt_pose2d_tpu_torch.data.mpii import ArrayDataset
    from dsnt_pose2d_tpu_torch.data.resident import ResidentTrainData

    rows = {"canvases": np.zeros((40, 2, 2, 3), np.uint8), "mask": np.zeros((40, 16), np.float32)}
    data = ResidentTrainData(ArrayDataset(rows), 4, device="cpu", seed=2 ** 31 + 9)
    for epoch in (0, 3):
        got = np.concatenate([idx.numpy().reshape(-1)
                              for _, idx in data.epoch_groups(epoch, 2)])
        np.testing.assert_array_equal(got, epoch_rows(40, 2 ** 31 + 9, epoch))


@pytest.mark.parametrize("name", ["hg8-train-resident", "hg8-serve-photos"])
def test_generators_follow_the_seed(name, tiny):
    a = harness.generator(tiny(name)).Traffic(tiny(name))
    b = harness.generator(tiny(name)).Traffic(tiny(name))
    if name == "hg8-serve-photos":
        np.testing.assert_array_equal(a.sizes, b.sizes)
        np.testing.assert_array_equal(a.offsets, b.offsets)
        for k in a.pool:
            np.testing.assert_array_equal(a.pool[k], b.pool[k])
    else:
        assert a.prog == b.prog
        for x, y in zip(a.ref_batches, b.ref_batches):
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
    assert all(torch.equal(a.weights[k], b.weights[k]) for k in a.weights)
