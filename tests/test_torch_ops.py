"""The port's plain ops (dsnt_pose2d_tpu_torch.ops) against the JAX ops on
identical numpy inputs, forward, fp32, at ~1e-6.  The argmax decode of the
gauss head is held exactly (the same pixel, the same quarter offsets) on
maps with ties, maxima on every edge and corner, and equal neighbours."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsnt_pose2d_tpu import ops as jops
from dsnt_pose2d_tpu_torch import ops as tops

ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def maps():
    rng = np.random.default_rng(101)
    raw = (rng.normal(size=(2, 3, 9, 7)) * 3).astype(np.float32)
    # One map with a spread large enough that probabilities underflow to 0.
    raw[0, 0] *= 40.0
    t = rng.uniform(-0.8, 0.8, size=(2, 3, 2)).astype(np.float32)
    mask = (rng.uniform(size=(2, 3)) > 0.3).astype(np.float32)
    return raw, t, mask


@pytest.mark.parametrize("length", [1, 7, 64])
def test_normalized_linspace(length):
    np.testing.assert_allclose(tops.normalized_linspace(length).numpy(),
                               np.asarray(jops.normalized_linspace(length)),
                               atol=ATOL)


def test_coordinate_grids():
    for got, exp in zip(tops.coordinate_grids(5, 8), jops.coordinate_grids(5, 8)):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=ATOL)


@pytest.mark.parametrize("name", ["softmax", "thresholded_softmax", "relu",
                                  "abs", "sigmoid"])
def test_activations(maps, name):
    raw = maps[0]
    np.testing.assert_allclose(
        tops.HEATMAP_ACTIVATIONS[name](_t(raw)).numpy(),
        np.asarray(jops.HEATMAP_ACTIVATIONS[name](jnp.asarray(raw))), atol=ATOL)


@pytest.mark.parametrize("threshold", [-1.0, 0.5, 100.0])
def test_thresholded_softmax_threshold_and_fallback(maps, threshold):
    # 100 is above every logit: every map falls back to the plain softmax.
    raw = maps[0]
    got = tops.thresholded_softmax(_t(raw), threshold).numpy()
    exp = np.asarray(jops.thresholded_softmax(jnp.asarray(raw), threshold))
    np.testing.assert_allclose(got, exp, atol=ATOL)
    if threshold == 100.0:
        np.testing.assert_allclose(got, tops.flat_softmax(_t(raw)).numpy(),
                                   atol=ATOL)


def test_dsnt(maps):
    z = jops.flat_softmax(jnp.asarray(maps[0]))
    np.testing.assert_allclose(tops.dsnt(_t(z)).numpy(),
                               np.asarray(jops.dsnt(z)), atol=ATOL)


@pytest.mark.parametrize("sigma", [0.7, 1.0, 2.5])
@pytest.mark.parametrize("normalize", [True, False])
def test_make_gauss(maps, sigma, normalize):
    t = maps[1]
    np.testing.assert_allclose(
        tops.make_gauss(_t(t), (9, 7), sigma, normalize).numpy(),
        np.asarray(jops.make_gauss(jnp.asarray(t), (9, 7), sigma, normalize)),
        atol=ATOL)


def test_euclidean_losses(maps):
    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, size=(2, 3, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tops.euclidean_losses(_t(a), _t(maps[1])).numpy(),
        np.asarray(jops.euclidean_losses(jnp.asarray(a), jnp.asarray(maps[1]))),
        atol=ATOL)


@pytest.mark.parametrize("name", ["l1", "mse"])
def test_coord_losses(maps, name):
    a = np.random.default_rng(5).uniform(-1, 1, size=(2, 3, 2)).astype(np.float32)
    fn = {"l1": jops.l1_losses, "mse": jops.mse_losses}[name]
    np.testing.assert_allclose(
        tops.COORD_LOSSES[name](_t(a), _t(maps[1])).numpy(),
        np.asarray(fn(jnp.asarray(a), jnp.asarray(maps[1]))), atol=ATOL)


def test_sum_normalized_all_zero_map():
    # relu of a map with no positive value: the sum is floored at 1e-24, so
    # the map stays 0 (no NaN), as in the JAX package.
    raw = -np.ones((1, 4, 5), np.float32)
    got = tops.relu_normalized(_t(raw)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.HEATMAP_ACTIVATIONS["relu"](jnp.asarray(raw))))
    assert not got.any()


@pytest.mark.parametrize("size_hw", [(9, 7), (56, 56)])
def test_pixel_normalized_round_trip(size_hw):
    px = np.random.default_rng(6).uniform(-1, 60, size=(4, 3, 2)).astype(np.float32)
    got = tops.pixel_to_normalized(_t(px), size_hw)
    from dsnt_pose2d_tpu.ops.coords import normalized_to_pixel, pixel_to_normalized

    exp = np.asarray(pixel_to_normalized(jnp.asarray(px), size_hw))
    np.testing.assert_allclose(got.numpy(), exp, atol=ATOL)
    back = tops.normalized_to_pixel(got, size_hw).numpy()
    np.testing.assert_allclose(
        back, np.asarray(normalized_to_pixel(jnp.asarray(exp), size_hw)),
        atol=1e-5)
    np.testing.assert_allclose(back, px, atol=1e-4)


def _decode_maps():
    """Maps whose argmax lies on each edge and corner, ties (the first
    maximum wins), equal neighbours (no shift), and random maps."""
    h, w = 6, 7
    maps = []
    for y, x in [(0, 0), (0, 3), (0, w - 1), (2, 0), (2, w - 1), (h - 1, 0),
                 (h - 1, 4), (h - 1, w - 1), (3, 3)]:
        m = np.zeros((h, w), np.float32)
        m[y, x] = 2.0
        if 0 < x < w - 1:
            m[y, x + 1] = 1.0      # right neighbour larger: +1/4 in x
        if 0 < y < h - 1:
            m[y - 1, x] = 1.0      # upper neighbour larger: -1/4 in y
        maps.append(m)
    tie = np.zeros((h, w), np.float32)
    tie[2, 2] = tie[2, 5] = tie[4, 1] = 3.0
    maps.append(tie)                   # three maxima: (2, 2) is first
    equal = np.zeros((h, w), np.float32)
    equal[3, 2:5] = [1.0, 2.0, 1.0]
    equal[2:5, 3] = [0.5, 2.0, 0.5]
    maps.append(equal)                 # equal neighbours on both axes
    maps.append(np.full((h, w), -1.0, np.float32))   # constant: pixel 0
    rng = np.random.default_rng(7)
    maps.extend(rng.normal(size=(4, h, w)).astype(np.float32))
    return np.stack(maps)


def test_heatmaps_to_coords_matches_jax():
    maps = _decode_maps()
    got = tops.heatmaps_to_coords(_t(maps)).numpy()
    exp = np.asarray(jops.heatmaps_to_coords(jnp.asarray(maps)))
    np.testing.assert_array_equal(got, exp)
    px = tops.normalized_to_pixel(_t(got), (6, 7)).numpy()
    np.testing.assert_allclose(px[0], [0, 0], atol=1e-6)          # corner
    np.testing.assert_allclose(px[1], [3.25, 0], atol=1e-6)       # top edge
    np.testing.assert_allclose(px[8], [3.25, 2.75], atol=1e-6)    # interior
    np.testing.assert_allclose(px[9], [2, 2], atol=1e-6)          # first tie
    np.testing.assert_allclose(px[10], [3, 3], atol=1e-6)         # no shift
    np.testing.assert_allclose(px[11], [0, 0], atol=1e-6)         # constant


def test_heatmaps_to_coords_leading_axes():
    maps = _decode_maps().reshape(4, 4, 6, 7)
    got = tops.heatmaps_to_coords(_t(maps))
    assert got.shape == (4, 4, 2)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.heatmaps_to_coords(jnp.asarray(maps))))


@pytest.mark.parametrize("use_mask", [True, False])
def test_average_loss(maps, use_mask):
    losses = np.random.default_rng(4).uniform(size=(2, 3)).astype(np.float32)
    mask = maps[2] if use_mask else None
    got = tops.average_loss(_t(losses), None if mask is None else _t(mask))
    exp = jops.average_loss(jnp.asarray(losses),
                            None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6)


@pytest.mark.parametrize("reg", ["js", "kl", "mse", "var"])
def test_regularizers(maps, reg):
    raw, t, _ = maps
    z = jops.flat_softmax(jnp.asarray(raw))
    if reg == "var":
        got = tops.variance_reg_losses(_t(z), 1.0)
        exp = jops.variance_reg_losses(z, 1.0)
    else:
        got = tops.REGULARIZERS[reg](_t(z), _t(t), 1.0)
        exp = jops.REGULARIZERS[reg](z, jnp.asarray(t), 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-5,
                               atol=ATOL)
