"""The port's plain ops (dsnt_pose2d_tpu_torch.ops) against the JAX ops on
identical numpy inputs, forward, fp32, at ~1e-6."""

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


@pytest.mark.parametrize("name", ["softmax", "thresholded_softmax"])
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
