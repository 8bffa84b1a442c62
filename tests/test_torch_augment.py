"""The port's preprocessing against the JAX ``preprocess_batch``.

Same synthetic canvases (the fixture's numpy arrays), same config; the JAX
side runs its row_shift Pallas kernel in interpret mode.  Source positions
are fp32 products of O(100) px values and differ by an ulp between the two
frameworks, which moves a warped [0, 1] pixel by up to ~3e-6; the mean/std
normalization divides by std >= 0.224, so normalized images are held at
3e-5.  Coordinates agree to 1e-5, the affines to 1e-4 px.  The train path
gets the draws that JAX makes from its key (``tests/port_helpers.py``) and is
held to the same bars; its resampling products run at ``Precision.DEFAULT``
on the JAX side, which on the CPU is full fp32, as the port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsnt_pose2d_tpu.data import transforms as JT
from dsnt_pose2d_tpu.data.augment import preprocess_batch as j_preprocess
from dsnt_pose2d_tpu.data.synthetic import make_synthetic_mpii as j_synth
from dsnt_pose2d_tpu.utils.config import DataConfig as JDataConfig
from dsnt_pose2d_tpu_torch.data import augment as A
from dsnt_pose2d_tpu_torch.data import transforms as T
from dsnt_pose2d_tpu_torch.data.synthetic import make_synthetic_mpii
from dsnt_pose2d_tpu_torch.utils.config import DataConfig
from port_helpers import jax_train_draws

BATCH, CANVAS, SIZE = 3, 96, 64


@pytest.fixture(scope="module")
def batch():
    d = make_synthetic_mpii(BATCH, CANVAS, seed=4)
    d["canvas_margin"] = np.array([1.0, 1.25, 0.8], np.float32)
    return d


def test_synthetic_fixture_matches_jax():
    got, exp = make_synthetic_mpii(3, 48, seed=2), j_synth(3, 48, seed=2)
    assert got.keys() == exp.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], exp[k])


def _run_both(batch, warp_method, eval_scale=1.0, uint8=False):
    canv = batch["canvases"]
    if uint8:
        canv = (canv * 255).astype(np.uint8)
    args = [canv, batch["coords_px"], batch["mask"], batch["head_length"],
            batch["canvas_from_orig"]]
    exp = j_preprocess(jax.random.PRNGKey(0), *map(jnp.asarray, args),
                       JDataConfig(warp_method=warp_method), SIZE, False,
                       canvas_margin=jnp.asarray(batch["canvas_margin"]),
                       eval_scale=eval_scale)
    got = A.preprocess_batch(*map(torch.from_numpy, args),
                             DataConfig(warp_method=warp_method), SIZE,
                             train=False,
                             canvas_margin=torch.from_numpy(batch["canvas_margin"]),
                             eval_scale=eval_scale)
    return got, exp


@pytest.mark.parametrize("warp_method", ["shear", "gather"])
@pytest.mark.parametrize("eval_scale", [1.0, 1.3])
def test_eval_preprocess_matches_jax(batch, warp_method, eval_scale):
    got, exp = _run_both(batch, warp_method, eval_scale)
    for k, atol in (("images", 3e-5), ("coords", 1e-5), ("mask", 0),
                    ("head_length", 0), ("crop_from_orig", 1e-4)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(exp[k]),
                                   atol=atol, rtol=0, err_msg=k)


def test_eval_preprocess_uint8_matches_jax(batch):
    got, exp = _run_both(batch, "shear", uint8=True)
    np.testing.assert_allclose(got["images"].numpy(), np.asarray(exp["images"]),
                               atol=3e-5)


def test_shear_equals_bilinear_rotation_free(batch):
    canvas = torch.from_numpy(batch["canvases"])
    b = canvas.shape[0]
    m = T.crop_transform(torch.full((b, 2), (CANVAS - 1) / 2.0),
                         torch.full((b,), CANVAS / 200.0), SIZE,
                         rot_rad=torch.zeros(b),
                         scale_aug=torch.tensor([1.0, 0.8, 1.2]),
                         flip=torch.zeros(b, dtype=torch.bool))
    inv = T.invert(m)
    np.testing.assert_allclose(
        A.affine_warp_shear(canvas, inv, SIZE, 0.0).numpy(),
        A.affine_warp_bilinear(canvas, inv, SIZE).numpy(), atol=1e-5)


def test_transforms_match_jax():
    rng = np.random.default_rng(5)
    b = 4
    center = rng.uniform(50, 300, size=(b, 2)).astype(np.float32)
    scale = rng.uniform(1.0, 3.0, size=(b,)).astype(np.float32)
    rot = rng.uniform(-0.5, 0.5, size=(b,)).astype(np.float32)
    saug = rng.uniform(0.75, 1.25, size=(b,)).astype(np.float32)
    flip = np.array([True, False, True, False])
    pts = rng.uniform(0, 400, size=(b, 16, 2)).astype(np.float32)
    jm = JT.crop_transform(jnp.asarray(center), jnp.asarray(scale), 256,
                           rot_rad=jnp.asarray(rot), scale_aug=jnp.asarray(saug),
                           flip=jnp.asarray(flip))
    tm = T.crop_transform(torch.from_numpy(center), torch.from_numpy(scale), 256,
                          rot_rad=torch.from_numpy(rot),
                          scale_aug=torch.from_numpy(saug),
                          flip=torch.from_numpy(flip))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(T.invert(tm).numpy(),
                               np.asarray(JT.invert(jm)), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        T.transform_coords(tm, torch.from_numpy(pts)).numpy(),
        np.asarray(JT.transform_coords(jm, jnp.asarray(pts))), atol=1e-3)
    np.testing.assert_array_equal(T.flip_permutation(16).numpy(),
                                  np.asarray(JT.flip_permutation(16)))


def _args(batch):
    return [torch.from_numpy(batch[k]) for k in
            ("canvases", "coords_px", "mask", "head_length", "canvas_from_orig")]


def test_train_path_not_ported(batch):
    # The train path takes its draws as tensors: without them it refuses;
    # with draws from a seeded generator it is a pure function of the seed.
    with pytest.raises(ValueError, match="draws"):
        A.preprocess_batch(*_args(batch), DataConfig(), SIZE, train=True)
    runs = []
    for _ in range(2):
        draws = A.sample_train_draws(BATCH, DataConfig(),
                                     torch.Generator().manual_seed(7))
        runs.append(A.preprocess_batch(*_args(batch), DataConfig(), SIZE,
                                       train=True, draws=draws))
    for k in ("images", "coords", "mask", "crop_from_orig"):
        assert torch.equal(runs[0][k], runs[1][k]), k
    assert runs[0]["images"].shape == (BATCH, SIZE, SIZE, 3)
    assert torch.isfinite(runs[0]["images"]).all()


def _run_train_both(batch, cfg_kw, key):
    jcfg, tcfg = JDataConfig(**cfg_kw), DataConfig(**cfg_kw)
    draws = jax_train_draws(key, BATCH, jcfg)
    args = [batch[k] for k in ("canvases", "coords_px", "mask", "head_length",
                               "canvas_from_orig")]
    margin = batch["canvas_margin"]
    exp = j_preprocess(key, *map(jnp.asarray, args), jcfg, SIZE, True,
                       canvas_margin=jnp.asarray(margin))
    got = A.preprocess_batch(
        *map(torch.from_numpy, args), tcfg, SIZE, train=True,
        canvas_margin=torch.from_numpy(margin),
        draws={k: None if v is None else torch.from_numpy(v)
               for k, v in draws.items()})
    return got, exp, draws


@pytest.mark.parametrize("warp_method", ["shear", "gather"])
def test_train_preprocess_matches_jax(batch, warp_method):
    # Rotation, scale, flip and color jitter all on (the config's defaults).
    got, exp, draws = _run_train_both(batch, {"warp_method": warp_method},
                                      jax.random.PRNGKey(2))
    assert 0 < draws["flip"].sum() < BATCH and np.all(draws["rot"] != 0)
    for k, atol in (("images", 3e-5), ("coords", 1e-5), ("mask", 0),
                    ("head_length", 0), ("crop_from_orig", 1e-4)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(exp[k]),
                                   atol=atol, rtol=0, err_msg=k)


def test_train_preprocess_wide_rotation_falls_back_to_gather(batch):
    # Above 60 degrees the shear warp degenerates: both packages warn and
    # take the gather warp.
    kw = {"warp_method": "shear", "max_rotation_deg": 75.0}
    with pytest.warns(UserWarning, match="falling back to 'gather'"):
        got, exp, _ = _run_train_both(batch, kw, jax.random.PRNGKey(3))
    np.testing.assert_allclose(got["images"].numpy(), np.asarray(exp["images"]),
                               atol=3e-5, rtol=0)
