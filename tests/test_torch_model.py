"""The port's hourglass, loaded through ``hourglass_from_jax``, against the
flax forward in eval mode on the same weights and batch.

fp32: rtol 1e-4 / atol 2e-4, the bar of ``tests/test_export_torch.py`` (two
frameworks' conv sums in different orders), TF32 off.  bf16: both sides
round activations to bf16 (8 mantissa bits) at different places, so the
heatmaps are held at 5% of their largest magnitude, and the port's distance
from the fp32 forward at twice the JAX package's own bf16 distance.  fp64
(flax under ``jax.enable_x64``): fp64 heatmaps, as flax promotes, agreeing to
rtol 1e-10 / atol 1e-10 (sums in different orders, 16 significant digits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsnt_pose2d_tpu import ops as jops
from dsnt_pose2d_tpu.models.factory import build_pose_model as j_build
from dsnt_pose2d_tpu.models.hourglass import HourglassNet as JHourglassNet
from dsnt_pose2d_tpu.utils.config import ModelConfig as JModelConfig
from dsnt_pose2d_tpu_torch import ops as tops
from dsnt_pose2d_tpu_torch.device import strict_fp32
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
from dsnt_pose2d_tpu_torch.models.from_jax import hourglass_from_jax
from dsnt_pose2d_tpu_torch.models.hourglass import HourglassNet
from dsnt_pose2d_tpu_torch.utils.config import ModelConfig
from port_helpers import perturb

STACKS, FEATS, J, SIZE = 2, 32, 16, 64


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(11)
    return (rng.normal(size=(2, SIZE, SIZE, 3)) * 0.5).astype(np.float32)


def _pair(dtype_j, dtype_t, images):
    flax_model = JHourglassNet(num_stacks=STACKS, num_joints=J, features=FEATS,
                               dtype=dtype_j)
    variables = perturb(flax_model.init(jax.random.PRNGKey(3),
                                        jnp.asarray(images), train=False))
    net = HourglassNet(num_stacks=STACKS, num_joints=J, features=FEATS,
                       dtype=dtype_t)
    state = {k: torch.from_numpy(v) for k, v in
             hourglass_from_jax(variables, STACKS).items()}
    net.load_state_dict(state, strict=True)
    net.eval()
    return flax_model, variables, net


def _forward_both(flax_model, variables, net, images):
    hm_j = np.asarray(flax_model.apply(variables, jnp.asarray(images),
                                       train=False))
    with torch.inference_mode(), strict_fp32():
        hm_t = net(torch.from_numpy(images)).numpy()
    return hm_j, hm_t


def test_hourglass_fp32_matches_flax(images):
    hm_j, hm_t = _forward_both(*_pair(jnp.float32, torch.float32, images),
                               images)
    assert hm_t.shape == hm_j.shape == (STACKS, 2, J, SIZE // 4, SIZE // 4)
    assert hm_t.dtype == np.float32
    np.testing.assert_allclose(hm_t, hm_j, rtol=1e-4, atol=2e-4)
    cj = np.asarray(jops.dsnt(jops.flat_softmax(jnp.asarray(hm_j[-1]))))
    ct = tops.dsnt(tops.flat_softmax(torch.from_numpy(hm_t[-1]))).numpy()
    np.testing.assert_allclose(ct, cj, atol=1e-5)


def test_hourglass_bf16_matches_flax(images):
    flax_model, variables, net = _pair(jnp.bfloat16, torch.bfloat16, images)
    hm_j, hm_t = _forward_both(flax_model, variables, net, images)
    assert hm_t.dtype == np.float32 and hm_j.dtype == np.float32
    scale = np.abs(hm_j).max()
    np.testing.assert_allclose(hm_t, hm_j, rtol=0, atol=0.05 * scale)
    # Against the fp32 forward on the same weights, the port's bf16 error
    # stays within twice the JAX package's own bf16 error.
    net32 = HourglassNet(num_stacks=STACKS, num_joints=J, features=FEATS)
    net32.load_state_dict(net.state_dict(), strict=True)
    _, hm_32 = _forward_both(flax_model, variables, net32.eval(), images)
    assert np.abs(hm_t - hm_32).max() <= 2 * np.abs(hm_j - hm_32).max()


def test_hourglass_fp64_matches_flax(images):
    x64 = images.astype(np.float64)
    with jax.enable_x64(True):
        flax_model = JHourglassNet(num_stacks=STACKS, num_joints=J,
                                   features=FEATS, dtype=jnp.float64)
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            perturb(flax_model.init(jax.random.PRNGKey(3), jnp.asarray(x64),
                                    train=False)))
        hm_j = np.asarray(flax_model.apply(variables, jnp.asarray(x64),
                                           train=False))
    net = HourglassNet(num_stacks=STACKS, num_joints=J, features=FEATS,
                       dtype=torch.float64).double()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in
                         hourglass_from_jax(variables, STACKS).items()},
                        strict=True)
    with torch.inference_mode():
        hm_t = net.eval()(torch.from_numpy(x64))
    assert hm_j.dtype == np.float64 and hm_t.dtype == torch.float64
    np.testing.assert_allclose(hm_t.numpy(), hm_j, rtol=1e-10, atol=1e-10)


def test_posenet_loads_flax_posenet_variables(images):
    kw = dict(base="hg2", hg_features=FEATS, input_size=SIZE, dtype="float32",
              reg="js")
    jmodel = j_build(JModelConfig(**kw))
    variables = perturb(jmodel.init_variables(jax.random.PRNGKey(0)), seed=1)
    state = hourglass_from_jax(variables, STACKS)
    assert all(k.startswith("backbone.") for k in state)
    model = build_pose_model(ModelConfig(**kw), device="cpu", state_dict=state)
    out_j = np.asarray(jmodel.forward(variables, jnp.asarray(images)).heatmaps)
    with torch.inference_mode(), strict_fp32():
        out_t = model.forward(torch.from_numpy(images)).heatmaps.numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=1e-4, atol=2e-4)


def test_seeded_init_is_deterministic():
    cfg = ModelConfig(base="hg1", hg_features=FEATS, input_size=SIZE)
    a = build_pose_model(cfg, device="cpu", seed=5).net.state_dict()
    b = build_pose_model(cfg, device="cpu", seed=5).net.state_dict()
    c = build_pose_model(cfg, device="cpu", seed=6).net.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["backbone.stem_conv.weight"],
                           c["backbone.stem_conv.weight"])
    w = a["backbone.hg0.up1_d4.conv2.weight"]
    # LeCun-normal: variance 1 / fan_in, as flax's default conv init.
    fan_in = w[0].numel()
    assert abs(float(w.var()) * fan_in - 1.0) < 0.1


@pytest.mark.parametrize("base", ["vit_s16", "vit_b16"])
def test_other_bases_not_ported(base):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, ViT"):
        build_pose_model(ModelConfig(base=base), device="cpu")


@pytest.mark.parametrize("base,dilate,side", [
    ("resnet18", 0, 2), ("resnet34", 1, 4), ("resnet50", 2, 8),
    ("resnet101", 3, 16)])
def test_resnet_bases_build(base, dilate, side):
    # Built (formerly refused as not ported); resnet101 without a forward,
    # which would take seconds of this host's CPU.
    cfg = ModelConfig(base=base, dilate=dilate, input_size=SIZE, dtype="float32")
    model = build_pose_model(cfg, device="cpu")
    assert model.heatmap_size == side
    assert model.net.backbone.output_side(SIZE) == side
    assert model.net.backbone.score.out_channels == J
    if base != "resnet101":
        with torch.inference_mode():
            out = model.forward(torch.zeros((1, SIZE, SIZE, 3)))
        assert out.heatmaps.shape == (1, 1, J, side, side) and out.fc_coords is None


def test_remat_not_ported():
    with pytest.raises(NotImplementedError, match="remat"):
        build_pose_model(ModelConfig(base="hg1", hg_features=FEATS,
                                     input_size=SIZE, remat=True), device="cpu")
