"""The port's ResNet backbone (``models/resnet.py``), loaded through
``resnet_from_jax``, against the flax ``ResNetPose`` on the same weights and
batch, and one fp64 train step of resnet18 + DSNT against the JAX package.

resnet18 (basic blocks) and resnet50 (bottleneck blocks) at a 64-px input,
over dilate {0, 1, 2} x truncate {0, 1}: the torchvision dilation rule (a
dilated stage's first block keeps the previous dilation) and where ``proj``
exists are seen only in the numbers, so every combination is held.
Tolerances as ``tests/test_torch_model.py``: fp32 rtol 1e-4 / atol 2e-4
(TF32 off), fp64 rtol 1e-10 / atol 1e-10, bf16 at 5% of the largest
magnitude and within twice the JAX package's own bf16 distance from fp32.
The train step as ``tests/test_torch_train_step.py``: loss rtol 1e-8,
grads rtol 1e-6 (atol 1e-9 of the largest), updated parameters rtol 1e-10 /
atol 2e-9, BN statistics rtol 1e-10.  No resnet101 forward runs here (its
build and heatmap size are in ``tests/test_torch_model.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsnt_pose2d_tpu import ops as jops
from dsnt_pose2d_tpu.models.factory import build_pose_model as j_build
from dsnt_pose2d_tpu.models.resnet import ResNetPose as JResNetPose
from dsnt_pose2d_tpu.utils.config import ModelConfig as JModelConfig
from dsnt_pose2d_tpu_torch import ops as tops
from dsnt_pose2d_tpu_torch.device import strict_fp32
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
from dsnt_pose2d_tpu_torch.models.from_jax import resnet_from_jax
from dsnt_pose2d_tpu_torch.models.resnet import ResNetPose, stage_plan
from dsnt_pose2d_tpu_torch.utils.config import ModelConfig
from port_helpers import fp64_train_step, perturb

J, SIZE = 16, 64
GRID = [(arch, d, t) for arch in ("resnet18", "resnet50")
        for d in (0, 1, 2) for t in (0, 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Small models run faster on one intra-op thread, and parallel test
    # workers share the host's cores.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(12)
    return (rng.normal(size=(2, SIZE, SIZE, 3)) * 0.5).astype(np.float32)


def _pair(arch, dilate, truncate, images, dtype_j=jnp.float32,
          dtype_t=torch.float32, seed=3):
    flax_model = JResNetPose(arch=arch, num_joints=J, dilate=dilate,
                             truncate=truncate, dtype=dtype_j)
    variables = perturb(flax_model.init(jax.random.PRNGKey(seed),
                                        jnp.asarray(images), train=False),
                        seed=seed)
    net = ResNetPose(arch=arch, num_joints=J, dilate=dilate, truncate=truncate,
                     dtype=dtype_t)
    net.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                         resnet_from_jax(variables).items()}, strict=True)
    return flax_model, variables, net.eval()


def _forward_both(flax_model, variables, net, images):
    hm_j = np.asarray(flax_model.apply(variables, jnp.asarray(images),
                                       train=False))
    with torch.inference_mode(), strict_fp32():
        hm_t = net(torch.from_numpy(images)).numpy()
    return hm_j, hm_t


@pytest.mark.parametrize("arch,dilate,truncate", GRID)
def test_resnet_fp32_matches_flax(images, arch, dilate, truncate):
    hm_j, hm_t = _forward_both(*_pair(arch, dilate, truncate, images), images)
    model = build_pose_model(ModelConfig(base=arch, dilate=dilate,
                                         truncate=truncate, input_size=SIZE,
                                         dtype="float32"), device="cpu")
    jside = j_build(JModelConfig(base=arch, dilate=dilate, truncate=truncate,
                                 input_size=SIZE)).heatmap_size
    side = model.heatmap_size
    assert side == jside
    assert hm_t.shape == hm_j.shape == (1, 2, J, side, side)
    assert model.net.backbone.output_side(SIZE) == side
    assert hm_t.dtype == np.float32
    np.testing.assert_allclose(hm_t, hm_j, rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("arch,dilate,truncate", [("resnet18", 1, 0),
                                                   ("resnet50", 2, 1)])
def test_resnet_fp64_matches_flax(images, arch, dilate, truncate):
    # Both packages cast the score to fp32 at the end, so the fp64 trunk is
    # held at the score conv's own fp64 output (flax's captured
    # intermediate; a forward hook here), and the maps at fp32 rounding.
    x64 = images.astype(np.float64)
    with jax.enable_x64(True):
        flax_model = JResNetPose(arch=arch, num_joints=J, dilate=dilate,
                                 truncate=truncate, dtype=jnp.float64)
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            perturb(flax_model.init(jax.random.PRNGKey(4), jnp.asarray(x64),
                                    train=False)))
        hm_j, inter = flax_model.apply(variables, jnp.asarray(x64), train=False,
                                       capture_intermediates=True,
                                       mutable=["intermediates"])
        score_j = np.asarray(inter["intermediates"]["score"]["__call__"][0])
    net = ResNetPose(arch=arch, num_joints=J, dilate=dilate, truncate=truncate,
                     dtype=torch.float64).double()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in
                         resnet_from_jax(variables).items()}, strict=True)
    captured = []
    net.score.register_forward_hook(lambda m, i, out: captured.append(out))
    with torch.inference_mode():
        hm_t = net.eval()(torch.from_numpy(x64))
    score_t = captured[0].permute(0, 2, 3, 1).numpy()
    assert score_j.dtype == score_t.dtype == np.float64
    np.testing.assert_allclose(score_t, score_j, rtol=1e-10, atol=1e-10)
    assert hm_t.dtype == torch.float32 and np.asarray(hm_j).dtype == np.float32
    np.testing.assert_allclose(hm_t.numpy(), np.asarray(hm_j), rtol=1e-7,
                               atol=1e-7)


def test_resnet_bf16_matches_flax(images):
    flax_model, variables, net = _pair("resnet18", 1, 0, images, jnp.bfloat16,
                                       torch.bfloat16)
    hm_j, hm_t = _forward_both(flax_model, variables, net, images)
    assert hm_t.dtype == np.float32 and hm_j.dtype == np.float32
    scale = np.abs(hm_j).max()
    np.testing.assert_allclose(hm_t, hm_j, rtol=0, atol=0.05 * scale)
    net32 = ResNetPose(arch="resnet18", num_joints=J, dilate=1)
    net32.load_state_dict(net.state_dict(), strict=True)
    _, hm_32 = _forward_both(flax_model, variables, net32.eval(), images)
    assert np.abs(hm_t - hm_32).max() <= 2 * np.abs(hm_j - hm_32).max()


def test_dilation_rule_is_torchvisions():
    # resnet50, dilate 2: stage 2's first block keeps dilation 1 (stride 1),
    # its later blocks take 2; stage 3's first block keeps 2, the rest 4.
    plan = {(s, b): (stride, d) for s, b, _, stride, d in
            stage_plan("resnet50", dilate=2)}
    assert plan[(1, 0)] == (2, 1)
    assert plan[(2, 0)] == (1, 1) and plan[(2, 5)] == (1, 2)
    assert plan[(3, 0)] == (1, 2) and plan[(3, 2)] == (1, 4)
    # dilate past the strided stages converts only those (stage 0 has none).
    assert {d for *_, d in stage_plan("resnet18", dilate=4)} == {1, 2, 4, 8}
    with pytest.raises(ValueError, match="every stage"):
        stage_plan("resnet18", truncate=4)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_proj_exists_exactly_where_flax_makes_it(images, arch):
    flax_model = JResNetPose(arch=arch, num_joints=J, dilate=1)
    params = flax_model.init(jax.random.PRNGKey(0), jnp.asarray(images[:1]),
                             train=False)["params"]
    net = ResNetPose(arch=arch, num_joints=J, dilate=1)
    blocks = [k for k in params if k.startswith("stage")]
    for name in blocks:
        assert ("proj" in params[name]) == (getattr(net, name).proj is not None), name
    assert sum(getattr(net, n).proj is not None for n in blocks) == (
        3 if arch == "resnet18" else 4)


def _masked_stack_sum(per_joint, mask):
    return ((per_joint * mask).sum(dim=(1, 2))
            / mask.sum(dim=(1, 2)).clamp_min(1.0)).sum()


def _jax_dsnt_js(output, t, mask, cfg):
    # DSNT + JS in fp64 on the maps (which the ResNet casts to fp32 in both
    # packages), with the head's plain ops: the package's activate casts to
    # fp32, which would make this an fp32 comparison.
    z = jops.flat_softmax(output.heatmaps.astype(jnp.float64))
    coords = jops.dsnt(z)
    tb = jnp.broadcast_to(t[None], coords.shape)
    per_joint = jops.euclidean_losses(coords, tb) + jops.js_reg_losses(z, tb, 1.0)
    m = jnp.broadcast_to(mask[None], per_joint.shape)
    loss = jnp.sum(jnp.sum(per_joint * m, axis=(1, 2))
                   / jnp.maximum(jnp.sum(m, axis=(1, 2)), 1.0))
    return loss, {}


def _port_dsnt_js(output, t, mask, cfg):
    z = tops.flat_softmax(output.heatmaps.double())
    coords = tops.dsnt(z)
    tt = t[None].expand_as(coords)
    per_joint = tops.euclidean_losses(coords, tt) + tops.js_reg_losses(z, tt, 1.0)
    return _masked_stack_sum(per_joint, mask[None].expand_as(per_joint)), {}


@pytest.fixture(scope="module")
def resnet_step():
    return fp64_train_step(dict(base="resnet18", dilate=1, input_size=SIZE),
                           (_jax_dsnt_js, _port_dsnt_js))


def test_resnet18_fp64_step_loss(resnet_step):
    got, exp = resnet_step
    np.testing.assert_allclose(got.loss, exp.loss, rtol=1e-8)


def test_resnet18_fp64_step_every_grad(resnet_step):
    got, exp = resnet_step
    gmax = max(np.abs(exp.grads[n]).max() for n in got.grads)
    assert set(got.grads) <= set(exp.grads) and len(got.grads) > 50
    for name, g in got.grads.items():
        np.testing.assert_allclose(g, exp.grads[name], rtol=1e-6,
                                   atol=1e-9 * gmax, err_msg=name)


def test_resnet18_fp64_step_updated_params_and_stats(resnet_step):
    got, exp = resnet_step
    for name in got.grads:
        np.testing.assert_allclose(got.after[name], exp.after[name],
                                   rtol=1e-10, atol=2e-9, err_msg=name)
    keys = [k for k in exp.after if "running" in k]
    # stem + 2 x 8 block BNs + 3 projection BNs, mean and var each.
    assert len(keys) == 2 * 20
    for k in keys:
        np.testing.assert_allclose(got.after[k], exp.after[k], rtol=1e-10,
                                   atol=1e-12, err_msg=k)
