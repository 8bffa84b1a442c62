"""The port's ViT backbone (``models/vit.py``), loaded through
``vit_from_jax``, against the flax ``ViTPose`` on the same weights and
batch; the ViT through the factory, ``PoseNet`` (dsnt and fc heads), one
fp64 train step against the JAX package's, and the train and evaluate
CLIs on a model without BN.

ViT-T/16 (192 wide, 4 blocks, 3 heads) and a narrower ViT (32 wide, 2
blocks, 2 heads) at a 64-px input (a 4 x 4 patch grid, 8 x 8 heatmaps).
Tolerances: fp32 rtol 1e-4 / atol 2e-4 (TF32 off; measured ~1.7e-6 of the
largest value); fp64 at the score conv's captured fp64 output, rtol 1e-10
/ atol 1e-10 of the largest value, with the JAX package's two fp32 pins
(LayerNorm's dtype, the attention softmax) lifted to fp64 by
``port_helpers.vit_fp64_reference`` (without it the "fp64" JAX ViT is
fp32 at every LayerNorm and softmax); both packages then cast the score
to fp32, held at fp32 rounding.  bf16: the two round to bf16 at different
places; measured 1.06-1.56% of the largest value apart over two seeds x
the two widths, with each package 1.0-1.5% from the fp32 forward: held at
3% and the port's distance from fp32 within twice the JAX package's.  The
train step as ``tests/test_torch_resnet.py``'s.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsnt_pose2d_tpu import ops as jops
from dsnt_pose2d_tpu.models.factory import VIT_SPECS as J_VIT_SPECS
from dsnt_pose2d_tpu.models.factory import build_pose_model as j_build
from dsnt_pose2d_tpu.models.vit import ViTPose as JViTPose
from dsnt_pose2d_tpu.utils.config import ModelConfig as JModelConfig
from dsnt_pose2d_tpu.utils.config import config_from_json as j_config_from_json
from dsnt_pose2d_tpu.utils.config import config_to_json as j_config_to_json
from dsnt_pose2d_tpu_torch import ops as tops
from dsnt_pose2d_tpu_torch.cli import evaluate, train
from dsnt_pose2d_tpu_torch.device import strict_fp32
from dsnt_pose2d_tpu_torch.models.factory import VIT_SPECS, build_pose_model
from dsnt_pose2d_tpu_torch.models.from_jax import pose_net_from_jax, vit_from_jax
from dsnt_pose2d_tpu_torch.models.vit import ViTPose
from dsnt_pose2d_tpu_torch.utils.config import ModelConfig, config_from_json
from dsnt_pose2d_tpu_torch.utils.config import config_to_json
from port_helpers import fp64_train_step, perturb, vit_fp64_reference

J, SIZE = 16, 64
WIDTHS = {"vit_t16": dict(dim=192, depth=4, num_heads=3),
          "narrow": dict(dim=32, depth=2, num_heads=2)}
VIT_CONFIG = "configs/vit_s16_dsnt_2x.json"


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


def _port(width, variables, dtype=torch.float32):
    net = ViTPose(num_joints=J, input_size=SIZE, dtype=dtype, **WIDTHS[width])
    net.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                         vit_from_jax(variables).items()}, strict=True)
    return net.eval()


@pytest.fixture(scope="module")
def flax_variables(images):
    """Perturbed flax variables of each width (fp32 parameters, as flax
    makes them whatever the compute dtype), initialized once."""
    return {w: perturb(jax.jit(JViTPose(num_joints=J, **kw).init)(
        jax.random.PRNGKey(3), jnp.asarray(images)), seed=3)
        for w, kw in WIDTHS.items()}


def _pair(width, variables, dtype_j=jnp.float32, dtype_t=torch.float32):
    flax_model = JViTPose(num_joints=J, dtype=dtype_j, **WIDTHS[width])
    return flax_model, variables[width], _port(width, variables[width], dtype_t)


def _forward_both(flax_model, variables, net, images):
    hm_j = np.asarray(jax.jit(flax_model.apply)(variables, jnp.asarray(images)))
    with torch.inference_mode(), strict_fp32():
        hm_t = net(torch.from_numpy(images)).numpy()
    return hm_j, hm_t


def test_vit_specs_match_jax():
    assert VIT_SPECS == J_VIT_SPECS
    assert WIDTHS["vit_t16"] == dict(zip(("dim", "depth", "num_heads"),
                                         VIT_SPECS["vit_t16"]))


@pytest.mark.parametrize("width", list(WIDTHS))
def test_vit_fp32_matches_flax(images, flax_variables, width):
    hm_j, hm_t = _forward_both(*_pair(width, flax_variables), images)
    assert hm_t.shape == hm_j.shape == (1, 2, J, SIZE // 8, SIZE // 8)
    assert hm_t.dtype == np.float32
    np.testing.assert_allclose(hm_t, hm_j, rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_vit_fp64_matches_flax_at_score(images, flax_variables, width):
    x64 = images.astype(np.float64)
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       flax_variables[width])
    with jax.enable_x64(True), vit_fp64_reference():
        flax_model = JViTPose(num_joints=J, dtype=jnp.float64, **WIDTHS[width])
        hm_j, inter = flax_model.apply(variables, jnp.asarray(x64),
                                       capture_intermediates=True,
                                       mutable=["intermediates"])
        score_j = np.asarray(inter["intermediates"]["score"]["__call__"][0])
    net = _port(width, variables, torch.float64).double()
    captured = []
    net.score.register_forward_hook(lambda m, i, out: captured.append(out))
    with torch.inference_mode():
        hm_t = net(torch.from_numpy(x64))
    score_t = captured[0].permute(0, 2, 3, 1).numpy()
    assert score_j.dtype == score_t.dtype == np.float64
    scale = np.abs(score_j).max()
    np.testing.assert_allclose(score_t, score_j, rtol=1e-10, atol=1e-10 * scale)
    # The output is the score cast to fp32 in both packages, fp64 or not.
    assert hm_t.dtype == torch.float32 and np.asarray(hm_j).dtype == np.float32
    np.testing.assert_allclose(hm_t.numpy(), np.asarray(hm_j), rtol=1e-7,
                               atol=1e-7 * scale)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_vit_bf16_matches_flax(images, flax_variables, width):
    flax_model, variables, net = _pair(width, flax_variables, jnp.bfloat16,
                                       torch.bfloat16)
    hm_j, hm_t = _forward_both(flax_model, variables, net, images)
    assert hm_t.dtype == np.float32 and hm_j.dtype == np.float32
    scale = np.abs(hm_j).max()
    np.testing.assert_allclose(hm_t, hm_j, rtol=0, atol=0.03 * scale)
    _, hm_32 = _forward_both(flax_model, variables, _port(width, variables),
                             images)
    assert np.abs(hm_t - hm_32).max() <= 2 * np.abs(hm_j - hm_32).max()


def test_vit_shapes_sizes_and_the_patch_rule():
    model = build_pose_model(ModelConfig(base="vit_t16", input_size=SIZE,
                                         dtype="float32"), device="cpu")
    side = j_build(JModelConfig(base="vit_t16", input_size=SIZE)).heatmap_size
    assert model.heatmap_size == side == 8
    vit = model.net.backbone
    assert vit.output_side(SIZE) == side and vit.pos_row.shape == (4, 192)
    with torch.inference_mode():
        out = model.forward(torch.zeros((1, SIZE, SIZE, 3)))
    assert out.heatmaps.shape == (1, 1, J, side, side) and out.fc_coords is None
    # The 448-px default: a 28 x 28 grid, 56 x 56 heatmaps.
    cfg = ModelConfig(base="vit_t16")
    assert cfg.resolved_input_size == JModelConfig(base="vit_t16").resolved_input_size == 448
    assert vit.output_side(448) == 56
    # A side the 16-px patch does not divide raises, in both packages.
    with pytest.raises(ValueError, match="not divisible by patch 16"):
        build_pose_model(ModelConfig(base="vit_t16", input_size=60), device="cpu")
    with pytest.raises(ValueError, match="not divisible by patch 16"):
        JViTPose(num_joints=J, **WIDTHS["narrow"]).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 60, 60, 3)))
    with pytest.raises(ValueError, match="position embeddings"):
        model.forward(torch.zeros((1, 48, 48, 3)))


def test_vit_from_jax_takes_remat_variables(images, flax_variables):
    # flax's nn.remat keeps the module names: the variables of a remat=True
    # model convert with the same keys, and drive the same forward.
    remat_model = JViTPose(num_joints=J, **WIDTHS["narrow"], remat=True)
    rematted = perturb(jax.jit(remat_model.init)(jax.random.PRNGKey(5),
                                                 jnp.asarray(images)))
    a, b = vit_from_jax(flax_variables["narrow"]), vit_from_jax(rematted)
    # patch_embed, pos x2, 2 blocks x (2 LN + 4 dense) x 2, ln_out, 3 convs.
    assert a.keys() == b.keys() and len(a) == 2 + 2 + 24 + 2 + 6
    hm_j, hm_t = _forward_both(remat_model, rematted, _port("narrow", rematted),
                               images)
    np.testing.assert_allclose(hm_t, hm_j, rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("strat", ["dsnt", "fc"])
def test_posenet_vit_loads_flax_posenet(images, strat):
    # The JAX package's PoseNet over ViT-T/16 (the fc head's per-joint
    # projection included) converted through pose_net_from_jax.
    kw = dict(base="vit_t16", input_size=SIZE, output_strat=strat,
              dtype="float32", use_pallas=False)
    jmodel = j_build(JModelConfig(**kw))
    variables = perturb(jax.jit(jmodel.module.init, static_argnames="train")(
        jax.random.PRNGKey(6), jnp.zeros((1, SIZE, SIZE, 3)), train=False), seed=6)
    assert "batch_stats" not in variables
    state = pose_net_from_jax(jax.device_get(variables), jmodel.cfg)
    model = build_pose_model(ModelConfig(**kw), device="cpu", state_dict=state)
    out_j = jax.jit(jmodel.forward)(variables, jnp.asarray(images))
    with torch.inference_mode(), strict_fp32():
        out_t = model.forward(torch.from_numpy(images))
    np.testing.assert_allclose(out_t.heatmaps.numpy(), np.asarray(out_j.heatmaps),
                               rtol=1e-4, atol=2e-4)
    if strat == "fc":
        np.testing.assert_allclose(out_t.fc_coords.numpy(),
                                   np.asarray(out_j.fc_coords), rtol=1e-4,
                                   atol=1e-5)
    else:
        assert out_t.fc_coords is None and out_j.fc_coords is None


def _masked_stack_sum(per_joint, mask):
    return ((per_joint * mask).sum(dim=(1, 2))
            / mask.sum(dim=(1, 2)).clamp_min(1.0)).sum()


def _jax_dsnt(output, t, mask, cfg):
    # DSNT with no regularizer (config #5's head) in fp64 on the maps,
    # which the ViT casts to fp32 in both packages.
    coords = jops.dsnt(jops.flat_softmax(output.heatmaps.astype(jnp.float64)))
    per_joint = jops.euclidean_losses(coords, jnp.broadcast_to(t[None], coords.shape))
    m = jnp.broadcast_to(mask[None], per_joint.shape)
    return jnp.sum(jnp.sum(per_joint * m, axis=(1, 2))
                   / jnp.maximum(jnp.sum(m, axis=(1, 2)), 1.0)), {}


def _port_dsnt(output, t, mask, cfg):
    coords = tops.dsnt(tops.flat_softmax(output.heatmaps.double()))
    per_joint = tops.euclidean_losses(coords, t[None].expand_as(coords))
    return _masked_stack_sum(per_joint, mask[None].expand_as(per_joint)), {}


@pytest.fixture(scope="module")
def vit_step():
    return fp64_train_step(dict(base="vit_t16", input_size=SIZE),
                           (_jax_dsnt, _port_dsnt))


def test_vit_fp64_step_loss(vit_step):
    got, exp = vit_step
    np.testing.assert_allclose(got.loss, exp.loss, rtol=1e-8)


def test_vit_fp64_step_every_grad(vit_step):
    got, exp = vit_step
    gmax = max(np.abs(exp.grads[n]).max() for n in got.grads)
    # patch_embed, pos x2, 4 blocks x (2 LN + 4 dense) x 2, ln_out, 3 convs.
    assert set(got.grads) == set(exp.grads) and len(got.grads) == 2 + 2 + 48 + 2 + 6
    for name, g in got.grads.items():
        np.testing.assert_allclose(g, exp.grads[name], rtol=1e-6,
                                   atol=1e-9 * gmax, err_msg=name)


def test_vit_fp64_step_updated_params(vit_step):
    got, exp = vit_step
    assert set(got.after) == set(exp.after) == set(got.grads)   # no BN buffers
    for name in got.grads:
        np.testing.assert_allclose(got.after[name], exp.after[name],
                                   rtol=1e-10, atol=2e-9, err_msg=name)


def test_vit_config_loads_in_both_packages():
    from pathlib import Path

    text = (Path(__file__).resolve().parent.parent / VIT_CONFIG).read_text()
    got, exp = config_from_json(text), j_config_from_json(text)
    assert json.loads(config_to_json(got)) == json.loads(j_config_to_json(exp))
    m = got.model
    assert (m.base, m.resolved_input_size, m.dtype, m.output_strat, m.preact,
            m.reg, m.use_pallas, got.train.batch_size) == (
        "vit_s16", 448, "bfloat16", "dsnt", "softmax", "none", True, 32)


def test_vit_train_and_evaluate_clis(tmp_path):
    # --config with overrides, a model without BN through the Trainer,
    # its checkpoints and the evaluate CLI: evaluate's PCKh is the train
    # run's best val_pckh.
    from pathlib import Path

    config = Path(__file__).resolve().parent.parent / VIT_CONFIG
    argv = ["--config", str(config), "--device", "cpu", "--base-model",
            "vit_t16", "--input-size", str(SIZE), "--dtype", "float32",
            "--data-source", "synthetic", "--synthetic-size", "16",
            "--batch-size", "4", "--epochs", "1", "--workers", "2",
            "--out-dir", str(tmp_path), "--experiment-id", "vit"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert train.main(argv) == 0
    exp_dir = tmp_path / "vit"
    cfg = config_from_json((exp_dir / "config.json").read_text())
    assert (cfg.model.base, cfg.model.input_size, cfg.model.reg,
            cfg.optim.lr_drop_epochs, cfg.train.epochs) == (
        "vit_t16", SIZE, "none", (60, 90), 1)
    state = torch.load(exp_dir / "ckpt" / "0" / "state.pt", weights_only=True)
    assert not any("running" in k for k in state["model"])
    records = [json.loads(line) for line in open(exp_dir / "metrics.jsonl")]
    best = max(r["val_pckh"] for r in records if "val_pckh" in r)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        assert evaluate.main(["--model-dir", str(exp_dir), "--device", "cpu",
                              "--data-source", "synthetic",
                              "--synthetic-size", "16"]) == 0
    assert f"  total     {100 * best:6.2f}" in printed.getvalue().splitlines()
