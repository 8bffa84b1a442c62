"""The paper's head ablation in the port: the ``gauss`` and ``fc`` heads, the
remaining preacts and coordinate losses, on the hourglass and the ResNet,
against the JAX package on the CPU.

- Heads (hg1 of depth 2 and resnet18, 32 features, 64-px input, fp32, the
  same perturbed weights through ``pose_net_from_jax``): the model outputs
  (heatmaps rtol 1e-4 / atol 2e-4, as ``tests/test_torch_model.py``; fc
  coords atol 1e-5), and the port's loss, aux and decode on JAX's own
  outputs (rtol 1e-5; coords atol 1e-6; the gauss decode exactly).
- One fp64 train step per head (``port_helpers.fp64_train_step``, each
  package's ``pose_loss``): loss rtol 1e-8, grads rtol 1e-6 (atol 1e-9 of
  the largest), updated parameters rtol 1e-10 / atol 2e-9, as
  ``tests/test_torch_train_step.py``; for fc, whose maps pass through fp32
  in both packages, atol 1e-8 of the largest grad and 1e-6 on parameters.
- The port's ``make_train_fn`` step in fp32 against the JAX package's
  ``_build_step_bodies(...)[0]`` with ``port_helpers.jax_train_draws``:
  loss and the head's aux metrics rtol 1e-4, the same metric keys.
- The eval and infer steps with flip x 3 scales for gauss and fc (hg1 of
  depth 1, 32 px), at ``tests/test_torch_eval_driver.py``'s tolerances:
  loss rtol 1e-4, ``pred_orig`` atol 1e-2 px, PCKh counts equal.
- A resnet18/fc state through a checkpoint (bitwise), and the CLIs' train
  -> evaluate round trip of a tiny resnet18 --output-strat fc with
  --pretrained-resnet.
"""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsnt_pose2d_tpu.data.synthetic import make_synthetic_mpii as j_synth
from dsnt_pose2d_tpu.models import heads as jheads
from dsnt_pose2d_tpu.models.factory import build_pose_model as j_build
from dsnt_pose2d_tpu.parallel.mesh import make_mesh, replicated, shard_batch
from dsnt_pose2d_tpu.train import loop as jloop
from dsnt_pose2d_tpu.train.state import TrainState as JTrainState
from dsnt_pose2d_tpu.train.state import create_train_state as j_state
from dsnt_pose2d_tpu.train.state import make_optimizer as j_make_optimizer
from dsnt_pose2d_tpu.utils import config as jconfig
from dsnt_pose2d_tpu_torch.cli import evaluate, train
from dsnt_pose2d_tpu_torch.data.synthetic import make_synthetic_mpii
from dsnt_pose2d_tpu_torch.device import strict_fp32
from dsnt_pose2d_tpu_torch.models import heads as theads
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
from dsnt_pose2d_tpu_torch.models.from_jax import pose_net_from_jax
from dsnt_pose2d_tpu_torch.models.heads import PoseOutput
from dsnt_pose2d_tpu_torch.train import checkpoint as tckpt
from dsnt_pose2d_tpu_torch.train import loop as tloop
from dsnt_pose2d_tpu_torch.train.loop import (make_eval_fn, make_infer_fn,
                                             make_train_fn)
from dsnt_pose2d_tpu_torch.utils import config as tconfig
from port_helpers import fp64_train_step, jax_train_draws, perturb

J, SIZE, FEATS = 16, 64, 32
HEADS = {
    "hg1-gauss": ("hg1", dict(output_strat="gauss")),
    "hg1-gauss-normalized": ("hg1", dict(output_strat="gauss",
                                         gauss_target_normalize=True)),
    "hg1-fc": ("hg1", dict(output_strat="fc")),
    "hg1-fc-l1": ("hg1", dict(output_strat="fc", coord_loss="l1")),
    "resnet18-gauss": ("resnet18", dict(output_strat="gauss", dilate=1)),
    "resnet18-fc-mse": ("resnet18", dict(output_strat="fc", coord_loss="mse",
                                         dilate=2)),
    "hg1-dsnt-relu-l1-js": ("hg1", dict(preact="relu", coord_loss="l1",
                                        reg="js")),
    "hg1-dsnt-abs-mse-kl": ("hg1", dict(preact="abs", coord_loss="mse",
                                        reg="kl")),
    "resnet18-dsnt-sigmoid-var": ("resnet18", dict(preact="sigmoid", reg="var",
                                                   dilate=2)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model_kw(base, kw):
    return dict(base=base, input_size=SIZE, hg_features=FEATS, hg_depth=2, **kw)


@dataclasses.dataclass
class HeadCase:
    jcfg: object
    tcfg: object
    jmodel: object
    model: object
    out_j: object
    out_t: PoseOutput
    t: np.ndarray
    mask: np.ndarray


@pytest.fixture(scope="module", params=list(HEADS))
def head_case(request):
    base, kw = HEADS[request.param]
    jcfg = jconfig.ModelConfig(**_model_kw(base, kw), dtype="float32",
                               use_pallas=False)
    tcfg = tconfig.ModelConfig(**_model_kw(base, kw), dtype="float32")
    jmodel = j_build(jcfg)
    variables = perturb(jmodel.init_variables(jax.random.PRNGKey(0)), seed=2)
    model = build_pose_model(tcfg, device="cpu",
                             state_dict=pose_net_from_jax(variables, jcfg))
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(2, SIZE, SIZE, 3)) * 0.5).astype(np.float32)
    t = rng.uniform(-0.8, 0.8, size=(2, J, 2)).astype(np.float32)
    mask = (rng.uniform(size=(2, J)) > 0.25).astype(np.float32)
    out_j = jmodel.forward(variables, jnp.asarray(x))
    with torch.inference_mode(), strict_fp32():
        out_t = model.forward(torch.from_numpy(x))
    return HeadCase(jcfg, tcfg, jmodel, model, out_j, out_t, t, mask)


def test_head_outputs_match_jax(head_case):
    c = head_case
    hm_j = np.asarray(c.out_j.heatmaps)
    assert c.out_t.heatmaps.shape == hm_j.shape
    assert hm_j.shape[-1] == c.model.heatmap_size
    np.testing.assert_allclose(c.out_t.heatmaps.numpy(), hm_j, rtol=1e-4, atol=2e-4)
    if c.tcfg.output_strat == "fc":
        fc_j = np.asarray(c.out_j.fc_coords)
        assert c.out_t.fc_coords.shape == fc_j.shape == (*hm_j.shape[:3], 2)
        np.testing.assert_allclose(c.out_t.fc_coords.numpy(), fc_j, rtol=1e-4,
                                   atol=1e-5)
    else:
        assert c.out_t.fc_coords is None and c.out_j.fc_coords is None


def test_head_loss_aux_and_decode_match_jax(head_case):
    # The port's head on JAX's own outputs: the head alone is compared.
    c = head_case
    out = PoseOutput(torch.from_numpy(np.asarray(c.out_j.heatmaps)),
                     None if c.out_j.fc_coords is None
                     else torch.from_numpy(np.asarray(c.out_j.fc_coords)))
    loss_j, aux_j = jheads.pose_loss(c.out_j, jnp.asarray(c.t), jnp.asarray(c.mask),
                                     c.jcfg)
    loss_t, aux_t = theads.pose_loss(out, torch.from_numpy(c.t),
                                     torch.from_numpy(c.mask), c.tcfg)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    assert set(aux_t) == set(aux_j)
    for k, v in aux_j.items():
        atol = 1e-6 if k == "coords" else 0.0
        np.testing.assert_allclose(aux_t[k].numpy(), np.asarray(v), rtol=1e-5,
                                   atol=atol, err_msg=k)
    dec_j = np.asarray(jheads.decode_coords(c.out_j, c.jcfg))
    dec_t = theads.decode_coords(out, c.tcfg).numpy()
    if c.tcfg.output_strat == "gauss":
        np.testing.assert_array_equal(dec_t, dec_j)
    else:
        np.testing.assert_allclose(dec_t, dec_j, rtol=0, atol=1e-6)


# -- one fp64 train step per head -------------------------------------------

STEP64 = {"gauss-hg1": dict(base="hg1", output_strat="gauss"),
          "fc-hg1": dict(base="hg1", output_strat="fc", coord_loss="l1"),
          "fc-resnet18": dict(base="resnet18", dilate=2, output_strat="fc")}


@pytest.fixture(scope="module", params=list(STEP64))
def step64(request):
    kw = {**STEP64[request.param], "input_size": SIZE, "hg_features": FEATS,
          "hg_depth": 2}
    return fp64_train_step(kw, (jheads.pose_loss, theads.pose_loss))


def test_fp64_step_loss_and_aux(step64):
    got, exp = step64
    np.testing.assert_allclose(got.loss, exp.loss, rtol=1e-8)
    assert set(got.aux) == set(exp.aux)
    for k in got.aux:
        if k != "coords":
            np.testing.assert_allclose(got.aux[k], exp.aux[k], rtol=1e-8, err_msg=k)


def test_fp64_step_every_grad_and_update(step64, request):
    # The fc head takes the flat maps in fp32 in both packages (the JAX
    # package's PoseNet casts them), so the maps' cotangent passes through
    # fp32 there: its rounding of values that differ in the 16th digit can
    # flip by an ulp, which moves the backbone's grads by up to 3.7e-9 of the
    # largest (``port_helpers.fp64_train_step`` on the fc-hg1 case).
    # RMSProp's first step, lr g / (0.1 |g| + eps), is steep in g where
    # |g| ~ eps: there it moved by up to 4.8e-7 (the full step is 2.5e-3).
    # For fc: grads atol 1e-8 of the largest, parameters atol 1e-6.
    got, exp = step64
    fc = "fc" in request.node.callspec.id
    gmax = max(np.abs(exp.grads[n]).max() for n in got.grads)
    assert set(got.grads) <= set(exp.grads) and len(got.grads) > 20
    for name, g in got.grads.items():
        np.testing.assert_allclose(g, exp.grads[name], rtol=1e-6,
                                   atol=(1e-8 if fc else 1e-9) * gmax,
                                   err_msg=name)
        np.testing.assert_allclose(got.after[name], exp.after[name],
                                   rtol=1e-10, atol=1e-6 if fc else 2e-9,
                                   err_msg=name)


# -- the port's fp32 train step against the JAX package's ----------------------

STEP32 = {"gauss-hg1": dict(base="hg1", output_strat="gauss"),
          "fc-resnet18": dict(base="resnet18", dilate=1, output_strat="fc"),
          "dsnt-resnet18": dict(base="resnet18", dilate=1, reg="js",
                                use_pallas=True)}


@pytest.fixture(scope="module", params=list(STEP32))
def step32(request):
    kw = {"input_size": SIZE, "hg_features": FEATS, "hg_depth": 2,
          "dtype": "float32", "use_pallas": False, **STEP32[request.param]}
    jcfg = jconfig.Config(model=jconfig.ModelConfig(**kw),
                          data=jconfig.DataConfig(warp_method="shear"))
    tcfg = tconfig.config_from_json(jconfig.config_to_json(jcfg))
    jmodel = j_build(jcfg.model)
    variables = perturb(jmodel.init_variables(jax.random.PRNGKey(0)))
    batch = j_synth(4, 96, seed=3)
    tx = j_make_optimizer(jcfg.optim, 1, jcfg.train.epochs)
    key = jax.random.PRNGKey(5)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                        batch_stats=variables["batch_stats"],
                        opt_state=tx.init(variables["params"]), rng=key)
    _, metrics = jax.jit(jloop._build_step_bodies(jmodel, jcfg)[0])(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    draws = jax_train_draws(jax.random.fold_in(key, 0), 4, jcfg.data)
    model = build_pose_model(tcfg.model, device="cpu",
                             state_dict=pose_net_from_jax(variables, jcfg.model))
    got = make_train_fn(model, tcfg, device="cpu")(
        batch, draws={k: None if v is None else torch.from_numpy(v)
                      for k, v in draws.items()})
    return got, jax.device_get(metrics)


def test_fp32_step_metrics_match_jax(step32):
    got, exp = step32
    assert set(got) == set(exp)
    for k in set(exp) - {"grad_norm"}:
        np.testing.assert_allclose(got[k].numpy(), exp[k], rtol=1e-4, err_msg=k)
    assert np.isfinite(got["grad_norm"].item()) and got["grad_norm"].item() > 0


# -- eval with flip x 3 scales ------------------------------------------------

EVAL_BATCH = j_synth(6, 48, seed=3)


@pytest.fixture(scope="module", params=["gauss", "fc"])
def flip_scales(request):
    jcfg = jconfig.Config(
        model=jconfig.ModelConfig(base="hg1", hg_features=FEATS, hg_depth=1,
                                  input_size=32, dtype="float32",
                                  output_strat=request.param, use_pallas=False),
        data=jconfig.DataConfig(warp_method="shear"),
        train=jconfig.TrainConfig(batch_size=4, flip_eval=True,
                                  eval_scales=(0.9, 1.0, 1.1)))
    tcfg = tconfig.config_from_json(jconfig.config_to_json(jcfg))
    jmodel, mesh = j_build(jcfg.model), make_mesh(1)
    variables = perturb(jmodel.init_variables(jax.random.PRNGKey(0)), seed=1)
    state = j_state(jmodel, jconfig.OptimConfig(), jax.random.PRNGKey(0),
                    batch_size=2).replace(params=variables["params"],
                                          batch_stats=variables["batch_stats"])
    state = jax.device_put(state, replicated(mesh))
    dev_batch = shard_batch(mesh, EVAL_BATCH)
    exp = jax.device_get(jloop.make_eval_fn(jmodel, jcfg, mesh)(state, dev_batch))
    exp_infer = np.asarray(jax.device_get(
        jloop.make_infer_fn(jmodel, jcfg, mesh)(state, dev_batch)))
    model = build_pose_model(tcfg.model, device="cpu",
                             state_dict=pose_net_from_jax(variables, jcfg.model))
    with strict_fp32():
        got = make_eval_fn(model, tcfg, device="cpu")(EVAL_BATCH)
        got_infer = make_infer_fn(model, tcfg, device="cpu")(EVAL_BATCH)
    return got, exp, got_infer, exp_infer


def test_flip_scales_eval_matches_jax(flip_scales):
    got, exp, got_infer, exp_infer = flip_scales
    np.testing.assert_allclose(got["loss"].numpy(), exp["loss"], rtol=1e-4)
    assert got["pred_orig"].shape == (6, 16, 2)
    np.testing.assert_allclose(got["pred_orig"].numpy(), exp["pred_orig"],
                               atol=1e-2, rtol=0)
    np.testing.assert_array_equal(got["pckh_correct"].numpy(), exp["pckh_correct"])
    np.testing.assert_array_equal(got["pckh_total"].numpy(), exp["pckh_total"])
    np.testing.assert_allclose(got_infer.numpy(), exp_infer, atol=1e-2, rtol=0)


# -- checkpoint and CLI round trips --------------------------------------------

def _resnet_fc_config():
    return tconfig.Config(
        model=tconfig.ModelConfig(base="resnet18", dilate=2, input_size=SIZE,
                                  dtype="float32", output_strat="fc"),
        train=tconfig.TrainConfig(batch_size=4, epochs=2))


def test_resnet_fc_state_round_trips_a_checkpoint(tmp_path):
    cfg = _resnet_fc_config()
    step = make_train_fn(build_pose_model(cfg.model, device="cpu", seed=0), cfg,
                         device="cpu")
    for s in range(2):
        step(make_synthetic_mpii(4, 96, seed=s))
    mgr = tckpt.CheckpointManager(str(tmp_path), cfg)
    mgr.save(0, step.state)
    fresh = make_train_fn(build_pose_model(cfg.model, device="cpu", seed=1), cfg,
                          device="cpu")
    state, _ = mgr.restore(fresh.state)
    a, b = step.state.model.net.state_dict(), state.model.net.state_dict()
    assert list(a) == list(b) and "fc_head_kernel" in a
    for k in a:
        assert torch.equal(a[k], b[k]), k
    oa = step.state.optimizer.optimizer.state_dict()["state"]
    ob = state.optimizer.optimizer.state_dict()["state"]
    assert len(oa) == len(ob) > 60
    for i in oa:
        for k, v in oa[i].items():
            assert torch.equal(v, ob[i][k]), (i, k)
    batch = make_synthetic_mpii(4, 96, seed=9)
    ea = make_eval_fn(step.state.model, cfg, device="cpu")(batch)
    eb = make_eval_fn(state.model, cfg, device="cpu")(batch)
    for k in ea:
        assert torch.equal(ea[k], eb[k]), k


def _torchvision_names(port_sd: dict) -> dict:
    """A ResNet ``PoseNet`` state dict under torchvision's names (the
    backbone less its score conv), as a torchvision checkpoint holds it."""
    out = {}
    for k, v in port_sd.items():
        if not k.startswith("backbone.") or ".score." in k:
            continue
        k = k.removeprefix("backbone.")
        if k.endswith("num_batches_tracked"):
            continue
        k = k.replace("stem_conv", "conv1").replace("stem_bn", "bn1")
        if k.startswith("stage"):
            block, rest = k.split(".", 1)
            s, b = block.removeprefix("stage").split("_block")
            rest = rest.replace("bn_proj", "downsample.1").replace("proj", "downsample.0")
            k = f"layer{int(s) + 1}.{b}.{rest}"
        out[k] = v.numpy()
    return out


TINY = ["--device", "cpu", "--base-model", "resnet18", "--dilate", "2",
        "--output-strat", "fc", "--input-size", "64", "--dtype", "float32",
        "--data-source", "synthetic", "--synthetic-size", "16",
        "--batch-size", "4", "--lr", "1e-3", "--workers", "2"]


class _RecordingDriver(tloop.EvalDriver):
    runs: list = []

    def evaluate(self, *args, **kw):
        result = super().evaluate(*args, **kw)
        _RecordingDriver.runs.append(result)
        return result


def test_resnet_fc_cli_train_evaluate_round_trip(tmp_path, monkeypatch):
    weights = tmp_path / "resnet18.npz"
    donor = build_pose_model(tconfig.ModelConfig(base="resnet18", dtype="float32"),
                             device="cpu", seed=3)
    np.savez(weights, **_torchvision_names(donor.net.state_dict()))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed), contextlib.redirect_stderr(io.StringIO()):
        assert train.main(TINY + ["--epochs", "1", "--out-dir", str(tmp_path),
                                  "--experiment-id", "fc",
                                  "--pretrained-resnet", str(weights)]) == 0
    assert f"pretrained_resnet: loaded {weights}" in printed.getvalue()
    exp_dir = tmp_path / "fc"
    cfg = tconfig.config_from_json((exp_dir / "config.json").read_text())
    assert (cfg.model.base, cfg.model.output_strat, cfg.data.pretrained_resnet) == (
        "resnet18", "fc", str(weights))
    with open(exp_dir / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    summary = [r for r in records if "step" not in r][-1]
    steps = [r for r in records if "step" in r]
    assert steps and all("euclidean" in r and "reg" not in r for r in steps)
    monkeypatch.setattr(evaluate, "EvalDriver", _RecordingDriver)
    _RecordingDriver.runs = []
    with contextlib.redirect_stdout(io.StringIO()):
        assert evaluate.main(["--model-dir", str(exp_dir), "--device", "cpu",
                              "--data-source", "synthetic",
                              "--synthetic-size", "16"]) == 0
    (result,) = _RecordingDriver.runs
    assert result["pckh"] == summary["val_pckh"]
    np.testing.assert_allclose(result["loss"], summary["val_loss"], rtol=1e-6)
