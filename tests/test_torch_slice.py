"""The whole ported slice: the port's eval step against the JAX eval body
(``train/loop.py::_build_eval_body``) on identical weights and batch.

CI scale: 2 stacks, 32 features, 64-px input, 96-px synthetic canvases,
batch 4, fp32, fused head on (JAX: Pallas in interpret mode; port: the
head's plain version, which CPU tensors run) and the shear warp.
Tolerances: loss rtol 1e-4 (8 conv layers deep of fp32 sums in different
orders, then a sum over stacks); ``pred_orig`` atol 1e-2 original px (the
PCKh threshold here is 0.5 * 11.5 px); PCKh counts exactly equal.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsnt_pose2d_tpu.data.synthetic import make_synthetic_mpii as j_synth
from dsnt_pose2d_tpu.evaluation.pckh import PCKhEvaluator as JPCKhEvaluator
from dsnt_pose2d_tpu.models.factory import build_pose_model as j_build
from dsnt_pose2d_tpu.train import loop as jloop
from dsnt_pose2d_tpu.utils import config as jconfig
from dsnt_pose2d_tpu_torch.device import strict_fp32
from dsnt_pose2d_tpu_torch.evaluation.pckh import PCKhEvaluator
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
from dsnt_pose2d_tpu_torch.models.from_jax import hourglass_from_jax
from dsnt_pose2d_tpu_torch.train.loop import make_eval_fn, make_infer_fn
from dsnt_pose2d_tpu_torch.utils import config as tconfig

MODEL_KW = dict(base="hg2", hg_features=32, input_size=64, dtype="float32",
                reg="js", use_pallas=True)


def _perturb(variables, seed=0):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.array(x)
        if path[-1].key == "mean":
            return x + rng.normal(0, 0.1, x.shape).astype(np.float32)
        if path[-1].key in ("var", "scale"):
            return x * rng.uniform(0.6, 1.4, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


@pytest.fixture(scope="module")
def slice_run():
    jcfg = jconfig.Config(model=jconfig.ModelConfig(**MODEL_KW),
                          data=jconfig.DataConfig(warp_method="shear"))
    tcfg = tconfig.config_from_json(jconfig.config_to_json(jcfg))
    jmodel = j_build(jcfg.model)
    variables = _perturb(jmodel.init_variables(jax.random.PRNGKey(0)))
    batch = j_synth(4, 96, seed=3)
    state = SimpleNamespace(params=variables["params"],
                            batch_stats=variables["batch_stats"])
    eval_body = jloop._build_eval_body(jmodel, jcfg)[1]
    exp = jax.device_get(eval_body(
        state, {k: jnp.asarray(v) for k, v in batch.items()}))

    model = build_pose_model(tcfg.model, device="cpu",
                             state_dict=hourglass_from_jax(variables, 2))
    with strict_fp32():
        got = make_eval_fn(model, tcfg, device="cpu")(batch)
        served = make_infer_fn(model, tcfg, device="cpu")(batch)
    return got, exp, served, batch


def test_eval_step_loss_matches_jax(slice_run):
    got, exp, _, _ = slice_run
    assert got["loss"].shape == ()
    np.testing.assert_allclose(got["loss"].numpy(), exp["loss"], rtol=1e-4)


def test_eval_step_pred_orig_matches_jax(slice_run):
    got, exp, _, _ = slice_run
    assert got["pred_orig"].shape == (4, 16, 2)
    np.testing.assert_allclose(got["pred_orig"].numpy(), exp["pred_orig"],
                               atol=1e-2, rtol=0)


def test_eval_step_pckh_counts_match_jax(slice_run):
    got, exp, _, _ = slice_run
    np.testing.assert_array_equal(got["pckh_correct"].numpy(),
                                  exp["pckh_correct"])
    np.testing.assert_array_equal(got["pckh_total"].numpy(), exp["pckh_total"])


def test_infer_step_matches_eval_step(slice_run):
    got, _, served, _ = slice_run
    assert torch.equal(served, got["pred_orig"])


def test_pckh_evaluator_matches_jax(slice_run):
    got, exp, _, batch = slice_run
    je, te = JPCKhEvaluator(), PCKhEvaluator()
    rng = np.random.default_rng(0)
    pred = batch["coords_px"] + rng.normal(0, 8, batch["coords_px"].shape)
    for ev in (je, te):
        ev.add(pred.astype(np.float32), batch["coords_px"], batch["mask"],
               batch["head_length"])
        ev.add_counts(np.asarray(exp["pckh_correct"]),
                      np.asarray(exp["pckh_total"]))
    np.testing.assert_array_equal(te.correct, je.correct)
    np.testing.assert_array_equal(te.total, je.total)
    assert te.groups() == je.groups()
    assert te.total_pckh() == je.total_pckh()
    assert te.total_pckh_all() == je.total_pckh_all()
