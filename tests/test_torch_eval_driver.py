"""Flip and multi-scale eval, ``EvalDriver`` and ``global_index_batches``:
the port against the JAX package on the CPU.

CI scale: hg1 of depth 1, 32 features, 32-px input, fp32, JS head (JAX:
its plain ops head, ``use_pallas=False``, the Pallas kernel's reference;
port: the fused head, whose plain version CPU tensors run), shear warp,
48-px synthetic canvases, the same
(perturbed) weights converted with ``models/from_jax.py``.  The eval and
infer steps are compared for ``flip_eval`` in {False, True} x ``eval_scales``
in {(1.0,), (0.9, 1.0, 1.1)}, at the tolerances of
``tests/test_torch_slice.py``: loss rtol 1e-4, ``pred_orig`` atol 1e-2
original px, PCKh counts equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dsnt_pose2d_tpu.data import ArrayDataset as JArrayDataset
from dsnt_pose2d_tpu.data import ShardedLoader as JShardedLoader
from dsnt_pose2d_tpu.data.synthetic import make_synthetic_mpii as j_synth
from dsnt_pose2d_tpu.models.factory import build_pose_model as j_build
from dsnt_pose2d_tpu.parallel.mesh import make_mesh, replicated, shard_batch
from dsnt_pose2d_tpu.train import loop as jloop
from dsnt_pose2d_tpu.train.state import create_train_state as j_state
from dsnt_pose2d_tpu.utils import config as jconfig
from dsnt_pose2d_tpu_torch.data.loader import ShardedLoader
from dsnt_pose2d_tpu_torch.data.mpii import ArrayDataset
from dsnt_pose2d_tpu_torch.device import strict_fp32
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
from dsnt_pose2d_tpu_torch.models.from_jax import hourglass_from_jax
from dsnt_pose2d_tpu_torch.train.checkpoint import CheckpointManager
from dsnt_pose2d_tpu_torch.train.loop import (EvalDriver, make_eval_fn,
                                             make_infer_fn)
from dsnt_pose2d_tpu_torch.utils import config as tconfig
from port_helpers import perturb

LOSS_RTOL = 1e-4
PRED_ATOL_PX = 1e-2
MODEL = jconfig.ModelConfig(base="hg1", hg_features=32, hg_depth=1,
                            input_size=32, dtype="float32", reg="js",
                            use_pallas=False)
BATCH = j_synth(6, 48, seed=3)
SPLIT = j_synth(13, 48, seed=4)     # batch 4: three full batches + 1 row
CASES = {"single": (False, (1.0,)), "flip": (True, (1.0,)),
         "scales": (False, (0.9, 1.0, 1.1)), "flip_scales": (True, (0.9, 1.0, 1.1))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Tiny models run faster on one intra-op thread, and parallel test
    # workers share the host's cores: more threads only contend.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _configs(flip=False, scales=(1.0,), batch_size=4):
    jcfg = jconfig.Config(model=MODEL,
                          data=jconfig.DataConfig(warp_method="shear"),
                          train=jconfig.TrainConfig(batch_size=batch_size,
                                                    flip_eval=flip,
                                                    eval_scales=scales))
    tcfg = tconfig.config_from_json(jconfig.config_to_json(jcfg))
    return jcfg, dataclasses.replace(
        tcfg, model=dataclasses.replace(tcfg.model, use_pallas=True))


@pytest.fixture(scope="module")
def weights():
    jmodel = j_build(MODEL)
    return perturb(jmodel.init_variables(jax.random.PRNGKey(0)), seed=1)


def _jax_state(jmodel, variables, mesh):
    state = j_state(jmodel, jconfig.OptimConfig(), jax.random.PRNGKey(0),
                    batch_size=2)
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"])
    return jax.device_put(state, replicated(mesh))


def _port_model(variables, cfg, seed=0):
    return build_pose_model(cfg.model, device="cpu", seed=seed,
                            state_dict=hourglass_from_jax(variables, 1, depth=1))


@pytest.fixture(scope="module", params=list(CASES))
def case(request, weights):
    flip, scales = CASES[request.param]
    jcfg, tcfg = _configs(flip, scales)
    jmodel, mesh = j_build(jcfg.model), make_mesh(1)
    state = _jax_state(jmodel, weights, mesh)
    dev_batch = shard_batch(mesh, BATCH)
    exp = jax.device_get(jloop.make_eval_fn(jmodel, jcfg, mesh)(state, dev_batch))
    exp_infer = np.asarray(jax.device_get(
        jloop.make_infer_fn(jmodel, jcfg, mesh)(state, dev_batch)))
    model = _port_model(weights, tcfg)
    with strict_fp32():
        got = make_eval_fn(model, tcfg, device="cpu")(BATCH)
        got_infer = make_infer_fn(model, tcfg, device="cpu")(BATCH)
    return got, exp, got_infer, exp_infer


def test_eval_loss_matches_jax(case):
    got, exp, _, _ = case
    np.testing.assert_allclose(got["loss"].numpy(), exp["loss"], rtol=LOSS_RTOL)


def test_eval_pred_orig_matches_jax(case):
    got, exp, _, _ = case
    assert got["pred_orig"].shape == (6, 16, 2)
    np.testing.assert_allclose(got["pred_orig"].numpy(), exp["pred_orig"],
                               atol=PRED_ATOL_PX, rtol=0)


def test_eval_pckh_counts_match_jax(case):
    got, exp, _, _ = case
    np.testing.assert_array_equal(got["pckh_correct"].numpy(), exp["pckh_correct"])
    np.testing.assert_array_equal(got["pckh_total"].numpy(), exp["pckh_total"])


def test_infer_step_matches_jax(case):
    got, _, got_infer, exp_infer = case
    np.testing.assert_allclose(got_infer.numpy(), exp_infer, atol=PRED_ATOL_PX,
                               rtol=0)
    # The serving step's average is the eval step's, pass for pass.
    torch.testing.assert_close(got_infer, got["pred_orig"], atol=1e-4, rtol=0)


def test_multi_scale_eval_invariants(weights):
    # The port's counterpart of tests/test_train.py::test_multi_scale_eval:
    # (1.0,) is bitwise the default single pass; a repeated scale averages
    # identical predictions; extra scales leave the (canonical) loss alone.
    def run(scales):
        _, tcfg = _configs(scales=scales)
        with strict_fp32():
            return make_eval_fn(_port_model(weights, tcfg), tcfg, device="cpu")(BATCH)

    default_cfg = _configs()[1]
    default_cfg = dataclasses.replace(
        default_cfg, train=dataclasses.replace(default_cfg.train, eval_scales=()))
    with strict_fp32():
        default = make_eval_fn(_port_model(weights, default_cfg), default_cfg,
                               device="cpu")(BATCH)
    base, dup, multi = run((1.0,)), run((1.0, 1.0)), run((0.9, 1.0, 1.1))
    for k in ("loss", "pred_orig", "pckh_correct", "pckh_total"):
        assert torch.equal(base[k], default[k]), k
    assert torch.equal(base["pred_orig"], dup["pred_orig"])
    assert base["loss"].item() == multi["loss"].item()
    assert torch.isfinite(multi["pred_orig"]).all()
    assert not torch.equal(base["pred_orig"], multi["pred_orig"])
    assert (multi["pred_orig"] - base["pred_orig"]).abs().median().item() < 24


def test_flip_pass_flips_the_width_axis(weights):
    # The flip-averaged decode is the mean of the plain decode and the
    # decode of the images mirrored along their width (NHWC dim 2), with x
    # negated and the L/R joints swapped.
    from dsnt_pose2d_tpu_torch.data.transforms import flip_permutation
    from dsnt_pose2d_tpu_torch.train.loop import _decode_averaged

    _, tcfg = _configs(flip=True)
    model = _port_model(weights, tcfg)
    images = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        _, averaged = _decode_averaged(model, tcfg, images)
        plain = model.decode(model.forward(images))
        mirrored = model.decode(model.forward(images.flip(2)))
    mirrored = torch.stack([-mirrored[..., 0], mirrored[..., 1]], -1)
    torch.testing.assert_close(averaged, 0.5 * (plain + mirrored[:, flip_permutation()]),
                               atol=0, rtol=0)


# -- EvalDriver ---------------------------------------------------------------


def _jax_driver(weights, jcfg, shuffle=False):
    jmodel, mesh = j_build(jcfg.model), make_mesh(1)
    loader = JShardedLoader(JArrayDataset(SPLIT), 4, shuffle=shuffle, seed=5,
                            drop_last=False)
    driver = jloop.EvalDriver(model=jmodel, cfg=jcfg, mesh=mesh, loader=loader)
    state = driver.init_state().replace(params=weights["params"],
                                        batch_stats=weights["batch_stats"])
    return driver, jax.device_put(state, replicated(mesh))


def _port_driver(weights, tcfg, shuffle=False, seed=0):
    loader = ShardedLoader(ArrayDataset(SPLIT), 4, shuffle=shuffle, seed=5,
                           drop_last=False)
    return EvalDriver(model=_port_model(weights, tcfg, seed), cfg=tcfg,
                      loader=loader, device="cpu")


@pytest.fixture(scope="module")
def driver_runs(weights):
    jcfg, tcfg = _configs(*CASES["flip"])
    jdriver, jstate = _jax_driver(weights, jcfg, shuffle=True)
    exp_preds = jdriver.predict(jstate)
    exp_eval = jdriver.evaluate(jstate)
    with strict_fp32():
        tdriver = _port_driver(weights, tcfg, shuffle=True)
        got_preds = tdriver.predict(tdriver.init_state())
        got_eval = tdriver.evaluate()
        ordered = _port_driver(weights, tcfg).predict()
    return got_preds, exp_preds, got_eval, exp_eval, ordered


def test_predict_matches_jax_in_dataset_order(driver_runs, weights):
    got, exp, _, _, ordered = driver_runs
    assert got.shape == exp.shape == (13, 16, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, exp, atol=PRED_ATOL_PX, rtol=0)
    # A shuffled loader scatters back to the same rows as an ordered one,
    # and the ragged tail's one real row is the row's own prediction.
    np.testing.assert_allclose(got, ordered, atol=1e-4, rtol=0)
    _, tcfg = _configs(*CASES["flip"])
    with strict_fp32():
        row = make_infer_fn(_port_model(weights, tcfg), tcfg, device="cpu")(
            {k: v[12:13] for k, v in SPLIT.items()})
    np.testing.assert_allclose(got[12], row[0].numpy(), atol=1e-4, rtol=0)


def test_driver_evaluate_matches_jax(driver_runs):
    _, _, got, exp, _ = driver_runs
    np.testing.assert_allclose(got["loss"], exp["loss"], rtol=LOSS_RTOL)
    np.testing.assert_array_equal(got["evaluator"].correct, exp["evaluator"].correct)
    np.testing.assert_array_equal(got["evaluator"].total, exp["evaluator"].total)
    assert got["evaluator"].total.sum() == SPLIT["mask"].sum()


def test_predict_writes_nan_predictions_out(weights):
    # A diverged model's NaN coordinates are written, not taken for rows
    # the pass missed: every row covered, every value NaN, as in JAX.
    nan_weights = jax.tree_util.tree_map(lambda x: np.full_like(x, np.nan),
                                         weights)
    jcfg, tcfg = _configs()
    jdriver, jstate = _jax_driver(nan_weights, jcfg)
    exp = jdriver.predict(jstate)
    got = _port_driver(nan_weights, tcfg).predict()
    assert got.shape == exp.shape == (13, 16, 2)
    assert np.isnan(exp).all() and np.isnan(got).all()


def test_evaluate_after_restore_scores_the_restored_weights(tmp_path, weights):
    _, tcfg = _configs()
    trained = _port_driver(weights, tcfg)          # the weights to save
    ckpt = CheckpointManager(str(tmp_path / "exp"), tcfg)
    ckpt.save(0, trained.init_state(), is_best=True)

    fresh = EvalDriver(model=build_pose_model(tcfg.model, device="cpu", seed=3),
                       cfg=tcfg, loader=trained.loader, device="cpu")
    with strict_fp32():
        template = fresh.evaluate()
        restored, meta = ckpt.restore(fresh.init_state(), epoch=ckpt.best_epoch())
        assert restored is fresh.init_state() and meta["epoch"] == 0
        after = fresh.evaluate(restored)
        expected = trained.evaluate()
    assert after["loss"] == expected["loss"]
    np.testing.assert_array_equal(after["evaluator"].correct,
                                  expected["evaluator"].correct)
    assert after["loss"] != template["loss"]
    other = _port_driver(weights, tcfg).init_state()
    with pytest.raises(ValueError, match="own state"):
        fresh.evaluate(other)
    with pytest.raises(ValueError, match="own state"):
        fresh.predict(other)


# -- global_index_batches -----------------------------------------------------


@pytest.mark.parametrize("n,bs,shuffle,drop_last", [
    (13, 4, False, False), (13, 4, True, False), (13, 4, True, True),
    (12, 4, True, False), (3, 4, False, False)])
def test_global_index_batches_match_jax(n, bs, shuffle, drop_last):
    data = {"x": np.arange(n, dtype=np.float32)}
    jl = JShardedLoader(JArrayDataset(data), bs, shuffle=shuffle, seed=7,
                        drop_last=drop_last)
    tl = ShardedLoader(ArrayDataset(data), bs, shuffle=shuffle, seed=7,
                       drop_last=drop_last)
    for epoch in (0, 1):
        got, exp = tl.global_index_batches(epoch), jl.global_index_batches(epoch)
        assert len(got) == len(exp) == tl.steps_per_epoch
        for g, e in zip(got, exp):
            assert g.dtype == e.dtype
            np.testing.assert_array_equal(g, e)
        # The map names the rows each batch of epoch() holds.
        for g, b in zip(got, tl.epoch(epoch)):
            keep = g >= 0
            np.testing.assert_array_equal(b["x"][keep], data["x"][g[keep]])
