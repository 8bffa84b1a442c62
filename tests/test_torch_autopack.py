"""The Trainer's auto-pack, the port against the JAX package on the CPU.

The counterpart of ``tests/test_pack.py::test_trainer_autopack_swaps_to_resident``
(marked slow there), held against the JAX ``Trainer``: both train a tiny
hg1 (depth 1, 8 features, 32-px input) for 2 epochs of 2 steps on a
decode-backed 8-row MPII layout (JPEGs and h5 annotations, one copy per
package, 64-px canvases) with ``auto_pack`` on, ``device_resident`` auto and
``steps_per_dispatch`` 2.  Epoch 0 streams single steps while the archive is
written; the epoch boundary publishes it and epoch 1 runs one resident
2-step dispatch.  The augmentation is deterministic and the optimizer SGD
with momentum, as in ``tests/test_torch_trainer.py``, whose tolerances
(losses rtol 5e-5, grad norm 2e-2) this file keeps: a swap that restarted
the optimizer would lose the momentum and move epoch 1's loss by far more.
"""

import shutil

import jax
import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from dsnt_pose2d_tpu.data import ShardedLoader as JShardedLoader
from dsnt_pose2d_tpu.data.mpii import MPIIDataset as JMPIIDataset
from dsnt_pose2d_tpu.data.pack import PackedDataset as JPackedDataset
from dsnt_pose2d_tpu.models.factory import build_pose_model as j_build
from dsnt_pose2d_tpu.parallel.mesh import make_mesh
from dsnt_pose2d_tpu.train import loop as jloop
from dsnt_pose2d_tpu.utils import config as jconfig
from dsnt_pose2d_tpu_torch.data.loader import ShardedLoader
from dsnt_pose2d_tpu_torch.data.mpii import MPIIDataset
from dsnt_pose2d_tpu_torch.data.pack import (AutoPackDataset, PackedDataset,
                                             packed_available)
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
from dsnt_pose2d_tpu_torch.models.from_jax import hourglass_from_jax
from dsnt_pose2d_tpu_torch.train.loop import Trainer
from dsnt_pose2d_tpu_torch.utils import config as tconfig
from test_torch_host_data import _archive, _assert_archives_equal, _write_layout

LOSS_RTOL = 5e-5
GRAD_NORM_RTOL = 2e-2   # flax's fp32 BN statistics (tests/test_torch_trainer.py)
ROWS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Tiny models run faster on one intra-op thread, and parallel test
    # workers share the host's cores: more threads only contend.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



class _Records:
    """A metric writer that keeps the records in memory."""

    path = None

    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append(dict(record))


def _jax_config(root: str) -> jconfig.Config:
    return jconfig.Config(
        model=jconfig.ModelConfig(base="hg1", reg="js", hg_features=8,
                                  hg_depth=1, input_size=32, dtype="float32",
                                  use_pallas=False),
        optim=jconfig.OptimConfig(optimizer="sgd", lr=1e-3, momentum=0.9,
                                  schedule="constant"),
        data=jconfig.DataConfig(data_dir=root, canvas_size=64, mean=(0, 0, 0),
                                std=(1, 1, 1), color_jitter=0.0,
                                max_rotation_deg=0.0, scale_range=(1.0, 1.0),
                                flip_prob=0.0, device_resident="auto"),
        train=jconfig.TrainConfig(batch_size=4, epochs=2, seed=0, donate=False,
                                  log_every_steps=1, steps_per_dispatch=2))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("autopack")
    layout = _write_layout(base / "layout", "annot/", np.random.default_rng(21),
                           n=ROWS, split_method="hash-holdout:0.1")
    roots = {}
    for name in ("jax", "torch"):
        roots[name] = str(base / name)
        shutil.copytree(layout, roots[name])
    jcfg = _jax_config(roots["jax"])
    tcfg = tconfig.config_from_json(jconfig.config_to_json(
        _jax_config(roots["torch"])))

    jw = _Records()
    jt = jloop.Trainer(
        model=j_build(jcfg.model), cfg=jcfg, mesh=make_mesh(1),
        train_loader=JShardedLoader(JMPIIDataset(roots["jax"], "train",
                                                 canvas_size=64), 4,
                                    shuffle=True, seed=0),
        metric_writer=jw)
    assert jt._autopack is not None and jt.resident is None
    state = jt.init_state()
    variables = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    jt.run(state)

    model = build_pose_model(
        tcfg.model, device="cpu",
        state_dict={k: torch.from_numpy(np.array(v)) for k, v in
                    hourglass_from_jax(variables, 1, depth=1).items()})
    tw = _Records()
    tt = Trainer(model=model, cfg=tcfg,
                 train_loader=ShardedLoader(MPIIDataset(roots["torch"], "train",
                                                        canvas_size=64), 4,
                                            shuffle=True, seed=0, workers=2),
                 metric_writer=tw, device="cpu")
    before = {"autopack": tt._autopack, "resident": tt.resident,
              "resident_multi": tt.resident_multi,
              "dataset": tt.train_loader.dataset}
    tstate, _ = tt.run()
    return {"jax": jt, "torch": tt, "jax_records": jw.records,
            "torch_records": tw.records, "before": before, "state": tstate,
            "roots": roots, "layout": layout}


def test_epoch0_streams_and_writes_the_archive(runs):
    before = runs["before"]
    assert isinstance(before["autopack"], AutoPackDataset)
    assert before["dataset"] is before["autopack"]
    assert before["resident"] is None and before["resident_multi"] is None
    for name in ("jax", "torch"):
        assert packed_available(runs["roots"][name], "train")
    # The two packages' archives, and the archive against the decoded rows.
    _assert_archives_equal(_archive(f"{runs['roots']['torch']}/packed"),
                           _archive(f"{runs['roots']['jax']}/packed"))
    packed = PackedDataset(f"{runs['roots']['torch']}/packed", "train")
    raw = MPIIDataset(runs["layout"], "train", canvas_size=64)
    assert len(packed) == ROWS and packed.split_method == "hash-holdout:0.1"
    for i in range(ROWS):
        for k, v in raw[i].items():
            np.testing.assert_array_equal(packed[i][k], v, err_msg=k)


def test_epoch1_trains_resident_from_the_archive(runs):
    tt, jt = runs["torch"], runs["jax"]
    assert tt._autopack is None and jt._autopack is None
    assert isinstance(tt.train_loader.dataset, PackedDataset)
    assert isinstance(jt.train_loader.dataset, JPackedDataset)
    assert tt.resident is not None and tt.resident_multi is not None
    assert (tt.train_loader.batch_size, tt.train_loader.shuffle,
            tt.train_loader.workers) == (4, True, 2)


def test_swap_keeps_one_optimizer_state(runs):
    tt, state = runs["torch"], runs["state"]
    assert state is tt.init_state() is tt.train_step.state
    assert tt.resident_step.state is state and tt.resident_multi.state is state
    assert state.step == state.optimizer.count == 4
    momentum = state.optimizer.optimizer.state
    assert len(momentum) > 10 and all(
        torch.isfinite(s["momentum_buffer"]).all() for s in momentum.values())


def test_losses_match_jax_through_the_swap(runs):
    got, exp = runs["torch_records"], runs["jax_records"]
    steps = [[r for r in recs if "step" in r] for recs in (got, exp)]
    cadence = [[(r["epoch"], r["step"]) for r in recs] for recs in steps]
    # Epoch 0: every streamed single step; epoch 1: one record for its
    # resident 2-step dispatch.
    assert cadence[0] == cadence[1] == [(0, 1), (0, 2), (1, 4)]
    for g, e in zip(*steps):
        assert sorted(g) == sorted(e)
        for k in set(g) - {"epoch", "step"}:
            rtol = GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL
            np.testing.assert_allclose(g[k], e[k], rtol=rtol, err_msg=k)
    summaries = [[r for r in recs if "step" not in r] for recs in (got, exp)]
    assert [r["epoch"] for r in summaries[0]] == [r["epoch"] for r in summaries[1]] == [0, 1]
    for g, e in zip(*summaries):
        assert sorted(g) == sorted(e)
        np.testing.assert_allclose(g["train_loss"], e["train_loss"], rtol=LOSS_RTOL)


def test_auto_pack_off_streams_the_decode_backed_set(tmp_path):
    layout = _write_layout(tmp_path / "mpii", "annot/", np.random.default_rng(2),
                           n=4)
    cfg = tconfig.config_from_json(jconfig.config_to_json(_jax_config(layout)))
    cfg = tconfig.Config(model=cfg.model, optim=cfg.optim, train=cfg.train,
                         data=tconfig.DataConfig(data_dir=layout, auto_pack=False))
    ds = MPIIDataset(layout, "train", canvas_size=64)
    trainer = Trainer(model=build_pose_model(cfg.model, device="cpu"), cfg=cfg,
                      train_loader=ShardedLoader(ds, 4, shuffle=True),
                      device="cpu")
    assert trainer._autopack is None and trainer.resident is None
    assert trainer.train_loader.dataset is ds
    assert not packed_available(layout, "train")
