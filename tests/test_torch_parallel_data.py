"""Data parallelism without ranks: the host split of the loader and the
sharded resident splits against the JAX package's (bitwise, over 1, 2 and 4
hosts or shards), the process-group bootstrap, the mesh, and the
one-process path, which must issue no collective at all.

The JAX side builds its resident splits on meshes of the conftest's
virtual CPU devices; nothing here starts a rank.
"""

import datetime
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dsnt_pose2d_tpu.data import ArrayDataset as JArrayDataset
from dsnt_pose2d_tpu.data import ShardedLoader as JShardedLoader
from dsnt_pose2d_tpu.data.resident import ResidentEvalData as JResidentEvalData
from dsnt_pose2d_tpu.data.resident import ResidentTrainData as JResidentTrainData
from dsnt_pose2d_tpu.data.synthetic import make_synthetic_mpii as j_synth
from dsnt_pose2d_tpu.parallel.mesh import make_mesh as j_make_mesh
from dsnt_pose2d_tpu_torch.cli import train as train_cli
from dsnt_pose2d_tpu_torch.data.loader import ShardedLoader
from dsnt_pose2d_tpu_torch.data.mpii import ArrayDataset
from dsnt_pose2d_tpu_torch.data.resident import ResidentEvalData, ResidentTrainData
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
from dsnt_pose2d_tpu_torch.parallel import mesh as pmesh
from dsnt_pose2d_tpu_torch.train.checkpoint import CheckpointManager
from dsnt_pose2d_tpu_torch.train.loop import EvalDriver, make_eval_fn, make_train_fn
from dsnt_pose2d_tpu_torch.utils import config as tconfig

N = 33
SPLIT = j_synth(N, 16, seed=11)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _loaders(hosts, host, shuffle, drop_last, batch=8):
    kw = dict(shuffle=shuffle, seed=3, num_hosts=hosts, host_id=host,
              drop_last=drop_last)
    return (ShardedLoader(ArrayDataset(SPLIT), batch, **kw),
            JShardedLoader(JArrayDataset(SPLIT), batch, **kw))


@pytest.mark.parametrize("hosts", [1, 2, 4])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_streams_equal_jax(hosts, shuffle, drop_last):
    for host in range(hosts):
        got, exp = _loaders(hosts, host, shuffle, drop_last)
        assert got.steps_per_epoch == exp.steps_per_epoch
        assert (got.global_batch_size, got.local_batch_size, got.batch_size) == \
            (exp.global_batch_size, exp.local_batch_size, exp.local_batch_size)
        for epoch in (0, 2):
            for h in range(hosts):
                for a, b in zip(got._epoch_indices_for(epoch, h),
                                exp._epoch_indices_for(epoch, h)):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
            gi, ei = got.global_index_batches(epoch), exp.global_index_batches(epoch)
            assert len(gi) == len(ei) == got.steps_per_epoch
            for a, b in zip(gi, ei):
                np.testing.assert_array_equal(a, b)
        # The host's batches, pad rows' masks zeroed, as the JAX loader's.
        for a, b in zip(got.epoch(1), exp.epoch(1), strict=True):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("hosts", [2, 4])
def test_global_index_batches_cover_each_row_once(hosts):
    got, _ = _loaders(hosts, 0, shuffle=True, drop_last=False)
    rows = np.concatenate(got.global_index_batches(1))
    np.testing.assert_array_equal(np.sort(rows[rows >= 0]), np.arange(N))
    assert all(len(g) == got.global_batch_size for g in got.global_index_batches(1))


def _split(n):
    return {k: v[:n] for k, v in j_synth(n, 8, seed=n).items()}


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("n", [33, 40])
def test_resident_train_streams_equal_jax(shards, n):
    data = _split(n)
    exp = JResidentTrainData(JArrayDataset(data), 8, j_make_mesh(shards), seed=7)
    for s in range(shards):
        got = ResidentTrainData(ArrayDataset(data), 8, "cpu", seed=7,
                                num_shards=shards, shard=s)
        assert got.steps_per_epoch == exp.steps_per_epoch
        np.testing.assert_array_equal(got.shard_valid, exp.shard_valid)
        assert got.rows_per_shard == exp.rows_per_shard
        assert got.nbytes == exp.nbytes
        for epoch in (0, 3):
            np.testing.assert_array_equal(got._shard_streams(epoch),
                                          exp._shard_streams(epoch))
            bs = got.shard_batch_size
            for a, b in zip(got.epoch(epoch), exp.epoch(epoch), strict=True):
                np.testing.assert_array_equal(a.numpy(),
                                              np.asarray(b)[s * bs:(s + 1) * bs])
            for (ka, a), (kb, b) in zip(got.epoch_groups(epoch, 2),
                                        exp.epoch_groups(epoch, 2), strict=True):
                assert ka == kb
                np.testing.assert_array_equal(
                    a.numpy(), np.asarray(b)[..., s * bs:(s + 1) * bs])
        # This rank's staged rows are its shard's dataset rows (pad rows
        # repeat the shard's last valid one), as the JAX shard holds them.
        for local in range(got.rows_per_shard):
            row = got.dataset_row(s, min(local, got.shard_valid[s] - 1))
            assert row == exp.dataset_row(s, min(local, exp.shard_valid[s] - 1))
            for k, v in data.items():
                np.testing.assert_array_equal(got.resident[k][local].numpy(), v[row])
                np.testing.assert_array_equal(
                    np.asarray(exp.resident[k])[s * got.rows_per_shard + local],
                    v[row])


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("n", [13, 33])
def test_resident_eval_streams_equal_jax(shards, n):
    data = _split(n)
    exp = JResidentEvalData(JArrayDataset(data), 8, j_make_mesh(shards))
    seen = []
    for s in range(shards):
        got = ResidentEvalData(ArrayDataset(data), 8, "cpu", num_shards=shards,
                               shard=s)
        assert got.steps_per_epoch == exp.steps_per_epoch
        np.testing.assert_array_equal(got.shard_valid, exp.shard_valid)
        bs = got.shard_batch_size
        for step in range(got.steps_per_epoch):
            for a, b in zip(got._step_host_arrays(step), exp._step_host_arrays(step)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(got.host_rows(step), exp.host_rows(step))
        idxs, valids = got.epoch_stacked()
        eidx, evalid = (np.asarray(x) for x in exp.epoch_stacked())
        np.testing.assert_array_equal(idxs.numpy(), eidx[:, s * bs:(s + 1) * bs])
        np.testing.assert_array_equal(valids.numpy(), evalid[:, s * bs:(s + 1) * bs])
        for (idx, valid), i, v in zip(got.epoch(), idxs, valids, strict=True):
            assert torch.equal(idx, i) and torch.equal(valid, v)
        keep = valids.numpy().reshape(-1) > 0
        seen += [int(i) * shards + s for i in idxs.numpy().reshape(-1)[keep]]
    # Over all shards the valid rows cover the split once.
    np.testing.assert_array_equal(np.sort(seen), np.arange(n))


def test_resident_shards_refuse_bad_layouts():
    ds = ArrayDataset(_split(9))
    with pytest.raises(ValueError, match="not divisible"):
        ResidentTrainData(ds, 6, "cpu", num_shards=4, shard=0)
    with pytest.raises(ValueError, match="shard 2 of 2"):
        ResidentEvalData(ds, 4, "cpu", num_shards=2, shard=2)
    with pytest.raises(ValueError, match="smaller than"):
        ResidentTrainData(ArrayDataset(_split(3)), 4, "cpu", num_shards=4)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


LAUNCH_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
               "TORCHELASTIC_RUN_ID")


@pytest.fixture
def no_launcher(monkeypatch):
    for v in LAUNCH_VARS:
        monkeypatch.delenv(v, raising=False)
    return monkeypatch


def test_initialize_distributed_is_a_noop_without_a_launcher(no_launcher):
    assert not pmesh.launched()
    assert pmesh.initialize_distributed("cpu") is None
    assert not dist.is_initialized()
    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.group) == (1, 0, None)
    assert mesh.shape == {"data": 1, "model": 1}
    pmesh.check_row_order(mesh)


def test_initialize_distributed_is_fatal_without_a_peer(no_launcher):
    # A launched rank whose peer never comes must raise, never run alone.
    no_launcher.setenv("WORLD_SIZE", "2")
    no_launcher.setenv("RANK", "1")
    no_launcher.setenv("MASTER_ADDR", "127.0.0.1")
    no_launcher.setenv("MASTER_PORT", str(_free_port()))
    with pytest.raises((RuntimeError, ValueError, TimeoutError)):
        pmesh.initialize_distributed("cpu", timeout=datetime.timedelta(seconds=2))
    assert not dist.is_initialized()


def test_initialize_distributed_is_fatal_on_a_partial_launch(no_launcher):
    no_launcher.setenv("TORCHELASTIC_RUN_ID", "job")
    with pytest.raises(ValueError):
        pmesh.initialize_distributed("cpu")
    assert not dist.is_initialized()


def test_model_parallel_wider_than_the_world_raises_as_jax(no_launcher, tmp_path):
    # One process holds one device: model_parallel=2 does not divide it, and
    # the port raises the JAX package's ValueError, in make_mesh and in the
    # train CLI (before it writes anything).
    with pytest.raises(ValueError) as exp:
        j_make_mesh(1, model_parallel=2)
    with pytest.raises(ValueError) as got:
        pmesh.make_mesh(model_parallel=2, device="cpu")
    assert str(got.value) == str(exp.value)
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        train_cli.main(["--device", "cpu", "--model-parallel", "2",
                        "--out-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
    mesh = pmesh.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert (mesh.data_size, mesh.data_index, mesh.model_index) == (1, 0, 0)


def test_shard_batch_takes_the_ranks_block():
    batch = {"x": np.arange(24).reshape(8, 3), "y": np.arange(8)}
    one = pmesh.shard_batch(pmesh.make_mesh(device="cpu"), batch)
    np.testing.assert_array_equal(one["x"].numpy(), batch["x"])
    mesh = pmesh.Mesh(world_size=4, rank=2, local_rank=2,
                      device=torch.device("cpu"))
    got = pmesh.shard_batch(mesh, batch)
    np.testing.assert_array_equal(got["x"].numpy(), batch["x"][4:6])
    np.testing.assert_array_equal(got["y"].numpy(), [4, 5])
    sb = pmesh.shard_super_batch(mesh, {"x": np.arange(16).reshape(2, 8)})
    np.testing.assert_array_equal(sb["x"].numpy(), [[4, 5], [12, 13]])
    with pytest.raises(ValueError, match="do not divide"):
        pmesh.shard_batch(mesh, {"x": np.arange(6)})
    with pytest.raises(ValueError, match="rank order"):
        pmesh.check_row_order(mesh)


def test_drivers_refuse_a_loader_of_another_split():
    from dsnt_pose2d_tpu_torch.train.loop import _check_host_split

    mesh = pmesh.Mesh(world_size=2, rank=1, local_rank=1,
                      device=torch.device("cpu"))
    ds = ArrayDataset(SPLIT)
    _check_host_split(mesh, ShardedLoader(ds, 8, shuffle=False, num_hosts=2,
                                          host_id=1), None)
    with pytest.raises(ValueError, match="num_hosts=W, host_id=rank"):
        _check_host_split(mesh, ShardedLoader(ds, 8, shuffle=False))


def test_gradient_buckets_keep_dtype_runs_and_the_cap():
    ts = [torch.zeros(10), torch.zeros(30), torch.zeros(5, dtype=torch.float64),
          torch.zeros(100), torch.zeros(1)]
    runs = [[t.numel() for t in run] for run in pmesh._buckets(ts, cap_bytes=160)]
    assert runs == [[10, 30], [5], [100], [1]]


def test_one_process_issues_no_collective(no_launcher, tmp_path):
    # Without a group of size > 1 the port's paths never reach a collective:
    # every torch.distributed entry point the port uses is made to fail.
    def refuse(*args, **kwargs):
        raise AssertionError("a collective in a one-process run")

    for name in ("all_reduce", "broadcast", "barrier", "all_gather"):
        no_launcher.setattr(dist, name, refuse)
    cfg = tconfig.Config(
        model=tconfig.ModelConfig(base="hg1", hg_features=16, hg_depth=1,
                                  input_size=32, dtype="float32", reg="js"),
        train=tconfig.TrainConfig(batch_size=4))
    batch = j_synth(4, 48, seed=1)
    model = build_pose_model(cfg.model, device="cpu", seed=0)
    pmesh.reset_collective_counts()
    step = make_train_fn(model, cfg, device="cpu")
    m = step(batch)
    assert np.isfinite(m["loss"].item()) and step.state.step == 1
    make_eval_fn(model, cfg, device="cpu")(batch)
    loader = ShardedLoader(ArrayDataset(j_synth(6, 48, seed=2)), 4,
                           shuffle=False, drop_last=False)
    driver = EvalDriver(model=model, cfg=cfg, loader=loader, device="cpu")
    assert driver.predict().shape == (6, 16, 2)
    driver.evaluate()
    CheckpointManager(str(tmp_path), cfg).save_step(step.state, epoch=0,
                                                    step_in_epoch=1)
    assert pmesh.all_reduce_grads_([p.grad for p in model.net.parameters()]) == 0
    pmesh.barrier()
    assert pmesh.collective_counts() == {"all_reduce": 0, "broadcast": 0}
