"""Multi-step dispatch and the resident train step, on the CPU.

- ``make_multi_step(k=3)`` is three ``make_train_fn`` steps, bit for bit
  (metrics, parameters and BN statistics), and so are the resident step and
  the resident multi-step on the gathered rows against the streaming step
  on the same rows collated on the host.
- The port's ``k=2`` multi-step against the JAX package's
  ``make_multi_step`` on a 1-device mesh: hg2 of depth 2, 32 features,
  64-px input, batch 4, the backbone in fp64 on both sides
  (``jax.enable_x64``), the same weights and batches, JAX's per-step
  augmentation draws fed to the port.  Per-step metrics rtol 1e-6, every
  updated parameter within 1e-6 of its leaf's largest value.

  Three choices keep that comparison exact.  The optimizer is SGD with
  momentum (lr 1e-3): RMSProp's first update is about 10 lr sign(g), which
  turns the fp32 head's rounding on near-zero gradients into full steps of
  either sign.  The port's step trains on the batch that JAX's scan itself
  preprocessed (recorded with ``jax.debug.callback``): inside the scan JAX
  warps in fp32, outside it under x64 partly in fp64, and the port's own fp32
  warp from the same draws lands within 1e-4 of the scan's images (held
  below), not bitwise.  This random-init network's gradient is not smooth in
  its input: 1e-6 of noise on the images moves a leaf's gradient by 3%
  (max-pool and ReLU switches), so only identical images give identical
  steps.  For the same reason the hourglass has depth 2: at depth 4 its
  innermost level is 1x1, where train-mode BN normalises 4 values.
"""

from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dsnt_pose2d_tpu.data.synthetic import make_synthetic_mpii as j_synth
from dsnt_pose2d_tpu.models.factory import PoseModel as JPoseModel
from dsnt_pose2d_tpu.models.heads import PoseOutput
from dsnt_pose2d_tpu.models.hourglass import HourglassNet as JHourglassNet
from dsnt_pose2d_tpu.parallel.mesh import make_mesh, shard_super_batch
from dsnt_pose2d_tpu.train import loop as jloop
from dsnt_pose2d_tpu.train.state import TrainState as JTrainState
from dsnt_pose2d_tpu.train.state import make_optimizer as j_make_optimizer
from dsnt_pose2d_tpu.utils import config as jconfig
from dsnt_pose2d_tpu_torch.data import pack
from dsnt_pose2d_tpu_torch.data.loader import _collate
from dsnt_pose2d_tpu_torch.data.resident import ResidentTrainData
from dsnt_pose2d_tpu_torch.data.synthetic import make_synthetic_mpii
from dsnt_pose2d_tpu_torch.models.factory import PoseModel, build_pose_model
from dsnt_pose2d_tpu_torch.models.from_jax import hourglass_from_jax
from dsnt_pose2d_tpu_torch.models.heads import PoseOutput as TPoseOutput
from dsnt_pose2d_tpu_torch.models.hourglass import HourglassNet
from dsnt_pose2d_tpu_torch.train import loop as tloop
from dsnt_pose2d_tpu_torch.train.loop import (_prefetch_dispatch_groups,
                                             make_multi_step,
                                             make_resident_multi_step,
                                             make_resident_step, make_train_fn)
from dsnt_pose2d_tpu_torch.utils import config as tconfig
from port_helpers import jax_train_draws, perturb

TINY = tconfig.Config(model=tconfig.ModelConfig(
    base="hg1", hg_features=16, hg_depth=1, input_size=32, dtype="float32",
    reg="js"))


def _tiny_pair():
    """Two copies of one tiny model, each with its own train step."""
    models = [build_pose_model(TINY.model, device="cpu", seed=3) for _ in range(2)]
    return models, [make_train_fn(m, TINY, device="cpu") for m in models]


def _assert_same(metrics_a, metrics_b, model_a, model_b):
    for k in metrics_a:
        assert torch.equal(metrics_a[k], metrics_b[k]), k
    sa, sb = model_a.net.state_dict(), model_b.net.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_multi_step_is_k_single_steps_bitwise():
    (m_multi, m_single), (_, single) = _tiny_pair()
    multi = make_multi_step(m_multi, TINY, device="cpu")
    data = {k: torch.from_numpy(v) for k, v in make_synthetic_mpii(6, 48, seed=1).items()}
    super_batch = {k: v.reshape(3, 2, *v.shape[1:]) for k, v in data.items()}
    got = multi(super_batch)
    exp = [single({k: v[i] for k, v in super_batch.items()}) for i in range(3)]
    exp = {k: torch.stack([m[k] for m in exp]) for k in exp[0]}
    assert got["loss"].shape == (3,)
    _assert_same(got, exp, m_multi, m_single)
    assert multi.state.step == single.state.step == 3


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    out = tmp_path_factory.mktemp("packed")
    rng = np.random.default_rng(0)
    n, c = 8, 48
    np.save(out / pack.CANVAS_FILE.format(subset="train"),
            rng.integers(0, 256, (n, c, c, 3), dtype=np.uint8))
    np.savez(out / pack.META_FILE.format(subset="train"),
             coords_px=rng.uniform(10, 38, (n, 16, 2)).astype(np.float32),
             mask=np.ones((n, 16), np.float32),
             head_length=np.full((n,), 6.0, np.float32),
             canvas_from_orig=np.broadcast_to(np.eye(3, dtype=np.float32),
                                              (n, 3, 3)).copy(),
             canvas_margin=np.full((n,), 1.5, np.float32))
    return pack.PackedDataset(str(out), "train")


def test_resident_steps_are_streaming_steps_bitwise(packed):
    (m_res, m_stream), (res_train, stream) = _tiny_pair()
    rd = ResidentTrainData(packed, 2, "cpu", seed=4)
    res_step = make_resident_step(m_res, TINY, "cpu", train_step=res_train)
    res_multi = make_resident_multi_step(m_res, TINY, "cpu", train_step=res_train)
    assert res_step.state is res_multi.state is res_train.state
    groups = list(rd.epoch_groups(0, 3))          # 4 steps: multi + single
    assert [kind for kind, _ in groups] == ["multi", "single"]
    got, exp = [], []
    for kind, idx in groups:
        rows = [idx] if kind == "single" else list(idx)
        out = (res_step(rd.resident, idx) if kind == "single"
               else res_multi(rd.resident, idx))
        got.extend([out] if kind == "single"
                   else [{k: v[i] for k, v in out.items()} for i in range(3)])
        for r in rows:
            batch = _collate([packed[int(i)] for i in r])
            assert batch["canvases"].dtype == np.uint8
            exp.append(stream(batch))
    for g, e in zip(got, exp):
        _assert_same(g, e, m_res, m_stream)
    assert res_train.state.step == stream.state.step == 4


def test_prefetch_dispatch_groups_match_jax():
    # 5 batches in groups of 2: two stacked (2, B, ...) groups, then the
    # ragged tail as one single step, as the JAX package groups them.
    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(5)]
    got = list(_prefetch_dispatch_groups(iter(batches), 2, "cpu", depth=1))
    exp = list(jloop._prefetch_dispatch_groups(iter(batches), 2, make_mesh(1)))
    assert [k for k, _ in got] == [k for k, _ in exp] == ["multi", "multi", "single"]
    for (_, a), (_, b) in zip(got, exp):
        np.testing.assert_array_equal(a["x"].numpy(), np.asarray(b["x"]))
    assert got[0][1]["x"].shape == (2, 2, 3)


STACKS, FEATS, SIZE, BATCH = 2, 32, 64, 4
DEPTH = 2
FP64_OPTIM = jconfig.OptimConfig(optimizer="sgd", lr=1e-3, momentum=0.9,
                                 schedule="constant")


class _JaxNet64(fnn.Module):
    """The JAX package's PoseNet with the hourglass computing in fp64."""

    @fnn.compact
    def __call__(self, images, train: bool = False):
        raw = JHourglassNet(num_stacks=STACKS, num_joints=16, features=FEATS,
                            depth=DEPTH, dtype=jnp.float64,
                            name="backbone")(images, train)
        return PoseOutput(heatmaps=raw, fc_coords=None)


class _TorchNet64(nn.Module):
    """The port's PoseNet with the hourglass computing in fp64."""

    def __init__(self):
        super().__init__()
        self.backbone = HourglassNet(num_stacks=STACKS, num_joints=16,
                                     features=FEATS, depth=DEPTH,
                                     dtype=torch.float64).double()

    def forward(self, images):
        return TPoseOutput(self.backbone(images.double()))


def run_fp64_multi(optim: jconfig.OptimConfig) -> SimpleNamespace:
    """Both packages' k=2 multi-step from the same weights, batches and draws."""
    jcfg = jconfig.Config(
        model=jconfig.ModelConfig(base=f"hg{STACKS}", hg_features=FEATS,
                                  input_size=SIZE, dtype="float32", reg="js",
                                  use_pallas=False),
        data=jconfig.DataConfig(warp_method="shear"), optim=optim)
    tcfg = tconfig.config_from_json(jconfig.config_to_json(jcfg))
    batches = [j_synth(BATCH, 96, seed=s) for s in (11, 12)]
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(True):
        # Drawn as the step draws them: under x64, jax.random gives fp64.
        draws = [jax_train_draws(jax.random.fold_in(key, i), BATCH, jcfg.data)
                 for i in range(2)]
        jmodel = JPoseModel(module=_JaxNet64(), cfg=jcfg.model)
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            perturb(jmodel.module.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, SIZE, SIZE, 3)), train=False)))
        tx = j_make_optimizer(jcfg.optim, 1, jcfg.train.epochs)
        state = JTrainState(step=jnp.zeros((), jnp.int32),
                            params=variables["params"],
                            batch_stats=variables["batch_stats"],
                            opt_state=tx.init(variables["params"]), rng=key)
        mesh = make_mesh(1)
        super_batch = shard_super_batch(
            mesh, {k: np.stack([b[k] for b in batches]) for k in batches[0]})
        # The batch that each step of JAX's scan preprocessed, as that
        # compiled graph computed it: the port's step trains on it in place
        # of its own (see the module docstring).
        pres = []
        j_preprocess = jloop.preprocess_batch

        def recording(*args, **kwargs):
            pre = j_preprocess(*args, **kwargs)
            jax.debug.callback(lambda p: pres.append(jax.device_get(p)), pre)
            return pre

        jloop.preprocess_batch = recording
        try:
            new_state, metrics = jloop.make_multi_step(jmodel, jcfg, mesh)(
                state, super_batch)
            jax.block_until_ready(metrics)
        finally:
            jloop.preprocess_batch = j_preprocess
        assert len(pres) == 2
        exp = SimpleNamespace(
            metrics=jax.device_get(metrics),
            after=hourglass_from_jax(jax.device_get(
                {"params": new_state.params,
                 "batch_stats": new_state.batch_stats}), STACKS, depth=DEPTH))

    net = _TorchNet64()
    net.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                         hourglass_from_jax(variables, STACKS, depth=DEPTH).items()},
                        strict=True)
    model = PoseModel(net=net, cfg=tcfg.model, device=torch.device("cpu"))
    multi = make_multi_step(model, tcfg, device="cpu")
    super_t = {k: torch.from_numpy(np.stack([b[k] for b in batches]))
               for k in batches[0]}
    own = tloop._preprocess
    warp_err = []

    def jax_preprocess(batch, cfg, in_size, draws):
        # The port's own preprocess from JAX's draws, held against JAX's
        # batch of this step; then the step trains on JAX's batch.
        mine = own(batch, cfg, in_size, draws)
        theirs = pres[len(warp_err)]
        warp_err.append(np.abs(mine["images"].numpy() - theirs["images"]).max())
        np.testing.assert_allclose(mine["coords"].numpy(), theirs["coords"],
                                   rtol=0, atol=1e-5)
        return {k: torch.from_numpy(np.array(v)) for k, v in theirs.items()}

    tloop._preprocess = jax_preprocess
    try:
        got = multi(super_t, draws=[{k: None if v is None else torch.from_numpy(v)
                                     for k, v in d.items()} for d in draws])
    finally:
        tloop._preprocess = own
    return SimpleNamespace(got=got, after=net.state_dict(), exp=exp,
                           warp_err=warp_err)


@pytest.fixture(scope="module")
def fp64_multi():
    return run_fp64_multi(FP64_OPTIM)


@pytest.mark.parametrize("key", ["loss", "grad_norm", "euclidean", "reg"])
def test_fp64_multi_step_metrics_match_jax(fp64_multi, key):
    got = fp64_multi.got[key].numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, fp64_multi.exp.metrics[key], rtol=1e-6)


def test_fp64_multi_step_own_preprocess_near_jax(fp64_multi):
    # The port's own warp from JAX's draws against JAX's scanned one: the
    # same bilinear samples at fp32 positions rounded differently.
    assert len(fp64_multi.warp_err) == 2
    assert max(fp64_multi.warp_err) <= 1e-4, fp64_multi.warp_err


def test_fp64_multi_step_updated_params_match_jax(fp64_multi):
    after, exp = fp64_multi.after, fp64_multi.exp.after
    names = [k for k in exp if "running" not in k and "num_batches" not in k]
    assert len(names) > 50
    for name in names:
        e = np.asarray(exp[name])
        np.testing.assert_allclose(after[name].numpy(), e, rtol=0,
                                   atol=1e-6 * np.abs(e).max(), err_msg=name)
