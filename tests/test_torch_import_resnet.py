"""torchvision-ResNet weight import (``models/import_torch.py``): the port
against the JAX package's importer and against the torchvision-layout
trunks themselves, on the CPU.

The trunks are built here in torchvision's key layout (resnet18 with basic
blocks, resnet50 with bottlenecks and ``replace_stride_with_dilation`` on
its last two stages), random and with random BN statistics: neither machine
has torchvision, and nothing is downloaded.  Both packages import the same
state dict; the port's result equals the JAX package's, mapped by
``pose_net_from_jax``, bit for bit, and its trunk computes the torchvision
trunk's function (rtol 2e-4 / atol 5e-4, the bar of
``tests/test_import_torch.py``; TF32 off).
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn as tnn

from dsnt_pose2d_tpu.models.factory import build_mpii_pose_model as j_build
from dsnt_pose2d_tpu.models.import_torch import \
    load_torchvision_resnet as j_load_torchvision_resnet
from dsnt_pose2d_tpu_torch.data.loader import ShardedLoader
from dsnt_pose2d_tpu_torch.data.mpii import ArrayDataset
from dsnt_pose2d_tpu_torch.data.synthetic import make_synthetic_mpii
from dsnt_pose2d_tpu_torch.device import strict_fp32
from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
from dsnt_pose2d_tpu_torch.models.from_jax import pose_net_from_jax
from dsnt_pose2d_tpu_torch.models.import_torch import (load_torchvision_resnet,
                                                       read_state_dict)
from dsnt_pose2d_tpu_torch.train.loop import Trainer
from dsnt_pose2d_tpu_torch.utils import config as tconfig

SIZE = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Basic(tnn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(cout)
        self.conv2 = tnn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = tnn.Sequential(
                tnn.Conv2d(cin, cout, 1, stride, bias=False), tnn.BatchNorm2d(cout))

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(y)) + idt)


class _Bottleneck(tnn.Module):
    def __init__(self, cin, planes, stride=1, dilation=1, downsample=None):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(planes)
        self.conv2 = tnn.Conv2d(planes, planes, 3, stride, dilation, dilation,
                                bias=False)
        self.bn2 = tnn.BatchNorm2d(planes)
        self.conv3 = tnn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = tnn.BatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        return torch.relu(self.bn3(self.conv3(y)) + idt)


class _Trunk(tnn.Module):
    """torchvision's ResNet less ``avgpool``, with its ``fc`` (which the
    import drops)."""

    def __init__(self, layers, out_ch):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = tnn.BatchNorm2d(64)
        self.maxpool = tnn.MaxPool2d(3, 2, 1)
        for li, blocks in enumerate(layers, 1):
            setattr(self, f"layer{li}", tnn.Sequential(*blocks))
        self.fc = tnn.Linear(out_ch, 1000)

    def forward(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return x


def torchvision_resnet18():
    layers = []
    for li, (c, s) in enumerate([(64, 1), (128, 2), (256, 2), (512, 2)]):
        cin = 64 if li == 0 else c // 2
        layers.append([_Basic(cin, c, s), _Basic(c, c)])
    return _Trunk(layers, 512)


def torchvision_resnet50(dilated_stages=0):
    """torchvision's ``_make_layer`` with ``replace_stride_with_dilation`` on
    the last ``dilated_stages`` stages (the first block of a dilated stage
    keeps the previous dilation)."""
    layers, inplanes, dilation = [], 64, 1
    for li, depth in enumerate((3, 4, 6, 3)):
        planes, stride = 64 * 2 ** li, (1 if li == 0 else 2)
        prev_dilation = dilation
        if li >= 4 - dilated_stages and stride == 2:
            dilation *= stride
            stride = 1
        downsample = None
        if stride != 1 or inplanes != planes * 4:
            downsample = tnn.Sequential(
                tnn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                tnn.BatchNorm2d(planes * 4))
        blocks = [_Bottleneck(inplanes, planes, stride, prev_dilation, downsample)]
        inplanes = planes * 4
        blocks += [_Bottleneck(inplanes, planes, 1, dilation)
                   for _ in range(depth - 1)]
        layers.append(blocks)
    return _Trunk(layers, 2048)


def _randomized(net, seed):
    torch.manual_seed(seed)
    for m in net.modules():
        if isinstance(m, (tnn.Conv2d, tnn.Linear)):
            tnn.init.normal_(m.weight, std=(1.0 / m.weight[0].numel()) ** 0.5)
        if isinstance(m, tnn.BatchNorm2d):
            with torch.no_grad():
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.8, 1.2)
                m.weight.uniform_(0.8, 1.2)
                m.bias.uniform_(-0.1, 0.1)
    return net.eval()


CASES = {"resnet18": (torchvision_resnet18, 0, "stage3_block1"),
         "resnet50": (lambda: torchvision_resnet50(2), 2, "stage3_block2")}


def _cfg(base, dilate=0, **kw):
    return tconfig.ModelConfig(base=base, dilate=dilate, input_size=SIZE,
                               dtype="float32", use_pallas=False, **kw)


@pytest.fixture(scope="module", params=list(CASES))
def imported(request):
    base = request.param
    make, dilate, last = CASES[base]
    tnet = _randomized(make(), seed=len(base))
    sd = tnet.state_dict()
    jmodel = j_build(base=base, dilate=dilate, input_size=SIZE, dtype="float32",
                     use_pallas=False)
    jvars = j_load_torchvision_resnet(
        jmodel.init_variables(jax.random.PRNGKey(0)), sd)
    cfg = _cfg(base, dilate)
    model = build_pose_model(cfg, device="cpu", seed=1)
    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    model.net.load_state_dict(load_torchvision_resnet(model.net.state_dict(), sd),
                              strict=True)
    return tnet, jmodel, jvars, model, before, last


def test_import_equals_the_jax_import(imported):
    _, _, jvars, model, _, _ = imported
    exp = pose_net_from_jax(jax.device_get(jvars), model.cfg)
    got = model.net.state_dict()
    imported_keys = [k for k in got if ".score." not in k
                     and not k.endswith("num_batches_tracked")]
    assert len(imported_keys) >= 100
    for k in imported_keys:
        np.testing.assert_array_equal(got[k].numpy(), exp[k], err_msg=k)


def test_import_keeps_score_and_drops_fc(imported):
    _, _, _, model, before, _ = imported
    got = model.net.state_dict()
    for k in ("backbone.score.weight", "backbone.score.bias"):
        assert torch.equal(got[k], before[k]), k
    assert not any(k.startswith("fc") for k in got)


def test_imported_trunk_computes_the_torchvision_trunk(imported):
    tnet, _, _, model, _, last = imported
    x = np.random.default_rng(1).normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    captured = []
    getattr(model.net.backbone, last).register_forward_hook(
        lambda m, i, out: captured.append(out))
    with torch.inference_mode(), strict_fp32():
        exp = tnet(torch.from_numpy(x).permute(0, 3, 1, 2))
        model.forward(torch.from_numpy(x))
    assert captured[0].shape == exp.shape
    np.testing.assert_allclose(captured[0].numpy(), exp.numpy(), rtol=2e-4,
                               atol=5e-4)


def test_imported_heatmaps_match_jax(imported):
    _, jmodel, jvars, model, _, _ = imported
    model.net.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                               pose_net_from_jax(jax.device_get(jvars),
                                                 model.cfg).items()})
    x = np.random.default_rng(2).normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    exp = np.asarray(jmodel.forward(jvars, x).heatmaps)
    with torch.inference_mode(), strict_fp32():
        got = model.forward(torch.from_numpy(x)).heatmaps.numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=2e-4)


def test_import_into_a_truncated_model_skips_its_stages():
    sd = _randomized(torchvision_resnet18(), seed=3).state_dict()
    model = build_pose_model(_cfg("resnet18", truncate=1), device="cpu")
    out = load_torchvision_resnet(model.net.state_dict(), sd)
    assert not any("stage3" in k for k in out)
    assert torch.equal(out["backbone.stage2_block1.conv2.weight"],
                       sd["layer3.1.conv2.weight"])


def test_import_rejects_wrong_depth_shape_and_missing_keys():
    sd = torchvision_resnet18().state_dict()
    deeper = build_pose_model(_cfg("resnet34"), device="cpu").net.state_dict()
    with pytest.raises(ValueError, match="does not cover"):
        load_torchvision_resnet(deeper, sd)
    wide = build_pose_model(_cfg("resnet50"), device="cpu").net.state_dict()
    with pytest.raises(ValueError, match="shape"):
        load_torchvision_resnet(wide, torchvision_resnet50().state_dict()
                                | {"conv1.weight": torch.zeros(64, 3, 3, 3)})
    with pytest.raises((KeyError, ValueError)):
        load_torchvision_resnet(wide, sd)
    own = build_pose_model(_cfg("resnet18"), device="cpu").net.state_dict()
    with pytest.raises(KeyError, match="bn1.running_var"):
        load_torchvision_resnet(own, {k: v for k, v in sd.items()
                                      if k != "bn1.running_var"})


@pytest.mark.parametrize("suffix", [".npz", ".pth"])
def test_read_state_dict(tmp_path, suffix):
    sd = torchvision_resnet18().state_dict()
    path = str(tmp_path / f"w{suffix}")
    if suffix == ".npz":
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    else:
        torch.save(sd, path)
    got = read_state_dict(path)
    assert set(got) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v.numpy(), err_msg=k)


def test_trainer_loads_pretrained_resnet_from_npz(tmp_path):
    tnet = _randomized(torchvision_resnet18(), seed=5)
    path = str(tmp_path / "resnet18.npz")
    np.savez(path, **{k: v.numpy() for k, v in tnet.state_dict().items()})
    cfg = tconfig.Config(
        model=_cfg("resnet18", output_strat="fc"),
        data=tconfig.DataConfig(pretrained_resnet=path, device_resident="off",
                                auto_pack=False),
        train=tconfig.TrainConfig(batch_size=4, epochs=1))
    model = build_pose_model(cfg.model, device="cpu", seed=0)
    score = model.net.backbone.score.weight.clone()
    fc = model.net.fc_head_kernel.clone()
    data = ArrayDataset(make_synthetic_mpii(8, 96, seed=1))
    trainer = Trainer(model=model, cfg=cfg, train_loader=ShardedLoader(data, 4, shuffle=True, seed=0),
                      device="cpu")
    sd = tnet.state_dict()
    got = model.net.state_dict()
    assert torch.equal(got["backbone.stem_conv.weight"], sd["conv1.weight"])
    assert torch.equal(got["backbone.stage1_block0.bn_proj.running_var"],
                       sd["layer2.0.downsample.1.running_var"])
    assert torch.equal(got["backbone.score.weight"], score)
    assert torch.equal(got["fc_head_kernel"], fc)
    # The optimizer holds the same parameter objects: training moves the
    # imported weights.
    state, _ = trainer.run()
    assert state.step == 2
    assert not torch.equal(model.net.state_dict()["backbone.stem_conv.weight"],
                           sd["conv1.weight"])


def test_trainer_ignores_pretrained_resnet_for_an_hourglass(tmp_path):
    cfg = tconfig.Config(
        model=tconfig.ModelConfig(base="hg1", hg_features=16, hg_depth=1,
                                  input_size=32, dtype="float32"),
        data=tconfig.DataConfig(pretrained_resnet=str(tmp_path / "absent.npz"),
                                device_resident="off", auto_pack=False),
        train=tconfig.TrainConfig(batch_size=4, epochs=1))
    model = build_pose_model(cfg.model, device="cpu")
    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    Trainer(model=model, cfg=cfg, device="cpu",
            train_loader=ShardedLoader(ArrayDataset(make_synthetic_mpii(4, 48, seed=0)), 4,
                                         shuffle=False))
    assert all(torch.equal(v, before[k]) for k, v in model.net.state_dict().items())
