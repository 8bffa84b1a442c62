"""The port's HRNet (``models/hrnet.py``) against the benchmark's plain fp32
reference (``posebench/reference/hrnet.py``), on the CPU: the published
W48's key layout, size and layer counts, its forward FLOPs, a tiny preset's
maps and gradients in fp32 and its maps under bf16 autocast, W48's maps at
a small input, and the factory, config and converter around it.  The JAX
package has no HRNet, so the reference is the plain one."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from dsnt_pose2d_tpu_torch.models import hrnet
from dsnt_pose2d_tpu_torch.models.factory import build_mpii_pose_model, init_weights
from dsnt_pose2d_tpu_torch.models.from_jax import pose_net_from_jax
from dsnt_pose2d_tpu_torch.models.hourglass import BatchNorm
from dsnt_pose2d_tpu_torch.utils.config import ModelConfig, config_from_json
from posebench.reference import head as RHEAD
from posebench.reference import hrnet as RH
from posebench.reference import model as M
from posebench.reference import steps as R

ROOT = Path(__file__).resolve().parent.parent
W48 = hrnet.HRNET_SPECS["hrnet_w48"]
# Widths 8/16/32/64, one BasicBlock a branch, one module a stage, one
# stage-1 bottleneck: every kind of layer and fuse term of W48, small.
TINY = {"widths": (8, 16, 32, 64), "blocks": 1, "modules": (1, 1, 1), "stage1_blocks": 1}
HEAD = {"output_strat": "dsnt", "preact": "softmax", "coord_loss": "euclidean",
        "stack_loss": "sum", "reg": "js", "reg_coeff": 1.0, "hm_sigma": 1.0}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def w48():
    """The port's and the reference's W48, the reference holding the port's
    weights."""
    port = hrnet.HRNetPose(16, **W48)
    init_weights(port, torch.Generator().manual_seed(0))
    ref = RH.HRNetPose(16, **W48)
    ref.load_state_dict(port.state_dict(), strict=True)
    return port, ref


def _pair(spec: dict, seed: int, dtype=torch.float32):
    """A port and a reference of ``spec`` with one state dict: flax's
    initializers, then BN scales in [0.5, 1.5) and biases of deviation 0.2,
    so that every BN's affine reaches the maps."""
    port = hrnet.HRNetPose(16, dtype=dtype, **spec)
    init_weights(port, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(100 + seed)
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, BatchNorm):
                m.weight.copy_(0.5 + torch.rand(m.weight.shape, generator=gen))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=gen))
    ref = RH.HRNetPose(16, **spec)
    ref.load_state_dict(port.state_dict(), strict=True)
    images = torch.randn(2, 64, 64, 3, generator=gen)
    return port.train(), ref.train(), images


def test_w48_state_dicts_load_both_ways(w48):
    port, ref = w48
    a, b = port.state_dict(), ref.state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape for k in a)
    port.load_state_dict(b, strict=True)
    ref.load_state_dict(a, strict=True)
    assert {"stage4_module2.fuse0_3.0.conv.weight", "stage3_module3.fuse2_0.1.bn.bias",
            "stage2_module0.branch1_block3.conv2.weight", "transition4_3.bn.weight",
            "stage1_block0.bn_proj.running_var", "score.bias"} <= set(a)


def test_w48_size_and_layers(w48):
    """63.6M parameters (the paper's Table 1), 292 BNs and 293 convs:
    stem 2, stage 1 13, transitions 4, stage 2 18 (16 in blocks, 2 fuse),
    stage 3 4 x 31 (24 + 7), stage 4 48 + 48 + 35 (32 + 16 each, the last
    module's fuse 3), and the score conv."""
    port, ref = w48
    count = sum(p.numel() for p in port.parameters())
    assert count == sum(p.numel() for p in ref.parameters()) == 63_595_696
    assert abs(count / 63.6e6 - 1) < 0.01
    for kind in (torch.nn.BatchNorm2d, torch.nn.Conv2d):
        got = sum(isinstance(m, kind) for m in port.modules())
        assert got == sum(isinstance(m, kind) for m in ref.modules())
    assert sum(isinstance(m, BatchNorm) for m in port.modules()) == 292
    assert sum(isinstance(m, torch.nn.Conv2d) for m in port.modules()) == 293
    assert sum(isinstance(m, hrnet.HighResolutionModule) for m in port.modules()) == 8


def _flops(net) -> float:
    with torch.device("meta"):
        images = torch.empty(1, 256, 256, 3)
    counter = FlopCounterMode(display=False)
    with counter:
        net(images)
    return counter.get_total_flops()


def test_w48_forward_flops_at_256px():
    """Multiply-adds as two operations each: 20.92 GMAC an image, 7.5%
    over the paper's 14.6 GFLOPs at 256x192 scaled by 4/3 (the same count
    gives W32 7.65 GMAC at 256x192 against its 7.1)."""
    with torch.device("meta"):
        port = hrnet.HRNetPose(16, **W48).eval()
        ref = RH.HRNetPose(16, **W48).eval()
    assert _flops(port) == _flops(ref) == 41_844_473_856


def test_tiny_maps_and_gradients_follow_the_reference():
    """fp32, train-mode BN at batch 2: the same ops in the same order on
    both sides.  Maps within 1e-5 of the largest; after the head's loss
    (the reference's, on both) and one backward every leaf's gradient
    within 1e-5 of its norm (round-off in the backward's sums)."""
    port, ref, images = _pair(TINY, 1)
    a, b = port(images), ref(images)
    assert a.shape == b.shape == (1, 2, 16, 16, 16) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.detach().abs().max()))
    gen = torch.Generator().manual_seed(7)
    target = torch.rand(2, 16, 2, generator=gen) * 2 - 1
    mask = torch.ones(2, 16)
    RHEAD.pose_loss(a, target, mask, HEAD).backward()
    RHEAD.pose_loss(b, target, mask, HEAD).backward()
    grads = dict(ref.named_parameters())
    for name, p in port.named_parameters():
        want = grads[name].grad
        tol = 1e-5 * float(want.norm())
        assert float((p.grad - want).norm()) <= tol, name


def test_w48_maps_follow_the_reference_at_64px(w48):
    """The published widths at a 64-px input (branches at 16x16 down to
    2x2), fp32, train-mode BN at batch 2: maps within 1e-4 of the largest."""
    port, ref = w48
    images = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        a, b = port.train()(images), ref.train()(images)
    assert a.shape == (1, 2, 16, 16, 16)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()))


# bf16 keeps 8 significant bits (each rounding within 2^-9 of the value);
# over the tiny preset's ~40 layers the maps read 2.0-2.9% of the largest
# map value off fp32 on seeds 0-5, e4m3 (4 bits, 2^-5) 26-42%.  The bound
# lies near their geometric mean, ~3x from each.
BF16_BOUND = 0.08


@pytest.mark.parametrize("seed", [0, 1])
def test_tiny_bf16_within_its_bound_and_fp8_beyond(seed):
    port, ref, images = _pair(TINY, seed, dtype=torch.bfloat16)
    with torch.no_grad():
        want = ref(images)
        bf16 = port(images)
        fp8 = R.forward(ref, images, "fp8")
    assert bf16.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((bf16 - want).abs().max()) < BF16_BOUND * scale
    assert float((fp8 - want).abs().max()) > BF16_BOUND * scale


def test_factory_and_config():
    model = build_mpii_pose_model(base="hrnet_w48", reg="js", device="cpu")
    assert isinstance(model.net.backbone, hrnet.HRNetPose)
    assert model.input_size == 256 and model.heatmap_size == 64
    assert model.net.backbone.output_side(256) == 64
    assert model.net.backbone.output_side(250) == 63
    text = (ROOT / "posebench" / "configs" / "hrnet_w48_dsnt_js_train.json").read_text()
    cfg = config_from_json(json.dumps(json.loads(text)["config"]))
    assert cfg.model.base == "hrnet_w48" and cfg.model.resolved_input_size == 256
    assert ModelConfig(base="hrnet_w48").resolved_input_size == 256
    with pytest.raises(ValueError, match="JAX package has no HRNet"):
        pose_net_from_jax({"params": {}}, cfg.model)


def test_reference_module_for_the_harness():
    model = {"base": "hrnet_w48", "input_size": 256, "num_joints": 16}
    assert M.backbone_of({"reference": "hrnet"}) is RH
    assert RH.stacks(model) == 1 and RH.heatmap_side(model) == 64
    with torch.device("meta"):
        net = RH.backbone(model)
    assert isinstance(net, RH.HRNetPose) and net.score_convs() == [net.score]
    # Another base goes to the default module.
    assert isinstance(RH.backbone({"base": "resnet18"}), M.ResNetPose)
