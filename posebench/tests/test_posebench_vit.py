"""The ViT reference (``reference/vit.py``), which a configuration file
names with ``"reference": "vit"``, against the port's ViT: ViT-T/16 at
64 px on the CPU, fp32 on both sides, one state dict.  Also the lookup,
the weights it makes (every leaf drawn), the fp8 control reaching the
dense layers and products, and the FLOPs and call shapes of ViT-S/16 at
448 px."""

import copy
import itertools

import pytest
import torch
import torch.nn.functional as F

from posebench import harness, inputs
from posebench.metrics._roofline import step_calls
from posebench.reference import head, model as M, preprocess as P, steps as R, vit as V


def vit_cell(cell: harness.Cell, base: str, size: int) -> harness.Cell:
    """``cell`` (ResNet-50 2x's training cell) with a ViT configuration:
    ``base`` at ``size`` px, the reference named ``vit``."""
    cfg = copy.deepcopy(cell.config_file)
    cfg["reference"] = "vit"
    cfg["config"]["model"].update(base=base, input_size=size, dilate=0)
    cell.config_file = cfg
    return cell


@pytest.fixture
def tiny_vit(tiny):
    """ViT-T/16 at 64 px in fp32 (4x4 patches, 8x8 maps), batch 4, a split
    of 32 rows."""
    cell = vit_cell(tiny("resnet50-2x-train-resident"), "vit_t16", 64)
    cell.config_file["config"]["model"]["dtype"] = "float32"
    return cell


@pytest.fixture
def vit_s16():
    """ViT-S/16 at 448 px (28x28 patches, 56x56 maps), batch 32."""
    return vit_cell(harness.load_cell("resnet50-2x-train-resident", 1, "cpu"),
                    "vit_s16", 448)


def _pair(cell):
    calib = inputs.make_split(4, inputs.canvas_side(cell.config), 5, "cpu")
    w = inputs.make_weights(cell.config, 5, calib, "cpu",
                            **cell.config_file["weights"]["made"])
    prog = harness.program_model(harness.program_config(cell), w, "cpu")
    return w, prog, R.build(cell.config, w, "cpu")


def _images(cell, train: bool):
    batch = {k: torch.as_tensor(v) for k, v in
             inputs.make_split(4, inputs.canvas_side(cell.config), 9, "cpu").items()}
    data, size = cell.config["data"], M.input_size(cell.config["model"])
    draws = P.draws(4, data, P.step_seed(11, 0), "cpu") if train else None
    return P.preprocess(batch, data, size, draws)


def test_lookup(tiny_vit, tiny):
    assert M.backbone_of(tiny_vit.config) is V
    assert "reference" not in tiny_vit.config_file["config"]
    default = tiny("resnet50-2x-train-resident")
    assert M.backbone_of(default.config) is M
    assert default.config is default.config_file["config"]
    with pytest.raises(ValueError, match="no backbone"):
        M.heatmap_side(tiny_vit.config["model"])


@pytest.mark.parametrize("train", [False, True])
def test_forward_follows_the_port(train, tiny_vit):
    """The same fp32 ops in the same order on both sides (the position
    embeddings summed before they are added, the logits scaled after the
    product): the maps agree to the bit on the CPU; the tolerance is one
    fp32 rounding of the largest map value, for a CPU whose kernels order
    their sums otherwise."""
    _, prog, ref = _pair(tiny_vit)
    pre = _images(tiny_vit, train)
    with torch.no_grad():
        a = prog.forward(pre["images"], train=train).heatmaps
        b = ref.train(train)(pre["images"])
    assert a.shape == b.shape == (1, 4, 16, 8, 8)
    torch.testing.assert_close(a, b, rtol=0, atol=2 ** -23 * float(b.abs().max()))


def test_first_gradients_follow_the_port(tiny_vit):
    """One train step's loss and every leaf's gradient from autograd on
    both sides, in fp32.  They differ by round-off in the backward's sums
    (at most 1e-8, 6e-7 of a leaf's largest element): each leaf is held at
    1e-5 of the larger of its own largest element and the median leaf's,
    since the score conv's bias has a gradient of nought (the softmax
    ignores a constant added to a map) and reads round-off alone."""
    w, prog, ref = _pair(tiny_vit)
    pre = _images(tiny_vit, True)
    mcfg = tiny_vit.config["model"]
    out = prog.forward(pre["images"], train=True)
    loss_p, _ = prog.loss(out, pre["coords"], pre["mask"])
    loss_p.backward()
    with M.strict_fp32():
        loss_r = head.pose_loss(R.forward(ref.train(), pre["images"], remat=True),
                                  pre["coords"], pre["mask"], mcfg)
    loss_r.backward()
    torch.testing.assert_close(loss_p, loss_r, rtol=1e-6, atol=0)
    grads = dict(ref.named_parameters())
    names = [n for n, _ in prog.net.named_parameters()]
    assert sorted(names) == sorted(grads) == sorted(w)
    largest = {n: float(p.grad.abs().max()) for n, p in grads.items()}
    floor = sorted(largest.values())[len(largest) // 2]
    for n, p in prog.net.named_parameters():
        atol = 1e-5 * max(largest[n], floor)
        torch.testing.assert_close(p.grad, grads[n].grad, rtol=0, atol=atol, msg=n)


def test_train_steps_follow_the_port(tiny_vit):
    """The compared steps through the cell's own feed against the
    reference's, read as a run reads them."""
    traffic = harness.generator(tiny_vit).Traffic(tiny_vit)
    traffic.release()
    got = traffic.readings()
    assert got["loss1_rel"] < 1e-5 and got["grad1_gap"] < 1e-4
    assert got["loss_rel"] < 1e-4 and got["change_median_gap"] < 1e-4


def test_controls_read_worse(tiny_vit):
    """fp8 on the dense layers, products and convs (and half the batch)
    read at least ten times the program's gaps."""
    traffic = harness.generator(tiny_vit).Traffic(tiny_vit)
    traffic.release()
    ref = traffic.reference()
    prog = traffic.compare(traffic.program(), ref)
    for control in ("fp8", "half_batch"):
        got = traffic.compare(traffic.reference(control), ref)
        for key in ("grad1_gap", "grad1_median_gap", "change_median_gap"):
            assert got[key] > 10 * prog[key], (control, key, got[key], prog[key])


def test_fp8_reaches_dense_layers_and_products():
    torch.manual_seed(0)
    lin = M.Linear(24, 8)
    x, a, b = torch.randn(3, 24), torch.randn(2, 5, 6), torch.randn(2, 6, 7)
    q = lambda t: M.fake_quant(t, torch.float8_e4m3fn)  # noqa: E731
    assert torch.equal(lin(x), F.linear(x, lin.weight, lin.bias))
    assert torch.equal(M.matmul(a, b), a @ b)
    with M.quantized():
        y, z = lin(x), M.matmul(a, b)
    assert torch.equal(y, q(F.linear(q(x), q(lin.weight), lin.bias)))
    assert torch.equal(z, q(q(a) @ q(b)))
    assert not torch.equal(y, lin(x)) and not torch.equal(z, a @ b)


@pytest.mark.parametrize("name", ["hg8-train-resident", "resnet50-2x-train-resident", "vit"])
def test_every_leaf_is_drawn(name, tiny, tiny_vit, monkeypatch):
    """Leaves are NaN before the draws; after ``make_weights`` every leaf
    is finite, every kernel and embedding varies, and a dense kernel's
    deviation is LeCun's, 1 / sqrt(fan-in) (``proj`` and ``fc2`` at the
    residual scale)."""
    cell = tiny_vit if name == "vit" else tiny(name)
    to_empty = torch.nn.Module.to_empty

    def nan_empty(self, *, device, recurse=True):
        out = to_empty(self, device=device, recurse=recurse)
        with torch.no_grad():
            for t in itertools.chain(out.parameters(), out.buffers()):
                if t.is_floating_point():
                    t.fill_(float("nan"))
        return out

    monkeypatch.setattr(torch.nn.Module, "to_empty", nan_empty)
    calib = inputs.make_split(4, inputs.canvas_side(cell.config), 5, "cpu")
    made = cell.config_file["weights"]["made"]
    w = inputs.make_weights(cell.config, 5, calib, "cpu", **made)
    for k, v in w.items():
        assert torch.isfinite(v).all(), k
        if v.dim() >= 2:
            assert float(v.float().std()) > 0, k
    if name != "vit":
        return
    for k, v in w.items():
        if k.endswith((".qkv.weight", ".fc1.weight", ".proj.weight", ".fc2.weight")):
            scale = made["residual_scale"] if k.endswith((".proj.weight", ".fc2.weight")) else 1.0
            want = scale / v.shape[1] ** 0.5
            assert float(v.std()) == pytest.approx(want, rel=0.1), k
        elif k.endswith("ln1.weight"):
            assert torch.equal(v, torch.ones_like(v)), k
        elif k.endswith(("pos_row", "pos_col")):
            assert float(v.std()) == pytest.approx(V.POS_STD, rel=0.2), k


def test_flops_vit_s16_by_hand(vit_s16):
    """Multiply-adds as two operations each, per image at 448 px: N = 784
    tokens of D = 384, 12 blocks, 16 joints.  The patch conv 2 N D 768;
    a block 24 N D^2 (qkv 6, proj 2, the MLP 16) and 4 N^2 D (logits and
    the probabilities times v); ``up_proj`` N D^2; ``refine`` 18 N D^2 and
    ``score`` 4 N D 16 on the 4N pixels of the 56x56 maps.  Training adds
    twice the forward, less the patch conv's input gradient (the images
    need none)."""
    n, d, depth, joints = 28 * 28, 384, 12, 16
    patch = 2 * n * d * 768
    fwd = (patch + depth * (24 * n * d * d + 4 * n * n * d) + n * d * d
           + 18 * n * d * d + 4 * n * d * joints)
    assert fwd == 47_301_918_720
    assert inputs.flops(vit_s16.config, 1, train=False) == fwd
    assert inputs.flops(vit_s16.config, 2, train=True) == 2 * (3 * fwd - patch)


def test_step_calls_vit_s16(vit_s16):
    """One stack of 56x56 maps: 32 x 16 rows a train step, 3 x 16 for a
    3-crop request."""
    from dsnt_pose2d_tpu_torch.models.factory import PoseModel

    head = {"rows": 512, "hw": 56 * 56, "reg": "none"}
    calls = step_calls(vit_s16.config, 32, train=True)
    assert calls["dsnt_head_fwd"] == calls["dsnt_head_bwd"] == [head]
    assert step_calls(vit_s16.config, 3, train=False)["dsnt_head_fwd"] == [
        {**head, "rows": 48}]
    cfg = harness.program_config(vit_s16)
    side = PoseModel(net=None, cfg=cfg.model, device=torch.device("cpu")).heatmap_size
    assert M.backbone_of(vit_s16.config).heatmap_side(vit_s16.config["model"]) == side == 56
