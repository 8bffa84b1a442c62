"""Train-mode BatchNorm (+ReLU) on the CPU: the Hopper kernels' backward
formula against autograd of the composition in fp64, the ``relu`` flag of
``models/hourglass.py::BatchNorm``, the autograd Function over the kernels
with their launches replaced by plain versions (its running-statistics flag
under remat), and the state-dict keys the flax variables map onto.

The kernels themselves run on the card only (``tests/test_torch_kernels.py``,
marker ``cuda``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from dsnt_pose2d_tpu_torch.models.from_jax import hourglass_from_jax, resnet_from_jax
from dsnt_pose2d_tpu_torch.models.hourglass import BatchNorm, HourglassNet, remat
from dsnt_pose2d_tpu_torch.models.resnet import ResNetPose
from dsnt_pose2d_tpu_torch.ops.cuda import batch_norm as bn
from port_helpers import jax_backbone

# A constant channel of 2.3 gives E[x^2] - E[x]^2 < 0 in fp64 at these
# shapes (checked in the test), so the clamp stops the variance's gradient.
CONSTANT = 2.3
BWD_CASES = {
    "7x7": (4, 5, 7, 7, False),
    "4x4": (3, 4, 4, 4, False),
    "64x64": (2, 3, 64, 64, False),
    "n1": (1, 4, 8, 8, False),
    "const_7x7": (4, 3, 7, 7, True),
    "const_64x64": (2, 3, 64, 64, True),
}


def _inputs(n, c, h, w, constant, seed=0, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, c, h, w, generator=g, dtype=dtype)
    x = x * (torch.rand(c, 1, 1, generator=g, dtype=dtype) + 0.5) + torch.randn(
        c, 1, 1, generator=g, dtype=dtype)
    if constant:
        x[:, 0] = CONSTANT
    dy = torch.randn(n, c, h, w, generator=g, dtype=dtype)
    params = [torch.rand(c, generator=g, dtype=dtype) + 0.5,
              torch.randn(c, generator=g, dtype=dtype) * 0.3,
              torch.randn(c, generator=g, dtype=dtype),
              torch.rand(c, generator=g, dtype=dtype) + 0.5]
    return x, dy, params


def _autograd(fn, x, dy, params, relu, **kw):
    """y, running statistics and (dx, dweight, dbias) of ``fn``, from copies."""
    w, b, rm, rv = (p.clone() for p in params)
    w.requires_grad_(True)
    b.requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    y = fn(xg, w, b, rm, rv, relu=relu, **kw)
    y.backward(dy)
    return y.detach(), rm, rv, xg.grad, w.grad, b.grad


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_bwd_reference_matches_fp64_autograd(case, relu):
    *shape, constant = BWD_CASES[case]
    x, dy, params = _inputs(*shape, constant)
    dims = (0, 2, 3)
    count = x.numel() // shape[1]
    if constant:
        mean = x.mean(dims)
        assert ((x * x).mean(dims) - mean * mean)[0] < 0
        s = x.sum(dims)
        assert ((x * x).sum(dims) / count - (s / count) ** 2)[0] < 0
    _, _, _, dx, dw, db = _autograd(bn.batch_norm_train_reference, x, dy, params, relu)
    sums = torch.cat([x.sum(dims), (x * x).sum(dims)])
    got = bn.batch_norm_train_bwd_reference(x, dy, params[0], params[1], sums, count,
                                            relu=relu)
    for a, e in zip(got, (dx, dw, db)):
        torch.testing.assert_close(a, e, rtol=1e-10, atol=1e-10 * e.abs().max().item())


def test_bwd_reference_takes_a_data_groups_sums():
    # dx follows the all-reduced [sum g, sum g xhat]; dweight and dbias stay
    # this x's own: two halves of a batch, each with the whole batch's sums,
    # give the whole batch's dx and, summed, its dweight and dbias.
    x, dy, params = _inputs(4, 3, 5, 5, False)
    dims = (0, 2, 3)
    sums = torch.cat([x.sum(dims), (x * x).sum(dims)])
    whole = bn.batch_norm_train_bwd_reference(x, dy, *params[:2], sums, 100, relu=True)
    grad_sums = torch.cat([whole[2], whole[1]])
    halves = [bn.batch_norm_train_bwd_reference(x[i:i + 2], dy[i:i + 2], *params[:2],
                                                sums, 100, relu=True, grad_sums=grad_sums)
              for i in (0, 2)]
    torch.testing.assert_close(torch.cat([h[0] for h in halves]), whole[0],
                               rtol=1e-12, atol=1e-12)
    for k in (1, 2):
        torch.testing.assert_close(halves[0][k] + halves[1][k], whole[k],
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("train", [True, False])
def test_relu_flag_equals_relu_after_bn(train):
    torch.manual_seed(0)
    fused, plain = BatchNorm(6, relu=True), BatchNorm(6)
    with torch.no_grad():
        for m in (fused, plain):
            m.weight.copy_(torch.linspace(0.5, 1.5, 6))
            m.bias.copy_(torch.linspace(-0.4, 0.4, 6))
            m.running_mean.copy_(torch.linspace(-1, 1, 6))
    fused.train(train)
    plain.train(train)
    x = torch.randn(3, 6, 5, 5) * 2 + 0.3
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    ya, yb = fused(xa), F.relu(plain(xb))
    assert torch.equal(ya, yb)
    dy = torch.randn_like(ya)
    ya.backward(dy)
    yb.backward(dy)
    assert torch.equal(xa.grad, xb.grad)
    assert torch.equal(fused.weight.grad, plain.weight.grad)
    for k, v in fused.state_dict().items():
        assert torch.equal(v, plain.state_dict()[k]), k
    assert set(fused.state_dict()) == set(plain.state_dict())


# -- the autograd Function with plain versions of its four kernels ----------


def _plain_kernels(monkeypatch):
    """The Function's launches replaced by plain torch versions of the four
    kernels, so it runs on CPU tensors (in fp64 here)."""

    def geometry(x, dy, eps, relu):
        n, c, h, w = x.shape
        return {"count": n * h * w * bn.axis_size(bn.DATA_AXIS), "eps": eps, "relu": relu,
                "vec": 1}

    def reduce(kind, g, x, dy=None, tot=None, w=None, b=None, dw=None, db=None):
        acc = torch.promote_types(x.dtype, torch.float32)
        xf, dims = x.to(acc), (0, 2, 3)
        if kind == bn._STATS:
            return torch.cat([xf.sum(dims), (xf * xf).sum(dims)])
        _, dweight, dbias = bn.batch_norm_train_bwd_reference(
            x, dy, w, b, tot, g["count"], g["eps"], g["relu"])
        dw.copy_(dweight)
        db.copy_(dbias)
        return torch.cat([dbias, dweight])

    def launch(kind, g, x, dy=None, out=None, tot=None, dtot=None, w=None, b=None,
               rmean=None, rvar=None):
        if kind == bn._BWD:
            out.copy_(bn.batch_norm_train_bwd_reference(
                x, dy, w, b, tot, g["count"], g["eps"], g["relu"], grad_sums=dtot)[0])
            return
        acc = torch.promote_types(x.dtype, torch.float32)
        s1, s2 = tot.to(acc).chunk(2)
        mean = s1 / g["count"]
        var = (s2 / g["count"] - mean * mean).clamp_min(0.0)
        if rmean is not None:
            rmean.copy_(bn.MOMENTUM * rmean + (1 - bn.MOMENTUM) * mean)
            rvar.copy_(bn.MOMENTUM * rvar + (1 - bn.MOMENTUM) * var)
        mul = torch.rsqrt(var + g["eps"]) * w
        y = ((x.to(acc) - mean[:, None, None]) * mul[:, None, None]
             + b[:, None, None]).to(x.dtype)
        out.copy_(F.relu(y) if g["relu"] else y)

    monkeypatch.setattr(bn, "_geometry", geometry)
    monkeypatch.setattr(bn, "_reduce", reduce)
    monkeypatch.setattr(bn, "_launch", launch)


def _function(x, w, b, rm, rv, eps=bn.EPS, relu=False, update_running=True):
    return bn.BatchNormTrain.apply(x, w, b, rm, rv, eps, relu, update_running)


@pytest.mark.parametrize("memory_format", [torch.contiguous_format, torch.channels_last])
@pytest.mark.parametrize("relu", [False, True])
def test_function_matches_the_composition(monkeypatch, relu, memory_format):
    _plain_kernels(monkeypatch)
    x, dy, params = _inputs(3, 4, 6, 6, True)
    x = x.contiguous(memory_format=memory_format)
    before = bn.fwd_launches, bn.bwd_launches
    got = _autograd(_function, x, dy, params, relu)
    assert (bn.fwd_launches - before[0], bn.bwd_launches - before[1]) == (1, 1)
    exp = _autograd(bn.batch_norm_train_reference, x, dy, params, relu)
    assert got[0].stride() == x.stride()
    for a, e in zip(got, exp):
        torch.testing.assert_close(a, e, rtol=1e-10, atol=1e-10 * e.abs().max().item())


def test_function_leaves_running_statistics_when_asked(monkeypatch):
    _plain_kernels(monkeypatch)
    x, dy, params = _inputs(2, 3, 4, 4, False)
    _, rm, rv, *_ = _autograd(_function, x, dy, params, True, update_running=False)
    assert torch.equal(rm, params[2]) and torch.equal(rv, params[3])


@pytest.mark.parametrize("kernels", ["composition", "function"])
def test_remat_moves_fused_relu_bn_statistics_once(monkeypatch, kernels):
    # A remat scope of two conv + BN-ReLU pairs: its forward recomputed in
    # the backward pass moves the running statistics once, and the outputs
    # and gradients are those of the scope without remat; with the Function
    # (its kernels' plain versions) the recompute passes update_running=False.
    if kernels == "function":
        _plain_kernels(monkeypatch)
        monkeypatch.setattr(bn, "batch_norm_train", _function)
    torch.manual_seed(1)
    block = nn.Sequential(nn.Conv2d(3, 5, 3, padding=1), BatchNorm(5, relu=True),
                          nn.Conv2d(5, 4, 1), BatchNorm(4, relu=True)).double().train()
    start = {k: v.clone() for k, v in block.state_dict().items()}
    x = torch.randn(2, 3, 6, 6, dtype=torch.float64)
    out = {}
    for use_remat in (False, True):
        block.load_state_dict(start)
        block.zero_grad()
        xg = x.clone().requires_grad_(True)
        y = remat(block, xg) if use_remat else block(xg)
        (y * y).sum().backward()
        out[use_remat] = (y.detach(), xg.grad,
                          {n: p.grad.clone() for n, p in block.named_parameters()},
                          {k: v.clone() for k, v in block.state_dict().items()})
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])
    for n, g in out[False][2].items():
        assert torch.equal(out[True][2][n], g), n
    for k, v in out[False][3].items():
        assert torch.equal(out[True][3][k], v), k
    assert not torch.equal(out[True][3]["1.running_mean"], start["1.running_mean"])


# -- state-dict keys ----------------------------------------------------------


def _flax_variables(base, depth=1, **kw):
    module = jax_backbone(base, 16, jnp.float32, features=16, depth=depth, **kw)
    side = 64
    return jax.device_get(module.init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, side, side, 3)), train=False))


@pytest.mark.parametrize("base", ["hg2", "resnet18", "resnet50"])
def test_state_dict_keys_are_the_flax_variables(base):
    # The relu flag is an attribute, not a buffer: every backbone's keys are
    # the ones the flax variables map onto, and the mapped state loads strictly.
    if base.startswith("hg"):
        mapped = hourglass_from_jax(_flax_variables(base), num_stacks=2, depth=1)
        net = HourglassNet(num_stacks=2, num_joints=16, features=16, depth=1)
    else:
        mapped = resnet_from_jax(_flax_variables(base, dilate=1))
        net = ResNetPose(base, num_joints=16, dilate=1)
    assert set(net.state_dict()) == set(mapped)
    net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in mapped.items()},
                        strict=True)
    assert any(isinstance(m, BatchNorm) and m.relu for m in net.modules())


# -- the kernels' geometry ----------------------------------------------------


@pytest.mark.parametrize("shape", [(32, 256, 64, 64), (32, 128, 4, 4), (32, 64, 224, 224),
                                   (32, 2048, 56, 56), (2, 3, 7, 7), (1, 96, 5, 5)])
@pytest.mark.parametrize("layout", [bn.PLANES, bn.ROWS])
@pytest.mark.parametrize("grid", sorted(bn.GRIDS.values()))
def test_plan_covers_every_value_once(shape, layout, grid):
    # The grid the wrapper sizes from the shape: its tiles cover the
    # channels, its chunks the values of a tile, within the grid's limits
    # (the kernels take chunk k as the values [k * per, (k + 1) * per)).
    n, c, h, w = shape
    vec = bn.vector_width(torch.bfloat16, layout, c, h * w, 0)
    chunks, tiles, tx = bn.plan(layout, n, c, h * w, vec, 132, grid)
    work = n * h * w // vec if layout == bn.PLANES else n * h * w
    per = -(-work // chunks)
    assert 1 <= chunks <= bn.MAX_CHUNKS and (chunks - 1) * per < work <= chunks * per
    if layout == bn.PLANES:
        assert (tiles, tx) == (c, 1)
    else:
        assert tx & (tx - 1) == 0 and tx <= grid[1] and (tiles - 1) * tx * vec < c <= tiles * tx * vec
    assert chunks * tiles <= max(grid[0] * 132, tiles)


def test_vector_width_falls_back_to_scalar():
    assert bn.vector_width(torch.bfloat16, bn.ROWS, 256, 49, 0) == 8
    assert bn.vector_width(torch.float32, bn.ROWS, 256, 49, 0) == 4
    assert bn.vector_width(torch.bfloat16, bn.PLANES, 256, 49, 0) == 1    # 49 % 8
    assert bn.vector_width(torch.bfloat16, bn.ROWS, 100, 64, 0) == 1      # 100 % 8
    assert bn.vector_width(torch.bfloat16, bn.ROWS, 256, 64, 0, 8) == 1   # misaligned
    assert bn.layout_of(torch.zeros(2, 3, 4, 5)) == bn.PLANES
    assert bn.layout_of(torch.zeros(2, 3, 4, 5).to(memory_format=torch.channels_last)) == bn.ROWS
    assert bn.layout_of(torch.zeros(2, 3, 4, 5)[..., ::2]) is None
