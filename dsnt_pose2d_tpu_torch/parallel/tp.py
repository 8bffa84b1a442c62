"""Tensor parallelism over the mesh's ``model`` axis (port of
``dsnt_pose2d_tpu/parallel/tp.py``).

The JAX package annotates every train-state leaf of 2 or more dimensions
whose trailing dimension divides the axis size ``t`` as ``P(..., 'model')``
and leaves the rest replicated; GSPMD then partitions the convs and
matmuls and inserts the collectives.  The port has no GSPMD, so it does the
same by hand, Megatron's column-parallel way:

- :func:`shard_model_` keeps, on model rank ``i``, block ``i`` of ``t`` of
  the trailing dimension of each leaf the JAX rule shards (:func:`sharded`),
  keyed on the FLAX leaf's shape: conv kernels ``(kh, kw, cin, cout)`` (the
  port's ``(cout, cin, kh, kw)``, so its dim 0), dense kernels
  ``(cin, cout)``, the ViT's ``qkv`` kernel ``(D, 3, H, hd)`` and bias
  ``(3, H, hd)`` (sharded on ``hd``: the port's ``(3D, D)`` rows viewed as
  ``(3, H, hd, D)``, so each rank holds exactly JAX's elements, a strided
  set of rows), the ViT's position embeddings ``(g, D)`` and the fc head's
  kernel ``(J, P, 2)`` and bias ``(J, 2)``.  1-D biases, BN and LayerNorm
  vectors stay whole.  Each sharded ``Parameter`` keeps its object and
  holds its shard, tagged ``p.tp`` (a :class:`Shard`); the optimizer's
  per-parameter state (RMSProp's ``square_avg``, momenta) is made from the
  shard, so it is sharded with it, as optax's moments follow by shape.
- :func:`conv2d` and :func:`linear` compute a module's share of its output
  features from its shard and gather them over the model group before the
  next op; the input's gradient, a partial sum on each rank, is summed
  over the model group (:func:`copy_to_model`).  Everything else (BN,
  ReLU, the adds, LayerNorm, attention, the DSNT head) runs on whole
  tensors on every model rank.
- the gather is an all-reduce of a zeroed buffer holding this rank's block
  (exact: each element sums one value and zeros), since gloo carries only
  all-reduce and broadcast for CUDA tensors.
- :func:`whole_state_dict` and :func:`whole_optimizer_state` gather a
  rank's shards into whole tensors (checkpoints stay whole, in the layout
  of a one-process run); :func:`load_whole_state_dict_` and
  :func:`local_optimizer_state` take a rank's shards back out of them, so
  a checkpoint moves between widths bitwise.

As the JAX package says, at hg8's ~26M parameters this is a scaling valve,
not a win: the collectives cost more than the memory they save.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .mesh import (GRAD_BUCKET_BYTES, MODEL_AXIS, _all_reduce, _bucketed,
                   axis_index, axis_size)


def tp_size(mesh) -> int:
    """Size of the ``model`` axis (1 = tensor parallelism off)."""
    return int(mesh.shape.get(MODEL_AXIS, 1))


def sharded(flax_shape, t: int) -> bool:
    """The JAX package's ``leaf_sharding`` rule: a leaf of 2 or more
    dimensions whose trailing dimension divides ``t`` is sharded on it."""
    return t > 1 and len(flax_shape) >= 2 and flax_shape[-1] % t == 0


@dataclass(frozen=True)
class Layout:
    """Where a port tensor's elements sit in its flax leaf: the tensor, of
    ``shape``, viewed as ``view`` (its own element order) has the flax
    leaf's trailing dimension at ``dim``, which lies in its own dimension
    ``torch_dim``."""

    shape: tuple
    flax_shape: tuple
    view: tuple
    dim: int
    torch_dim: int


def _as_is(shape) -> Layout:
    shape = tuple(shape)
    return Layout(shape, shape, shape, len(shape) - 1, len(shape) - 1)


def leaf_layouts(net: nn.Module) -> dict:
    """``{parameter name: Layout}`` of a whole model (before
    :func:`shard_model_`).  Convs and denses by their module's widths (a
    dense's flax output features are ``flax_features`` where it has them,
    the ViT's ``qkv``'s ``(3, H, hd)``); every other parameter has the flax
    leaf's shape."""
    out = {n: _as_is(p.shape) for n, p in net.named_parameters()}
    for prefix, mod in net.named_modules():
        pre = f"{prefix}." if prefix else ""
        if isinstance(mod, nn.Conv2d):
            cout, cin = mod.out_channels, mod.in_channels // mod.groups
            kh, kw = mod.kernel_size
            shape = (cout, cin, kh, kw)
            out[pre + "weight"] = Layout(shape, (kh, kw, cin, cout), shape, 0, 0)
        elif isinstance(mod, nn.Linear):
            feats = tuple(getattr(mod, "flax_features", (mod.out_features,)))
            fin = mod.in_features
            out[pre + "weight"] = Layout((mod.out_features, fin), (fin, *feats),
                                         (*feats, fin), len(feats) - 1, 0)
            if mod.bias is not None:
                out[pre + "bias"] = Layout((mod.out_features,), feats, feats,
                                           len(feats) - 1, 0)
    return out


@dataclass(frozen=True)
class Shard:
    """Block ``index`` of ``size`` along ``layout.dim``: what a model rank
    holds of a sharded leaf."""

    layout: Layout
    index: int
    size: int

    @property
    def local_view(self) -> tuple:
        v = list(self.layout.view)
        v[self.layout.dim] //= self.size
        return tuple(v)

    @property
    def local_shape(self) -> tuple:
        s = list(self.layout.shape)
        s[self.layout.torch_dim] //= self.size
        return tuple(s)

    def take(self, whole: torch.Tensor) -> torch.Tensor:
        """This shard of a whole tensor (a new, contiguous one)."""
        n = self.layout.view[self.layout.dim] // self.size
        block = whole.reshape(self.layout.view).narrow(
            self.layout.dim, self.index * n, n)
        return block.reshape(self.local_shape).clone()


def shard_of(t) -> Shard | None:
    """The :class:`Shard` a parameter holds, None for a whole one."""
    return getattr(t, "tp", None)


@torch.no_grad()
def shard_model_(net: nn.Module, mesh) -> nn.Module:
    """Keep only this rank's shard of every leaf that :func:`sharded`
    shards on ``mesh``'s model axis, in place (each ``Parameter`` object
    stays, holding its shard and tagged ``p.tp``); returns ``net``.  Call it
    on the whole model, before an optimizer is made over it.  A model
    already sharded for this rank of this width is left as it is; one
    sharded otherwise raises ``ValueError``."""
    t, i = tp_size(mesh), mesh.model_index
    params = dict(net.named_parameters())
    held = {(s.index, s.size) for s in map(shard_of, params.values()) if s}
    if held:
        if held != {(i, t)}:
            raise ValueError(f"model sharded as {sorted(held)} (index, width), "
                             f"this rank is {i} of {t}")
        return net
    if t == 1:
        return net
    for name, layout in leaf_layouts(net).items():
        if sharded(layout.flax_shape, t):
            p, s = params[name], Shard(layout, i, t)
            p.data = s.take(p.data)
            p.tp = s
    return net


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model
    group (each rank's column-parallel op gives a partial input gradient)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        _all_reduce(g, MODEL_AXIS)
        return g


class _GatherFromModel(torch.autograd.Function):
    """Each model rank's block of dimension ``dim`` -> the whole tensor on
    every model rank (an all-reduce of a zeroed buffer holding this rank's
    block); the backward takes this rank's block of the gradient (every
    model rank holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, dim):
        t, i = axis_size(MODEL_AXIS), axis_index(MODEL_AXIS)
        dim %= x.dim()
        n = x.shape[dim]
        out = x.new_zeros((*x.shape[:dim], n * t, *x.shape[dim + 1:]))
        out.narrow(dim, i * n, n).copy_(x)
        _all_reduce(out, MODEL_AXIS)
        ctx.block = (dim, i * n, n)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(*ctx.block), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the input of a column-parallel op: its gradient is summed
    over the model group."""
    return _CopyToModel.apply(x) if axis_size(MODEL_AXIS) > 1 else x


def gather_features(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model ranks' blocks of dimension ``dim``, joined in rank order."""
    return _GatherFromModel.apply(x, dim) if axis_size(MODEL_AXIS) > 1 else x


def conv2d(mod: nn.Conv2d, x, weight, bias):
    """``mod``'s conv of ``x`` with ``weight`` and ``bias`` (its parameters,
    cast as the caller wants them): column-parallel when its kernel is
    sharded (this rank's output channels, gathered, then the whole bias)."""
    if shard_of(mod.weight) is None:
        return mod._conv_forward(x, weight, bias)
    y = gather_features(mod._conv_forward(copy_to_model(x), weight, None), 1)
    return y if bias is None else y + bias.to(y.dtype)[:, None, None]


def linear(mod: nn.Linear, x, weight, bias):
    """``F.linear(x, weight, bias)`` for ``mod``: column-parallel when its
    kernel is sharded (this rank's output features, with its shard of a
    sharded bias, gathered along the flax features' trailing dimension;
    a whole bias is added after)."""
    s = shard_of(mod.weight)
    if s is None:
        return F.linear(x, weight, bias)
    local_bias = bias if shard_of(mod.bias) is not None else None
    feats = s.local_view[:s.layout.dim + 1]
    y = F.linear(copy_to_model(x), weight, local_bias).unflatten(-1, feats)
    y = gather_features(y, -1).flatten(-len(feats))
    return y if bias is None or local_bias is not None else y + bias


def gather_whole(pairs) -> list:
    """Whole tensors from ``(local tensor, Shard)`` pairs: zeroed buffers
    holding this rank's blocks, summed over the model group in buckets
    (collective over the model group)."""
    wholes = []
    for local, s in pairs:
        w = local.new_zeros(s.layout.view)
        n = s.local_view[s.layout.dim]
        w.narrow(s.layout.dim, s.index * n, n).copy_(local.reshape(s.local_view))
        wholes.append(w)
    _bucketed(wholes, lambda flat: _all_reduce(flat, MODEL_AXIS),
              GRAD_BUCKET_BYTES)
    return [w.reshape(s.layout.shape) for w, (_, s) in zip(wholes, pairs)]


def whole_state_dict(net: nn.Module) -> dict:
    """``net.state_dict()`` with every shard gathered whole (collective over
    the model group: every rank of it calls this)."""
    sd = net.state_dict()
    params = dict(net.named_parameters())
    keys = [k for k in sd if shard_of(params.get(k)) is not None]
    if keys:
        sd.update(zip(keys, gather_whole([(sd[k].detach(), params[k].tp)
                                           for k in keys])))
    return sd


def load_whole_state_dict_(net: nn.Module, whole: dict):
    """Load a whole state dict into ``net``, each sharded parameter taking
    its shard (strict, no collective)."""
    params = dict(net.named_parameters())
    net.load_state_dict({k: params[k].tp.take(v) if shard_of(params.get(k))
                         else v for k, v in whole.items()}, strict=True)


def _opt_params(opt) -> list:
    return [p for g in opt.param_groups for p in g["params"]]


def whole_optimizer_state(opt) -> dict:
    """``opt.state_dict()`` with the state of each sharded parameter of its
    shard's shape gathered whole (collective over the model group)."""
    sd = opt.state_dict()
    params = _opt_params(opt)
    state = {i: dict(st) for i, st in sd["state"].items()}
    jobs = [(i, k) for i, st in state.items() if shard_of(params[i])
            for k, v in st.items()
            if torch.is_tensor(v) and v.shape == params[i].shape]
    if jobs:
        wholes = gather_whole([(state[i][k], params[i].tp) for i, k in jobs])
        for (i, k), w in zip(jobs, wholes):
            state[i][k] = w
    return {**sd, "state": state}


def local_optimizer_state(opt, whole: dict) -> dict:
    """A whole optimizer state dict (:func:`whole_optimizer_state`'s) with
    each sharded parameter's state of the whole leaf's shape cut to this
    rank's shard, for ``opt.load_state_dict``."""
    params = _opt_params(opt)
    state = {}
    for i, st in whole["state"].items():
        s = shard_of(params[int(i)])
        state[i] = {k: s.take(v) if s and torch.is_tensor(v)
                    and tuple(v.shape) == s.layout.shape else v
                    for k, v in st.items()}
    return {**whole, "state": state}
