"""Train-mode BatchNorm (+ReLU): the Hopper kernels ``batch_norm.cu`` and the plain version.

flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` in train mode, as
:class:`..models.hourglass.BatchNorm` runs it.  A CUDA tensor goes to
:class:`BatchNormTrain`, an autograd Function over four kernels (two
launches forward: statistics, then normalise and move the running
statistics; two backward: the gradient's sums, then dx); a CPU tensor to
:func:`batch_norm_train_reference`, the torch-op composition that autograd
differentiates.  :func:`batch_norm_train_bwd_reference` writes the kernels'
backward formula in plain torch ops.

Under a data axis of several ranks the statistics are the global batch's:
the forward all-reduces the per-channel ``[sum x, sum x^2]`` between its two
kernels, the backward ``[sum g, sum g xhat]`` between its two; the dweight
and dbias it returns stay this rank's (the gradient buckets sum them).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ...parallel.mesh import DATA_AXIS, all_reduce_sum, all_reduce_sum_, axis_size
from . import build

EPS = 1e-5
MOMENTUM = 0.9      # flax's convention: the weight of the old statistic

# Calls since the last reset (see ops.cuda.reset_launch_counts): each
# forward call launches bn_stats + bn_fwd, each backward bn_dstats + bn_bwd.
fwd_launches = 0
bwd_launches = 0

THREADS = 512           # kThreads of batch_norm.cu
UNROLL = 4              # 16-byte loads in flight a thread (the reduce kernel's)
# (blocks an SM, largest tx) of each kernel's grid, from a sweep on an
# NVIDIA H100 80GB HBM3 at the main path's shapes in channels-last rows:
# the statistics kernel (~50 registers a thread) runs two 512-thread blocks
# an SM, the others (~90-110) one; a grid just past a whole number of waves
# leaves most SMs idle in its last one, so chunks round down.  In NCHW
# planes a tile is a channel, so only the blocks an SM count.
GRIDS = {"stats": (2, 8), "dstats": (1, 8), "map": (1, 16)}
MAX_CHUNKS = 1024
PLANES, ROWS = 0, 1     # NCHW, channels-last
_STATS, _FWD, _DSTATS, _BWD = range(4)
_GRID_OF = {_STATS: "stats", _FWD: "map", _DSTATS: "dstats", _BWD: "map"}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _col(v):
    return v[:, None, None]


def batch_norm_train_reference(x, weight, bias, running_mean, running_var,
                               eps: float = EPS, relu: bool = False,
                               update_running: bool = True):
    """The plain version: statistics in at least fp32 whatever ``x``'s dtype,
    the fast variance ``E[x^2] - E[x]^2`` clamped at 0, ``(x - mean) *
    (weight * rsqrt(var + eps)) + bias`` in that precision, cast back to
    ``x``'s dtype, then ReLU if ``relu``; the running statistics move by
    ``r <- 0.9 r + 0.1 stat`` with the biased variance unless
    ``update_running`` is False.  Autograd differentiates it."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    dims = (0, 2, 3)
    ranks = axis_size(DATA_AXIS)
    if ranks > 1:
        # One differentiable all-reduce of the per-channel [sum x, sum x^2];
        # every data rank holds a batch of the same shape, so the global
        # count is the local one times the ranks.
        n = xf.numel() // xf.shape[1] * ranks
        sums = all_reduce_sum(torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims)]),
                              DATA_AXIS)
        mean, mean2 = (sums / n).chunk(2)
    else:
        mean = xf.mean(dim=dims)
        mean2 = (xf * xf).mean(dim=dims)
    var = (mean2 - mean * mean).clamp_min(0.0)
    if update_running:
        with torch.no_grad():
            m = MOMENTUM
            running_mean.copy_(m * running_mean + (1 - m) * mean.detach())
            running_var.copy_(m * running_var + (1 - m) * var.detach())
    mul = torch.rsqrt(var + eps) * weight
    y = ((xf - _col(mean)) * _col(mul) + _col(bias)).to(x.dtype)
    return F.relu(y) if relu else y


def batch_norm_train_bwd_reference(x, dy, weight, bias, sums, count: int,
                                   eps: float = EPS, relu: bool = False,
                                   grad_sums=None):
    """The kernels' backward in plain torch ops: ``(dx, dweight, dbias)`` of
    the forward that saw the per-channel ``sums = [sum x, sum x^2]`` over
    ``count`` values.  ``g`` is ``dy`` masked by the ReLU recomputed from
    ``x``, ``xhat = (x - mean) rstd``; ``dbias = sum g`` and ``dweight =
    sum g xhat`` over this ``x``; ``dx = weight rstd (g - G1 / count - [d >=
    0] xhat G2 / count)`` with ``d = E[x^2] - E[x]^2`` before its clamp and
    ``[G1, G2] = grad_sums`` (a data group's all-reduced ``[dbias,
    dweight]``), by default this ``x``'s own."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf, g = x.to(acc), dy.to(acc)
    s1, s2 = sums.to(acc).chunk(2)
    mean, mean2 = s1 / count, s2 / count
    d = mean2 - mean * mean
    keep = (d >= 0).to(acc)
    rstd = torch.rsqrt(d.clamp_min(0.0) + eps)
    mul = rstd * weight
    if relu:
        y = ((xf - _col(mean)) * _col(mul) + _col(bias)).to(x.dtype)
        g = torch.where(y > 0, g, torch.zeros((), dtype=acc))
    xhat = (xf - _col(mean)) * _col(rstd)
    dims = (0, 2, 3)
    dbias, dweight = g.sum(dim=dims), (g * xhat).sum(dim=dims)
    g1, g2 = (dbias, dweight) if grad_sums is None else grad_sums.to(acc).chunk(2)
    a, k = g1 / count, keep * g2 / count
    dx = _col(mul) * (g - _col(a) - xhat * _col(k))
    return dx.to(x.dtype), dweight, dbias


# -- the kernels' geometry ----------------------------------------------------

def layout_of(x) -> int | None:
    """PLANES for an NCHW-contiguous tensor, ROWS for a channels-last one,
    None for any other strides."""
    if x.is_contiguous():
        return PLANES
    if x.is_contiguous(memory_format=torch.channels_last):
        return ROWS
    return None


def vector_width(dtype, layout: int, c: int, hw: int, *ptrs) -> int:
    """Values a load: 16 bytes' worth where the run a vector lies in (H*W in
    planes, C in rows) is a multiple of it and every pointer is 16-byte
    aligned; else 1."""
    vec = 16 // dtype.itemsize
    run = hw if layout == PLANES else c
    if run % vec or any(p % 16 for p in ptrs):
        return 1
    return vec


def plan(layout: int, n: int, c: int, hw: int, vec: int, sms: int,
         grid: tuple) -> tuple:
    """``(chunks, tiles, tx)`` of a kernel: a tile is a channel (planes) or
    ``tx`` vectors of channels (rows, ``tx`` a power of two up to
    ``grid[1]``); chunks split each tile's values so that at most ``grid[0] *
    sms`` blocks run (one wave; at least one chunk a tile), no chunk shorter
    than one pass of the block's loads."""
    per_sm, max_tx = grid
    if layout == PLANES:
        tx, tiles = 1, c
        work, per_pass = n * hw // vec, THREADS * UNROLL
    else:
        cv = c // vec
        tx = min(max_tx, 1 << (cv - 1).bit_length())
        tiles = -(-cv // tx)
        work, per_pass = n * hw, THREADS // tx * UNROLL
    chunks = min(int(per_sm * sms) // tiles, -(-work // per_pass), MAX_CHUNKS)
    return max(1, chunks), tiles, tx


_sms: dict = {}
_plans: dict = {}
_counters: dict = {}


def _plan_for(x, layout, vec):
    """Each kernel's ``plan`` (the two elementwise kernels share one)."""
    n, c, h, w = x.shape
    key = (x.device.index, layout, n, c, h * w, vec)
    got = _plans.get(key)
    if got is None:
        idx = x.device.index
        if idx not in _sms:
            _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
        got = _plans[key] = {k: plan(layout, n, c, h * w, vec, _sms[idx], grid)
                             for k, grid in GRIDS.items()}
    return got


def _counters_for(device, stream: int, tiles: int):
    """The zeroed tile counters of ``device``'s ``stream`` (the kernels'
    last blocks reset them), at least ``tiles`` long."""
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < tiles:
        buf = _counters[key] = torch.zeros(max(tiles, 4096), dtype=torch.int32,
                                           device=device)
    return buf


class _Launch(ctypes.Structure):
    """``struct Launch`` of batch_norm.cu, field for field: one structure a
    launch costs the host less than 29 ctypes arguments."""

    _fields_ = ([(k, ctypes.c_void_p) for k in (
        "x", "dy", "out", "tot", "dtot", "w", "b", "rmean", "rvar", "part",
        "counters", "tot_out", "dw", "db")]
        + [(k, ctypes.c_int) for k in (
            "kind", "dtype", "layout", "vec", "tx", "n", "c", "hw", "chunks", "relu")]
        + [(k, ctypes.c_float) for k in ("count", "eps", "keep_old", "keep_new")])


def _lib():
    lib = build.load("batch_norm")
    if not getattr(lib, "_typed", False):
        lib.bn_train.argtypes = [ctypes.POINTER(_Launch), ctypes.c_void_p]
        lib.bn_train.restype = ctypes.c_int
        lib.bn_train_error_string.argtypes = [ctypes.c_int]
        lib.bn_train_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(kind, g, x, dy=None, out=None, tot=None, dtot=None, w=None, b=None,
            rmean=None, rvar=None, part=None, counters=None, tot_out=None,
            dw=None, db=None):
    """One kernel of the four over the call's geometry ``g``."""
    lib = _lib()
    chunks, _, tx = g["plans"][_GRID_OF[kind]]
    launch = _Launch(
        _ptr(x), _ptr(dy), _ptr(out), _ptr(tot), _ptr(dtot), _ptr(w), _ptr(b),
        _ptr(rmean), _ptr(rvar), _ptr(part), _ptr(counters), _ptr(tot_out),
        _ptr(dw), _ptr(db), kind, g["dtype"], g["layout"], g["vec"], tx, g["n"],
        g["c"], g["hw"], chunks, g["relu"], g["count"], g["eps"], MOMENTUM,
        1.0 - MOMENTUM)
    err = lib.bn_train(ctypes.byref(launch), g["stream"])
    if err:
        raise RuntimeError("batch_norm launch failed: "
                           + lib.bn_train_error_string(err).decode())


def _reduce(kind, g, x, **kw):
    """A reduce kernel (stats or dstats): its ``[2, C]`` sums, fp32."""
    c = g["c"]
    chunks, tiles, _ = g["plans"][_GRID_OF[kind]]
    tot = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    part = counters = None
    if chunks > 1:
        part = torch.empty(chunks * 2 * c, dtype=torch.float32, device=x.device)
        counters = _counters_for(x.device, g["stream"], tiles)
    _launch(kind, g, x, part=part, counters=counters, tot_out=tot, **kw)
    return tot


def _geometry(x, dy, eps, relu):
    """Everything a launch needs besides pointers, for NCHW-shaped ``x`` in
    its own layout (``dy`` read in the same layout)."""
    n, c, h, w = x.shape
    layout = layout_of(x)
    vec = vector_width(x.dtype, layout, c, h * w, x.data_ptr(),
                       *(() if dy is None else (dy.data_ptr(),)))
    return {"dtype": _DTYPES[x.dtype], "layout": layout, "vec": vec,
            "plans": _plan_for(x, layout, vec), "n": n, "c": c, "hw": h * w,
            "count": float(n * h * w * axis_size(DATA_AXIS)), "eps": float(eps),
            "relu": int(relu), "stream": _stream(x)}


def _stream(x) -> int:
    """The raw handle of the current stream of ``x``'s card (torch's own
    ``get_raw_stream``; ``torch.cuda.current_stream`` costs the host ~25 µs
    more a call)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def _check(x, params):
    if x.dim() != 4:
        raise ValueError(f"batch_norm_train takes (N, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"the BN kernels take fp32, bf16 or fp16, not {x.dtype}")
    n, c, h, w = x.shape
    if n * h * w == 0 or n * h * w * c >= 2 ** 31:
        raise ValueError(f"the BN kernels take 1 to 2**31 - 1 values, got {tuple(x.shape)}")
    device = x.get_device()
    for p in params:
        if (p.dtype != torch.float32 or p.dim() != 1 or p.shape[0] != c
                or p.get_device() != device or not p.is_contiguous()):
            raise ValueError("weight, bias and running statistics must be contiguous "
                             f"fp32 ({c},) on {x.device}")


def _in_layout(t, like):
    """``t`` in ``like``'s layout (a copy only where it is not)."""
    return t.contiguous(memory_format=torch.contiguous_format
                        if layout_of(like) == PLANES else torch.channels_last)


class BatchNormTrain(torch.autograd.Function):
    """Train-mode BN (+ReLU) over the four kernels.  Saves ``x`` (its own
    dtype) and the per-channel sums; the backward recomputes the rest."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps, relu,
                update_running):
        global fwd_launches
        if layout_of(x) is None:
            x = x.contiguous()
        g = _geometry(x, None, eps, relu)
        sums = _reduce(_STATS, g, x)
        all_reduce_sum_(sums, DATA_AXIS)
        y = torch.empty_like(x)
        _launch(_FWD, g, x, out=y, tot=sums, w=weight, b=bias,
                rmean=running_mean if update_running else None,
                rvar=running_var if update_running else None)
        fwd_launches += 1
        ctx.save_for_backward(x, weight, bias, sums)
        ctx.geometry = g
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        global bwd_launches
        x, weight, bias, sums = ctx.saved_tensors
        dy = _in_layout(dy, x)
        g = ctx.geometry     # autograd runs the backward on the forward's stream
        if g["vec"] > 1 and dy.data_ptr() % 16:
            g = _geometry(x, dy, g["eps"], g["relu"])
        dw, db = torch.empty_like(weight), torch.empty_like(bias)
        dsums = _reduce(_DSTATS, g, x, dy=dy, tot=sums, w=weight, b=bias,
                        dw=dw, db=db)
        all_reduce_sum_(dsums, DATA_AXIS)
        dx = torch.empty_like(x)
        _launch(_BWD, g, x, dy=dy, out=dx, tot=sums, dtot=dsums, w=weight, b=bias)
        bwd_launches += 1
        return dx, dw, db, None, None, None, None, None


def batch_norm_train(x, weight, bias, running_mean, running_var,
                     eps: float = EPS, relu: bool = False,
                     update_running: bool = True):
    """Train-mode BN (+ReLU if ``relu``) of NCHW-shaped ``x``: the kernels
    for a CUDA tensor (fp32, bf16 or fp16 in; fp32 parameters and running
    statistics), :func:`batch_norm_train_reference` for any other (the CPU,
    the meta device).  The running statistics move in place unless
    ``update_running`` is False."""
    if x.device.type != "cuda":
        return batch_norm_train_reference(x, weight, bias, running_mean, running_var,
                                          eps, relu, update_running)
    _check(x, (weight, bias, running_mean, running_var))
    return BatchNormTrain.apply(x, weight, bias, running_mean, running_var,
                                eps, relu, update_running)
