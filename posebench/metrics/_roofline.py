"""Bytes and operations a ported kernel's call must move and compute, from
the call's shape, and a share of the roofline from them.

Each input is read once and each output written once, whatever the kernel
reads again.  The head works on fp32 maps: per row the raw map in, two
coordinates out, and with a Gaussian regularizer (js, kl, mse) two target
coordinates in and one value out (var: one value out); its backward reads
the raw map, the coordinates' cotangent (and the targets and the
regularizer's cotangent) and writes the map's gradient.  The operations per
map element are the head's arithmetic with a transcendental counted as one
(softmax 7 for the forward, 12 for the backward, which recomputes it).  A
row shift reads the window of taps each output needs (``out + stride``
values a row), a start and a fraction a row, and writes ``out`` values; 3
operations an output value.
"""

from __future__ import annotations

from .. import inputs
from ..reference import model as M
from ..reference import preprocess as P

HEAD_FWD_OPS = {"none": 7, "var": 12, "mse": 15, "kl": 20, "js": 25}
HEAD_BWD_OPS = {"none": 12, "var": 20, "mse": 22, "kl": 28, "js": 36}
_GAUSS = ("js", "kl", "mse")


def head_fwd(rows: int, hw: int, reg: str) -> tuple[float, float]:
    nbytes = 4 * rows * hw + 8 * rows
    if reg in _GAUSS:
        nbytes += 8 * rows + 4 * rows
    elif reg == "var":
        nbytes += 4 * rows
    return float(nbytes), float(HEAD_FWD_OPS[reg] * rows * hw)


def head_bwd(rows: int, hw: int, reg: str) -> tuple[float, float]:
    nbytes = 8 * rows * hw + 8 * rows
    if reg in _GAUSS:
        nbytes += 8 * rows + 4 * rows
    elif reg == "var":
        nbytes += 4 * rows
    return float(nbytes), float(HEAD_BWD_OPS[reg] * rows * hw)


def row_shift(rows: int, out_len: int, stride: int) -> tuple[float, float]:
    nbytes = 4 * rows * (out_len + stride) + 8 * rows + 4 * rows * out_len
    return float(nbytes), float(3 * rows * out_len)


def step_calls(cfg: dict, batch: int, train: bool) -> dict:
    """The shapes of one step's calls of the ported kernels, from the
    configuration: the head's forward (and in training its backward) over
    every stack's maps (serving decodes the last stack only), and the
    shear warp's two row-shift passes over channel-interleaved rows."""
    mcfg, backbone = cfg["model"], M.backbone_of(cfg)
    size, hm = M.input_size(mcfg), backbone.heatmap_side(mcfg)
    canvas = inputs.canvas_side(cfg)
    stacks = backbone.stacks(mcfg)
    e = P.shear_extents(canvas, size, P.max_shear(cfg["data"], train))
    joints = mcfg["num_joints"]
    head = {"rows": (stacks if train else 1) * batch * joints, "hw": hm * hm,
            "reg": mcfg["reg"] if train else "none"}
    calls = {"dsnt_head_fwd": [head],
             "row_shift": [{"rows": batch * canvas, "out_len": e["w1"] * 3, "stride": 3},
                           {"rows": batch * size, "out_len": size * 3, "stride": 3}]}
    if train:
        calls["dsnt_head_bwd"] = [head]
    return calls


COST = {"dsnt_head_fwd": head_fwd, "dsnt_head_bwd": head_bwd, "row_shift": row_shift}


def least_seconds(kernel: str, call: dict, peaks: dict) -> float:
    """The larger of the bytes over the memory's rate and the operations
    over the fp32 rate (these kernels compute on the CUDA cores)."""
    nbytes, ops = COST[kernel](**call)
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["fp32_flops_per_s"])


def share_pct(ctx, kernel: str):
    """100 x the least time of the traced calls of ``kernel`` over the
    device time of its launches there; None where none ran or the trace did
    not see each launch."""
    calls = ctx.calls.get(kernel, [])
    times = ctx.trace.kernel_seconds(kernel)
    if not calls or len(times) != len(calls):
        return None
    return 100.0 * sum(least_seconds(kernel, c, ctx.peaks) for c in calls) / sum(times)
