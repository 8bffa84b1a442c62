#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100, ``sm_90a``).

Builds the port's CUDA kernels from the sources in this checkout (and
reports each kernel's registers, spills and SASS instruction count), times
the calibration kernels first (their copy rate is the ceiling every other
kernel's rate is stated against), holds each kernel against its plain
PyTorch version on the card, drives the serving and eval
steps and then the train step of the flagship config
(``configs/hg8_dsnt_js_train.json``: 8-stack hourglass, 256 features, 256-px
input, bf16 backbone with fp32 params, fused DSNT head with the JS
regularizer, shear warp with rotation, RMSProp) at batch 32 on 384-px
synthetic canvases, and times the kernels and the steps.  Then it drives
the port's bench entry points at small counts (``bench.kernel``'s rooflines
with the calibration kernels, and ``bench.step``'s device step and
streaming and resident epochs at batch 32), and last the port's Trainer on
the same config: two epochs of resident k=4 training with the resident eval
scan, checkpoints and metric records, a resume from its mid-epoch
checkpoint held bitwise against the uninterrupted run, and the streaming
eval pass held against the resident one.  Then the CLIs on the same model
(``cli`` phase): ``cli.train`` for one epoch, ``cli.evaluate`` without and
with flip and 3 eval scales (its eval step held against the plain path),
``cli.infer`` into a ``.mat``, and the Trainer's auto-pack over a
decode-backed stand-in.  Last the paper's ablation models: ``resnet``
(``configs/resnet50_dsnt_2x.json``: ResNet-50 dilated twice at a 448-px
input, 56x56 heatmaps, batch 32 on 672-px canvases; the serve and train
steps counted, held against their plain paths and timed, and the head and
row_shift held and timed at those shapes) and ``heads``
(``configs/ablation_heads.json``: hg4 with the dsnt+JS, gauss and fc
heads, train steps and a flip x 3-scale eval step each, and fc through
``cli.train`` -> ``cli.evaluate``).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Every phase prints one JSON line; any failure raises and exits non-zero.
The line before the last is the card's name and power limit as
``nvidia-smi`` prints them, and the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside this script, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "hg8_dsnt_js_train.json"
BATCH = 32
CANVAS = 384
STEPS = 3                  # eval, infer and train steps in the counted runs
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
FP32_OPS_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
HEAD_TOL = {"coords_atol": 2e-6, "reg_rtol": 1e-5, "reg_atol": 1e-5}
# The eval step against the same step with both plain versions forced: the
# warped images are bitwise equal, the head's coords agree to 2e-6
# (normalized), i.e. ~4e-4 original px at 256/384 px; the loss sums 4096 js
# terms each within 1e-5.
STEP_TOL = {"loss_rtol": 1e-5, "pred_orig_atol_px": 1e-2}
# The shear warp against the gather warp, normalized image values (~[-2, 3]):
# two fp32 paths to the same bilinear sample, rounded differently (one 8-bit
# gray level is 1.7e-2 here).
WARP_ATOL = 1e-4
HEATMAP_STD = 3.0          # logit std the score convs are scaled to
HEAD_FLOPS_PER_ELEMENT = {"none": 7, "var": 12, "mse": 15, "kl": 20, "js": 25}
# The backward recomputes the forward's softmax and Gaussian, then u, <z, u>
# and dh; a transcendental counts as one operation.
HEAD_BWD_FLOPS_PER_ELEMENT = {"none": 12, "var": 20, "mse": 22, "kl": 28,
                              "js": 36}
# The head's backward against its plain version, and the plain backward
# against torch.autograd of the plain forward: dh = z (u - <z, u>) keeps a
# few fp32 ulps of |u|, and |u| reaches ~1e2 where KL's log(g + eps) meets a
# pixel far from the target (|dh| up to ~19 at random cotangents), so atol
# is 5e-6 of the case's largest |dh|, at least 2e-6; rtol 1e-4.
HEAD_BWD_TOL = {"atol": 2e-6, "atol_of_max": 5e-6, "rtol": 1e-4}
# The first train step against the same step with both plain versions forced
# (head forward and backward, row_shift), from the same weights and draws:
# the images and heatmaps are bitwise equal (row_shift is, the forward convs
# are deterministic), so the loss moves only by the head's forward (4096
# rows, each within 1e-5) and dL/dheatmaps only by its backward (within
# 1e-4 of its largest value).  The grad norm passes through cuDNN's bf16
# backward, whose weight-gradient reductions use atomics in no fixed order:
# two runs of the same step differ there, so it is held at 1e-2.
TRAIN_TOL = {"loss_rtol": 1e-5, "dheat_rel_to_max": 1e-4, "grad_norm_rtol": 1e-2}
# The calibration kernels against their plain versions: copy is one fp32 add
# (bitwise); exp is full-precision expf against torch.exp (a few ulp at
# most); the softmax sums 4096 terms in another order than torch.softmax.
CALIB_TOL = {"copy": None, "exp": {"rtol": 1e-6, "atol": 0.0},
             "smax": {"rtol": 2e-6, "atol": 1e-9}}
CALIB_SHAPES = ((8192, 4096), (130, 4096), (37, 1028))
# The bench phase: bench.step at the smoke's batch and small counts.
BENCH_KW = {"iters": 5, "repeats": 3}
E2E_KW = {"repeats": 2, "epoch_steps": 8}
# The trainer phase: 256 train rows are 8 steps (2 dispatch groups of 4) an
# epoch; 80 val rows are 3 eval steps, the last with 16 pad rows.
TRAINER_ROWS = {"train": 256, "val": 80}
TRAINER_EPOCHS = 2
TRAINER_CKPT_EVERY_STEPS = 4
# The streaming eval pass against the resident scan on the same weights:
# the same rows in the same batches (pads repeat the last row, masked), so
# the counts are equal; the loss is the mean of 3 per-batch losses, in fp64
# on the streaming side and fp32 on the scan's.
TRAINER_EVAL_LOSS_RTOL = 1e-5
# The resnet phase: BASELINE config #5 as its file gives it (ResNet-50,
# dilate 2, 448-px input: 56x56 heatmaps), on 672-px canvases (1.5x the
# input, the canvas rule of utils/config.py).
RESNET_CONFIG = ROOT / "configs" / "resnet50_dsnt_2x.json"
RESNET_CANVAS = 672
# The heads phase: BASELINE config #4 (hg4, 256 features, 256 px, bf16) with
# each head of tools/_ablation_common.py's HEAD_FLAGS, a few train steps
# and an eval step with flip and 3 scales at batch 32; then fc through the
# CLIs (2 train steps in one resident dispatch, one eval step).
HEADS_CONFIG = ROOT / "configs" / "ablation_heads.json"
HEAD_VARIANTS = {"dsnt": {"output_strat": "dsnt", "reg": "js", "reg_coeff": 1.0},
                 "gauss": {"output_strat": "gauss"},
                 "fc": {"output_strat": "fc"}}
# The train step's metric keys, as the JAX package's train step emits them.
HEAD_METRICS = {"dsnt": {"loss", "grad_norm", "euclidean", "reg"},
                "gauss": {"loss", "grad_norm", "mse"},
                "fc": {"loss", "grad_norm", "euclidean"}}
HEADS_STEPS = 3
HEADS_SCALES = (0.9, 1.0, 1.1)
HEADS_CLI_ROWS = 64


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def on_device(event) -> bool:
    """A device activity of a profile, not a range that a user annotation
    (``Optimizer.step#RMSprop.step``) draws over the device's timeline."""
    return (event.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


PROFILE_ATTEMPTS = 4
# torch.profiler (torch 2.11, NVIDIA H100 80GB HBM3) has returned a profile
# with no device activity at all, and, once the train step had been
# profiled, later profiles in the same process lacked device activities: a
# few per profile at first, and on one machine nearly all of them (2 of the
# 10 expected, then 0 of 20).  The cause is not known.  Kernel times
# (``bench.timing.device_ms``) are therefore taken with CUDA events and no
# profiler; the profiler only breaks a step down (``profile_step``).  A
# step's profile is
# used only when every ported kernel appears in it as many times as the
# launch counters say the step launched it; device activities that start
# before the profile's first host event (a previous profile's) are not
# counted.  An incomplete profile is taken again, up to PROFILE_ATTEMPTS
# times, and then the run fails.


def _device_events(prof) -> list:
    """The profile's device activities that start after its first host
    event."""
    events = prof.events()
    first = min((e.time_range.start for e in events if not on_device(e)),
                default=-math.inf)
    return [e for e in events if on_device(e) and e.time_range.start >= first]


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; "
                 "this script needs an NVIDIA card")
    sys.path.insert(0, str(ROOT))
    import dsnt_pose2d_tpu_torch as pkg

    if ROOT not in Path(pkg.__file__).resolve().parents:
        sys.exit(f"chip_smoke: imported the port from {pkg.__file__}, "
                 f"not from this checkout ({ROOT})")
    from dsnt_pose2d_tpu_torch.ops.cuda import build

    card = nvidia_smi("name,power.limit")
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    emit("device", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         torch_cuda=torch.version.cuda, nvcc=nvcc.strip().splitlines()[-1],
         capability=list(torch.cuda.get_device_capability(0)))
    return card


def _short_name(mangled: str, demangled: str) -> str:
    name = demangled.replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ")
    return name.split("(", 1)[0] if name != mangled else name


def _demangle(names: list) -> dict:
    """Mangled -> readable kernel names (``c++filt``), or the names as they
    are where it is missing."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), text=True,
                             capture_output=True, check=True, timeout=60).stdout
        return {m: _short_name(m, d) for m, d in zip(names, out.splitlines())}
    except (OSError, subprocess.SubprocessError):
        return {m: m for m in names}


def ptxas_report(name: str) -> dict:
    """Registers, shared memory, stack and spills of each kernel of a source,
    from the ``-Xptxas=-v`` lines of its build log."""
    from dsnt_pose2d_tpu_torch.ops.cuda import build

    kernels, cur = {}, None
    for line in build.log_path(name).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = kernels.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m.group(1)) if m else 0
    names = _demangle(list(kernels))
    return {names[k]: v for k, v in kernels.items()}


def sass_counts(name: str) -> dict | None:
    """Instructions (NOPs left out) of each kernel in a built library, from
    ``cuobjdump -sass``; None where the toolkit has no cuobjdump.  The
    head's forward is fully unrolled, so for it this is also the count a
    thread executes, bar the Gaussian's factor loop and the thresholded
    fallback."""
    from dsnt_pose2d_tpu_torch.ops.cuda import build

    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(build.lib_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?!NOP\b)\S", line):
            counts[cur] += 1
    names = _demangle(list(counts))
    return {names[k]: v for k, v in counts.items()}


def phase_build():
    from dsnt_pose2d_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    took = build.build_all()
    for name in build.SOURCES:
        build.load(name)
    emit("build", sources=list(build.SOURCES), compile_s=took,
         total_s=time.perf_counter() - t0, flags=list(build.NVCC_FLAGS))
    emit("build_ptxas", per_source={n: ptxas_report(n) for n in build.SOURCES})
    emit("build_sass", instructions={n: sass_counts(n) for n in build.SOURCES})


def head_inputs(n, h, w, seed, dev):
    g = torch.Generator().manual_seed(seed)
    raw = torch.randn((n, h, w), generator=g) * 3.0
    raw[0::7] *= 40.0          # peaked rows: probabilities underflow to 0
    raw[3::11] -= 100.0        # every logit below the threshold: fallback
    t = torch.rand((n, 2), generator=g) * 1.6 - 0.8
    return raw.to(dev), t.to(dev)


def compare_head(raw, t, reg, preact, threshold=0.5):
    from dsnt_pose2d_tpu_torch.ops.cuda import (fused_dsnt_head,
                                                fused_dsnt_head_reference)

    kw = dict(sigma_px=1.0, reg=reg, preact=preact, threshold=threshold)
    got_c, got_r = fused_dsnt_head(raw, t, **kw)
    exp_c, exp_r = fused_dsnt_head_reference(raw, t, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_c, exp_c, atol=HEAD_TOL["coords_atol"], rtol=0)
    err_c = (got_c - exp_c).abs().max().item()
    err_r = 0.0
    if exp_r is not None:
        torch.testing.assert_close(got_r, exp_r, rtol=HEAD_TOL["reg_rtol"],
                                   atol=HEAD_TOL["reg_atol"])
        err_r = (got_r - exp_r).abs().max().item()
    return err_c, err_r


def phase_head_vs_plain(dev):
    from dsnt_pose2d_tpu_torch.ops.cuda import PREACT_KINDS, REG_KINDS

    results = []
    for (n, h, w) in ((4096, 64, 64), (512, 7, 9)):
        raw, t = head_inputs(n, h, w, seed=h * w, dev=dev)
        for reg in REG_KINDS:
            for preact in PREACT_KINDS:
                err_c, err_r = compare_head(raw, t, reg, preact)
                results.append({"shape": [n, h * w], "reg": reg,
                                "preact": preact, "coords_err": err_c,
                                "reg_err": err_r})
    emit("dsnt_head_fwd_vs_plain", cases=len(results), tolerance=HEAD_TOL,
         max_coords_err=max(r["coords_err"] for r in results),
         max_reg_err=max(r["reg_err"] for r in results))


def assert_dh_close(got, exp):
    atol = max(HEAD_BWD_TOL["atol"],
               HEAD_BWD_TOL["atol_of_max"] * exp.abs().max().item())
    torch.testing.assert_close(got, exp, atol=atol, rtol=HEAD_BWD_TOL["rtol"])


def compare_head_bwd(raw, t, gc, gr, reg, preact, threshold=0.5):
    """dL/draw through the fused head's autograd Function (both kernels)
    against the plain backward, and the plain backward against
    ``torch.autograd`` of the plain forward; returns both max errors."""
    from dsnt_pose2d_tpu_torch.ops.cuda import (fused_dsnt_head,
                                                fused_dsnt_head_bwd_reference,
                                                fused_dsnt_head_reference)

    kw = dict(sigma_px=1.0, reg=reg, preact=preact, threshold=threshold)

    def grad_through(fn):
        x = raw.clone().requires_grad_(True)
        coords, regv = fn(x, t, **kw)
        if regv is None:
            coords.backward(gc)
        else:
            torch.autograd.backward([coords, regv], [gc, gr])
        return x.grad

    got = grad_through(fused_dsnt_head)
    plain = fused_dsnt_head_bwd_reference(raw, t, gc, None if reg == "none" else gr,
                                          **kw)
    auto = grad_through(fused_dsnt_head_reference)
    torch.cuda.synchronize()
    assert_dh_close(got, plain)
    assert_dh_close(plain, auto)
    return (got - plain).abs().max().item(), (plain - auto).abs().max().item()


def phase_head_bwd_vs_plain(dev):
    from dsnt_pose2d_tpu_torch.ops.cuda import PREACT_KINDS, REG_KINDS

    errs = []
    for (n, h, w) in ((4096, 64, 64), (512, 7, 9)):
        raw, t = head_inputs(n, h, w, seed=h * w + 1, dev=dev)
        g = torch.Generator().manual_seed(n)
        gc = torch.randn((n, 2), generator=g).to(dev)
        gr = torch.randn((n,), generator=g).to(dev)
        for reg in REG_KINDS:
            for preact in PREACT_KINDS:
                errs.append(compare_head_bwd(raw, t, gc, gr, reg, preact))
    emit("head_bwd_vs_plain", cases=len(errs), shapes=[[4096, 4096], [512, 63]],
         tolerance=HEAD_BWD_TOL,
         max_kernel_vs_plain_err=max(e[0] for e in errs),
         max_plain_vs_autograd_err=max(e[1] for e in errs))
    return max(e[0] for e in errs)


def random_row_shift_inputs(call, seed):
    """Random rows, window starts and fracs at the shape of a recorded call."""
    rows, starts, _, out, stride = call
    r, length = rows.shape
    g = torch.Generator().manual_seed(seed)
    px = torch.randint(0, (length - out - stride) // stride + 1, (r,),
                       generator=g)
    return (torch.rand((r, length), generator=g).to(rows.device),
            (px * stride).to(torch.int32).to(rows.device),
            torch.rand((r,), generator=g).to(rows.device), out, stride)


def assert_row_shift_bitwise(path, calls):
    """Each recorded ``(rows, starts, fracs, out, stride)`` call of row_shift
    against its plain version, bitwise: on the inputs the path gave it and
    on random rows, starts and fracs of the same shape.  Returns the shapes
    ``[rows, row length, out]``."""
    from dsnt_pose2d_tpu_torch.ops.cuda import shift_rows, shift_rows_reference

    shapes = []
    for i, call in enumerate(calls):
        shape = [*call[0].shape, call[3]]
        for inputs in (call, random_row_shift_inputs(call, seed=i)):
            rows, starts, fracs, out, stride = inputs
            got = shift_rows(rows, starts, fracs, out, stride=stride)
            exp = shift_rows_reference(rows, starts, fracs, out, stride=stride)
            torch.cuda.synchronize()
            if not torch.equal(got, exp):
                raise AssertionError(
                    f"row_shift {path} {shape} differs from its plain "
                    f"version: max {(got - exp).abs().max().item()}")
        shapes.append(shape)
    return shapes


def phase_row_shift_vs_plain(recorded):
    """row_shift against its plain version, bitwise, at every shape that the
    main path's counted runs gave it: on the inputs the path gave it, and on
    random rows, starts and fracs of the same shape (the eval crop has no
    shear, so its fracs are 0; random ones exercise the lerp)."""
    checked = {path: assert_row_shift_bitwise(path, list(calls.values()))
               for path, calls in recorded.items()}
    legacy = row_shift_legacy_vs_plain(recorded)
    emit("row_shift_vs_plain", bitwise_equal=True, shapes=checked,
         inputs=["main path", "random"], max_abs_err=0.0, legacy=legacy)
    return 0.0, legacy


def row_shift_legacy_vs_plain(recorded):
    """One call with ``impl="legacy"`` (the JAX package's ``_kernel_legacy``,
    which the paths do not use) on the first train call's inputs, held
    bitwise against its plain version; its launches are counted apart."""
    from dsnt_pose2d_tpu_torch.ops.cuda import (row_shift, shift_rows,
                                                shift_rows_reference)

    shape, (rows, starts, fracs, out, stride) = next(iter(recorded["train"].items()))
    before = row_shift.launches
    got = shift_rows(rows, starts, fracs, out, stride=stride, impl="legacy")
    launches = row_shift.launches - before
    exp = shift_rows_reference(rows, starts, fracs, out, stride=stride,
                               impl="legacy")
    torch.cuda.synchronize()
    if launches != 1 or not torch.equal(got, exp):
        raise AssertionError(
            f"row_shift impl='legacy' {shape}: {launches} launches, max diff "
            f"{(got - exp).abs().max().item()} from its plain version")
    return {"shape": list(shape), "launches": launches, "max_abs_err": 0.0}


@contextlib.contextmanager
def recording_row_shift(calls):
    """The shear warp's row_shift calls pass on to the kernel and are kept
    as ``(rows, starts, fracs, out, stride)``: in a dict, the first call of
    each ``(rows, row length, out length)``; in a list, every call."""
    from dsnt_pose2d_tpu_torch.data import augment

    kernel = augment.shift_rows

    def record(rows, starts, fracs, out, stride=1):
        key = (*rows.shape, out)
        if isinstance(calls, list) or key not in calls:
            with torch.inference_mode(False):   # plain tensors, not inference ones
                call = (rows.clone(), starts.clone(), fracs.clone(), out, stride)
            if isinstance(calls, list):
                calls.append(call)
            else:
                calls[key] = call
        return kernel(rows, starts, fracs, out, stride)

    augment.shift_rows = record
    try:
        yield calls
    finally:
        augment.shift_rows = kernel


@contextlib.contextmanager
def plain_row_shift():
    """The shear warp with row_shift's plain version in place of its kernel."""
    from dsnt_pose2d_tpu_torch.data import augment
    from dsnt_pose2d_tpu_torch.ops.cuda import shift_rows_reference

    kernel = augment.shift_rows
    augment.shift_rows = shift_rows_reference
    try:
        yield
    finally:
        augment.shift_rows = kernel


@contextlib.contextmanager
def plain_head():
    """The fused head's autograd Function with the plain forward and plain
    backward in place of its two kernels."""
    from dsnt_pose2d_tpu_torch.ops.cuda import dsnt_head

    def plain_bwd(raw2, t2, g_coords, g_reg, h, w, *args):
        return dsnt_head.fused_dsnt_head_bwd_reference(
            raw2.view(-1, h, w), t2, g_coords, g_reg, *args).reshape(-1, h * w)

    kernels = dsnt_head._launch_fwd, dsnt_head._launch_bwd
    dsnt_head._launch_fwd, dsnt_head._launch_bwd = dsnt_head._plain_fwd, plain_bwd
    try:
        yield
    finally:
        dsnt_head._launch_fwd, dsnt_head._launch_bwd = kernels


def synthetic_batch(dev, canvas=CANVAS):
    from dsnt_pose2d_tpu_torch.data.synthetic import make_synthetic_mpii

    data = make_synthetic_mpii(BATCH, canvas, seed=0)
    return {k: torch.from_numpy(v).to(dev) for k, v in data.items()}


def build_flagship(dev, **model_overrides):
    import dataclasses

    from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
    from dsnt_pose2d_tpu_torch.utils.config import config_from_json

    cfg = config_from_json(CONFIG.read_text())
    if model_overrides:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, **model_overrides))
    m = cfg.model
    assert (m.base, m.hg_features, m.resolved_input_size, m.dtype, m.reg) == (
        "hg8", 256, 256, "bfloat16", "js"), m
    assert m.use_pallas and cfg.data.warp_method == "shear"
    return cfg, build_pose_model(cfg.model, device=dev, seed=0)


def score_convs(net) -> list:
    """The score convs of a ``PoseNet``'s backbone, stack by stack: one per
    hourglass stack, the ResNet's single ``score``."""
    bb = net.backbone
    if hasattr(bb, "num_stacks"):
        return [getattr(bb, f"score{i}") for i in range(bb.num_stacks)]
    return [bb.score]


def temper_scores(net, images, target_std=HEATMAP_STD, train=False):
    """Scales each stack's score conv so its heatmap logits have std
    ``target_std`` on these images, in eval or train mode, stack by stack (a
    stack's scores feed the next stack through ``score_back``).  The BN
    running statistics are left as they were.

    The random-init hg8's residual sums grow from stack to stack, to logits
    of std ~1e5-1e6 at the last one in eval mode, where every softmax row is
    one-hot; train-mode BN renormalises them, to a nearly uniform softmax.
    Tempered, the main path drives the head on real softmax rows."""
    buffers = {k: v.clone() for k, v in net.named_buffers()}
    net.train(train)
    with torch.no_grad():
        for i, conv in enumerate(score_convs(net)):
            scale = target_std / net(images).heatmaps[i].std().item()
            conv.weight.mul_(scale)
            conv.bias.mul_(scale)
        for k, v in net.named_buffers():
            v.copy_(buffers[k])


def phase_serve(dev):
    """The main path, counted; then the same steps on the plain path."""
    import dataclasses

    from dsnt_pose2d_tpu_torch.ops import cuda as kernels
    from dsnt_pose2d_tpu_torch.train.loop import make_eval_fn, make_infer_fn

    cfg, model = build_flagship(dev)
    batch = synthetic_batch(dev)
    from dsnt_pose2d_tpu_torch.data.augment import preprocess_batch

    pre_args = (batch["canvases"], batch["coords_px"], batch["mask"],
                batch["head_length"], batch["canvas_from_orig"])
    with torch.inference_mode():
        pre = preprocess_batch(*pre_args, cfg.data, model.input_size,
                               canvas_margin=batch["canvas_margin"])
    temper_scores(model.net, pre["images"], train=False)
    eval_step = make_eval_fn(model, cfg, device=dev)
    infer_step = make_infer_fn(model, cfg, device=dev)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    with recording_row_shift({}) as row_shift_calls:
        outs = [eval_step(batch) for _ in range(STEPS)]
        served = [infer_step(batch) for _ in range(STEPS)]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    expected = {**dict.fromkeys(launches, 0), "dsnt_head_fwd": 3 * STEPS,
                "row_shift": 4 * STEPS}
    if launches != expected:
        raise AssertionError(f"main-path launches {launches}, expected {expected}")

    out = outs[0]
    for o in outs[1:]:
        assert torch.equal(o["pred_orig"], out["pred_orig"]), "eval not repeatable"
    pred = out["pred_orig"]
    assert pred.shape == (BATCH, 16, 2) and torch.isfinite(pred).all()
    assert torch.isfinite(out["loss"]) and out["loss"].item() > 0
    for s in served:
        assert torch.equal(s, pred), "infer step disagrees with eval step"
    total = out["pckh_total"].sum().item()
    assert total == batch["mask"].sum().item()

    # The same step with both plain versions forced, on the card: the plain
    # op head (use_pallas=False) and row_shift's plain version in the shear
    # warp.  With the score convs tempered the heatmaps are real softmax
    # rows (heatmap_logit_std and last_stack_mean_max_prob below), not
    # one-hot ones.
    # The eval crop has no shear, so row_shift runs here with frac 0; its
    # lerp is held at random fracs in phase_row_shift_vs_plain.
    from dsnt_pose2d_tpu_torch.models.factory import PoseModel

    plain_cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, use_pallas=False))
    plain_eval_step = make_eval_fn(
        PoseModel(net=model.net, cfg=plain_cfg.model, device=dev), plain_cfg,
        device=dev)

    def plain_eval(b):
        with plain_row_shift():
            return plain_eval_step(b)

    kernels.reset_launch_counts()
    ref = plain_eval(batch)
    torch.cuda.synchronize()
    assert not any(kernels.launch_counts().values()), kernels.launch_counts()
    loss_rel = abs(out["loss"].item() - ref["loss"].item()) / abs(ref["loss"].item())
    pred_err = (pred - ref["pred_orig"]).abs().max().item()
    if (loss_rel > STEP_TOL["loss_rtol"]
            or pred_err > STEP_TOL["pred_orig_atol_px"]
            or not torch.equal(out["pckh_correct"], ref["pckh_correct"])):
        raise AssertionError(f"kernel path vs plain path: loss rel {loss_rel}, "
                             f"pred_orig max err {pred_err} px")

    # The coordinate chain on the card: ground truth -> crop -> original px
    # must give back the canvas coords (canvas_from_orig is the identity).
    from dsnt_pose2d_tpu_torch.train.loop import _to_original_px

    with torch.inference_mode():
        size = model.input_size
        gather_data = dataclasses.replace(cfg.data, warp_method="gather")
        pre_gather = preprocess_batch(*pre_args, gather_data, size,
                                      canvas_margin=batch["canvas_margin"])
        gt_back = _to_original_px(pre["coords"], pre["crop_from_orig"], size)
        heatmaps = model.forward(pre["images"]).heatmaps
        max_prob = torch.softmax(heatmaps[-1].flatten(2), -1).amax(-1).mean()
    warp_err = (pre["images"] - pre_gather["images"]).abs().max().item()
    assert warp_err <= WARP_ATOL, f"shear warp vs gather warp: {warp_err}"
    gt_err = (gt_back - batch["coords_px"]).abs().max().item()
    assert gt_err < 1e-3, gt_err

    emit("serve_step", config=str(CONFIG.relative_to(ROOT)), batch=BATCH,
         canvas=CANVAS, steps=STEPS, launches=launches,
         loss=out["loss"].item(), pred_orig_shape=list(pred.shape),
         pckh_correct=out["pckh_correct"].sum().item(), pckh_total=total,
         heatmap_logit_std=heatmaps.std().item(),
         last_stack_mean_max_prob=max_prob.item(),
         plain_path={"loss": ref["loss"].item(), "loss_rel_diff": loss_rel,
                     "pred_orig_max_diff_px": pred_err,
                     "pckh_correct": ref["pckh_correct"].sum().item()},
         tolerance=STEP_TOL, shear_vs_gather_warp_max_diff=warp_err,
         warp_atol=WARP_ATOL, gt_roundtrip_err_px=gt_err)
    return {"cfg": cfg, "model": model, "batch": batch, "pre": pre,
            "heatmaps": heatmaps, "launches": launches,
            "row_shift_calls": row_shift_calls,
            "eval_step": eval_step, "infer_step": infer_step,
            "plain_eval": plain_eval}


def head_bytes_ops(n, hw, reg):
    nbytes = 4 * n * hw + 4 * 2 * n + 4 * n
    if reg in ("js", "kl", "mse"):
        nbytes += 4 * 2 * n
    return nbytes, HEAD_FLOPS_PER_ELEMENT[reg] * n * hw


def phase_head_on_main_path(run, ceiling):
    """The head kernel on the main path's own heatmaps, checked and timed,
    each call's rate beside the measured ceiling."""
    from dsnt_pose2d_tpu_torch.bench import timing
    from dsnt_pose2d_tpu_torch.ops.cuda import (fused_dsnt_head,
                                                fused_dsnt_head_reference)

    heat, pre, cfg = run["heatmaps"], run["pre"], run["cfg"].model
    s, b, j, h, w = heat.shape
    t = pre["coords"][None].expand(s, b, j, 2)
    calls = {  # the eval step's two launches: loss over all stacks, decode
        "js": (heat, t, "js"),
        "none": (heat[-1], None, "none"),
    }
    errs, work = [], {}
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for key, (x, tt, reg) in calls.items():
        kw = dict(sigma_px=cfg.hm_sigma, reg=reg, preact=cfg.preact,
                  threshold=cfg.hm_threshold)
        errs.extend(compare_head(x, tt, reg, cfg.preact, cfg.hm_threshold))
        times = timing.kernel_times(lambda: fused_dsnt_head(x, tt, **kw),
                                    lambda: fused_dsnt_head_reference(x, tt, **kw))
        n = x.numel() // (h * w)
        nbytes, nops = head_bytes_ops(n, h * w, reg)
        b_ms, by = bound_ms(nbytes, nops)
        work[key] = {"rows": n, "hw": h * w, **times, "bound_ms": b_ms,
                     "bound_by": by, "bytes": nbytes,
                     "GB_per_s": nbytes / times["ms"] / 1e6,
                     "frac_of_ceiling": nbytes / times["ms"] / 1e6 / ceiling}
        for k in ("ms", "plain_ms"):
            totals[k] += times[k]
        totals["bound_ms"] += b_ms
    return {"max_abs_err": max(errs), **totals, "bound_by": "bytes",
            "library_ms": None, "per_call": work}


def row_shift_library(rows, starts, fracs, out, stride):
    """``F.grid_sample`` set up to compute the same bilinear row shift."""
    r, length = rows.shape
    lpx, opx = length // stride, out // stride
    img = rows.view(r, lpx, stride).permute(0, 2, 1).unsqueeze(2)  # (R,C,1,L)
    pos = (starts // stride).float()[:, None] + torch.arange(
        opx, device=rows.device) + fracs[:, None]
    gx = 2.0 * pos / (lpx - 1) - 1.0
    grid = torch.stack([gx, torch.zeros_like(gx)], dim=-1)[:, None]  # (R,1,O,2)
    return img, grid


def phase_row_shift_timing(recorded, ceiling):
    """row_shift timed on the inputs the main path gave it, with per-step
    totals for each path (serve: the two calls of one eval step; train: the
    two of one train step), each call's rate beside the measured ceiling."""
    from dsnt_pose2d_tpu_torch.bench import timing
    from dsnt_pose2d_tpu_torch.ops.cuda import shift_rows, shift_rows_reference

    by_path, lib_err = {}, 0.0
    for path, calls in recorded.items():
        work, totals = {}, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                            "library_ms": 0.0}
        for (r, length, out), (rows, starts, fracs, _, stride) in calls.items():
            img, grid = row_shift_library(rows, starts, fracs, out, stride)
            lib = lambda: F.grid_sample(img, grid, mode="bilinear",
                                        padding_mode="zeros", align_corners=True)
            times = timing.kernel_times(
                lambda: shift_rows(rows, starts, fracs, out, stride=stride),
                lambda: shift_rows_reference(rows, starts, fracs, out,
                                             stride=stride),
                lib)
            got = shift_rows(rows, starts, fracs, out, stride=stride)
            ref = lib()[:, :, 0, :].permute(0, 2, 1).reshape(r, out)
            lib_err = max(lib_err, (got - ref).abs().max().item())
            # Each row's window (out + stride values), its start and frac
            # read once; the output written once.
            nbytes = 4 * r * (out + stride) + 8 * r + 4 * r * out
            b_ms, by = bound_ms(nbytes, 3 * r * out)
            work[f"{r}x{length}->{out}"] = {
                **times, "bound_ms": b_ms, "bound_by": by, "bytes": nbytes,
                "GB_per_s": nbytes / times["ms"] / 1e6,
                "frac_of_ceiling": nbytes / times["ms"] / 1e6 / ceiling}
            for k in ("ms", "plain_ms", "library_ms"):
                totals[k] += times[k]
            totals["bound_ms"] += b_ms
        by_path[path] = {**totals, "bound_by": "bytes", "per_call": work}
    # grid_sample rounds the normalized tap position in fp32 (rows of up to
    # 1288 px), so it agrees to ~1e-3, not bitwise.
    assert lib_err < 1e-2, f"grid_sample yardstick disagrees: {lib_err}"
    return by_path, lib_err


def phase_times(run, card):
    from dsnt_pose2d_tpu_torch.bench import timing

    batch = run["batch"]
    # Interleaved: the step is host-bound and the host is shared, so two
    # paths are compared only inside one window of time.
    infer_ms = timing.time_ms(lambda: run["infer_step"](batch), spread=True)
    eval_ms = timing.time_ms(lambda: run["eval_step"](batch), spread=True)
    plain_eval_ms = timing.time_ms(lambda: run["plain_eval"](batch), spread=True)
    eval_ms_2 = timing.time_ms(lambda: run["eval_step"](batch), spread=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    run["infer_step"](batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    run["step_ms"] = {"infer_step": infer_ms[0], "eval_step": eval_ms[0]}
    emit("step_times", card=card, batch=BATCH, batch_on_device=True,
         infer_ms=infer_ms[0], infer_img_per_s=BATCH / infer_ms[0] * 1e3,
         eval_ms=eval_ms[0], plain_path_eval_ms=plain_eval_ms[0],
         eval_ms_again=eval_ms_2[0],
         spread_min_max_ms={"infer": infer_ms[1:], "eval": eval_ms[1:],
                            "plain_path_eval": plain_eval_ms[1:],
                            "eval_again": eval_ms_2[1:]},
         peak_mem_bytes=peak, resident_before_step_bytes=base,
         clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu"))


def profile_step(name, step, median_ms, card):
    """Device time by kernel over one step, and the device's busy share of
    the step's wall time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from dsnt_pose2d_tpu_torch.ops import cuda as kernels

    step()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):     # see PROFILE_ATTEMPTS
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launched = kernels.launch_counts()
        kernels_by_name, spans, instances = {}, [], {}
        seen = dict.fromkeys(launched, 0)     # ported kernels' activities
        for e in _device_events(prof):
            spans.append((e.time_range.start, e.time_range.end))
            ms, count = kernels_by_name.get(e.name, (0.0, 0))
            kernels_by_name[e.name] = (
                ms + (e.time_range.end - e.time_range.start) / 1e3, count + 1)
            for k in seen:   # "(anonymous namespace)::row_shift_kernel(float ..."
                if re.search(rf"\b{k}_kernel\b", e.name):
                    seen[k] += 1
                    inst = _short_name("", e.name)
                    instances[inst] = instances.get(inst, 0) + 1
        if spans and seen == launched:
            break
    else:
        raise RuntimeError(f"torch.profiler recorded no complete profile of "
                           f"the {name} in {PROFILE_ATTEMPTS} attempts")
    busy_us, reach = 0.0, -math.inf
    for start, end in sorted(spans):      # union of the kernels' spans
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    top = sorted(kernels_by_name.items(), key=lambda kv: -kv[1][0])
    emit("profile", card=card, step=name, profiles=attempt, wall_ms=wall_ms,
         device_busy_ms=busy_us / 1e3,
         device_busy_share=busy_us / 1e3 / wall_ms,
         busy_share_of_unprofiled_median=busy_us / 1e3 / median_ms,
         device_launches=len(spans), ported_kernel_activities=seen,
         ported_kernel_instances=instances,
         top=[{"name": k[:90], "ms": ms, "count": c}
              for k, (ms, c) in top[:12]])
    return instances


def phase_profile(run, card):
    for name in ("infer_step", "eval_step"):
        profile_step(name, lambda: run[name](run["batch"]), run["step_ms"][name],
                     card)


def phase_train(dev, card):
    """The train step: the counted main-path run, the first step against the
    same step on the plain versions, times, peak memory and a profile."""
    from dsnt_pose2d_tpu_torch.bench import timing
    from dsnt_pose2d_tpu_torch.data.augment import preprocess_batch

    cfg, model = build_flagship(dev)
    assert cfg.optim.optimizer == "rmsprop" and cfg.data.max_rotation_deg > 0
    batch = synthetic_batch(dev)
    pre_args = (batch["canvases"], batch["coords_px"], batch["mask"],
                batch["head_length"], batch["canvas_from_orig"])
    with torch.no_grad():
        images = preprocess_batch(*pre_args, cfg.data, model.input_size,
                                  canvas_margin=batch["canvas_margin"])["images"]
    temper_scores(model.net, images, train=True)
    run = train_vs_plain(model, cfg, batch, dev, STEPS,
                         {"dsnt_head_fwd": STEPS, "dsnt_head_bwd": STEPS,
                          "row_shift": 2 * STEPS}, calls={})
    train_step, plain_step = run["step"], run["plain_step"]
    assert train_step.state.step == STEPS
    metrics, first, heat = run["metrics"], run["metrics"][0], run["heat"]
    max_prob = torch.softmax(heat[-1].flatten(2), -1).amax(-1).mean()
    emit("train_step", config=str(CONFIG.relative_to(ROOT)), batch=BATCH,
         canvas=CANVAS, steps=STEPS, launches=run["launches"],
         losses=run["losses"], grad_norms=[m["grad_norm"].item() for m in metrics],
         euclidean=first["euclidean"].item(), reg=first["reg"].item(),
         heatmap_logit_std=heat.std().item(),
         last_stack_mean_max_prob=max_prob.item(),
         plain_path=run["plain_path"], tolerance=TRAIN_TOL)

    # Interleaved, as for the serve steps: kernel, plain, kernel.
    def plain_train():
        with plain_head(), plain_row_shift():
            return plain_step(batch)

    step_ms = timing.time_ms(lambda: train_step(batch), spread=True)
    plain_ms = timing.time_ms(plain_train, spread=True)
    step_ms_2 = timing.time_ms(lambda: train_step(batch), spread=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    train_step(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    emit("train_step_times", card=card, batch=BATCH, batch_on_device=True,
         train_ms=step_ms[0], train_img_per_s=BATCH / step_ms[0] * 1e3,
         plain_path_train_ms=plain_ms[0], train_ms_again=step_ms_2[0],
         spread_min_max_ms={"train": step_ms[1:], "plain_path_train": plain_ms[1:],
                            "train_again": step_ms_2[1:]},
         peak_mem_bytes=peak, resident_before_step_bytes=base,
         clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu"))
    instances = profile_step("train_step", lambda: train_step(batch), step_ms[0],
                             card)
    return {"cfg": cfg, "batch": batch, "pre_args": pre_args,
            "launches": run["launches"],
            "train_img_per_s": BATCH / step_ms[0] * 1e3,
            "profile_instances": instances,
            "row_shift_calls": run["row_shift_calls"],
            "heat": heat, "dheat": run["dheat"], "model": model}


def phase_head_bwd_on_main_path(train, card):
    """The backward kernel on the train step's own heatmaps and cotangents,
    checked against the step's dL/dheatmaps and its plain version, and timed."""
    from dsnt_pose2d_tpu_torch.bench import timing
    from dsnt_pose2d_tpu_torch.data.augment import (preprocess_batch,
                                                    sample_train_draws)
    from dsnt_pose2d_tpu_torch.ops import euclidean_losses
    from dsnt_pose2d_tpu_torch.ops.cuda import (fused_dsnt_head,
                                                fused_dsnt_head_bwd,
                                                fused_dsnt_head_bwd_reference)
    from dsnt_pose2d_tpu_torch.train.state import step_seed

    cfg, heat = train["cfg"], train["heat"]
    s, b, j, h, w = heat.shape
    gen = torch.Generator(device=heat.device)
    gen.manual_seed(step_seed(cfg.train.seed, 0))
    with torch.no_grad():
        pre = preprocess_batch(*train["pre_args"], cfg.data,
                               cfg.model.resolved_input_size, train=True,
                               canvas_margin=train["batch"]["canvas_margin"],
                               draws=sample_train_draws(b, cfg.data, gen))
    t = pre["coords"][None].expand(s, b, j, 2)
    m = pre["mask"][None].expand(s, b, j)
    kw = dict(sigma_px=cfg.model.hm_sigma, reg=cfg.model.reg,
              preact=cfg.model.preact, threshold=cfg.model.hm_threshold)
    # The cotangents of the head's outputs in the step's loss.
    x = heat.clone().requires_grad_(True)
    coords, regv = fused_dsnt_head(x, t, **kw)
    per_joint = euclidean_losses(coords, t) + cfg.model.reg_coeff * regv
    loss = ((per_joint * m).sum(dim=(1, 2)) / m.sum(dim=(1, 2)).clamp_min(1.0)).sum()
    gc, gr = torch.autograd.grad(loss, (coords, regv))

    got = fused_dsnt_head_bwd(heat, t, gc, gr, **kw)
    again = fused_dsnt_head_bwd(heat, t, gc, gr, **kw)
    exp = fused_dsnt_head_bwd_reference(heat, t, gc, gr, **kw)
    torch.cuda.synchronize()
    assert_dh_close(got, exp)
    if not torch.equal(got, again):
        raise AssertionError("two launches of the head backward on the same "
                             "inputs differ")
    # The layout the train step's backward ran in, from its profile's
    # kernel names ("dsnt_head_bwd_kernel<1, false, Map64>").
    layouts = {name.rsplit(", ", 1)[-1].rstrip(">")
               for name in train["profile_instances"]
               if name.startswith("dsnt_head_bwd_kernel<")}
    if layouts != {"Map64"}:
        raise AssertionError(f"the train step's head backward ran in "
                             f"{layouts}, not the 64x64 layout")
    scale = exp.abs().max().item()
    step_err = (got - train["dheat"]).abs().max().item()
    assert step_err <= TRAIN_TOL["dheat_rel_to_max"] * scale, step_err
    times = timing.kernel_times(
        lambda: fused_dsnt_head_bwd(heat, t, gc, gr, **kw),
        lambda: fused_dsnt_head_bwd_reference(heat, t, gc, gr, **kw))
    n = s * b * j
    # raw read once, dh written once; targets and both cotangents read once.
    nbytes = 8 * n * h * w + 4 * 5 * n
    b_ms, by = bound_ms(nbytes, HEAD_BWD_FLOPS_PER_ELEMENT[cfg.model.reg] * n * h * w)
    return {"max_abs_err": (got - exp).abs().max().item(), **times,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "rows": n, "hw": h * w, "bytes": nbytes,
            "GB_per_s": nbytes / times["ms"] / 1e6, "dh_max_abs": scale,
            "vs_train_step_dheat_max_diff": step_err,
            "bitwise_equal_across_launches": True, "layout": "Map64"}


def train_vs_plain(model, cfg, batch, dev, steps, expected, calls=None):
    """``steps`` counted train steps (launches held against ``expected``),
    then the first step again from the same weights (the draws are a
    function of (seed, step) only) on the plain head and plain row_shift,
    held to TRAIN_TOL; returns the metrics, the launches, the row_shift
    calls (into ``calls``: see :func:`recording_row_shift`; a list if None),
    the first step's heatmaps and dL/dheatmaps, both steps and the
    comparison."""
    from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
    from dsnt_pose2d_tpu_torch.ops import cuda as kernels
    from dsnt_pose2d_tpu_torch.train.loop import make_train_fn

    start = {k: v.clone() for k, v in model.net.state_dict().items()}
    grab = {"on": False, "heat": [], "dheat": []}

    def capture(module, inputs, output):
        if grab["on"]:
            grab["heat"].append(output.heatmaps.detach().clone())
            output.heatmaps.register_hook(
                lambda g: grab["dheat"].append(g.detach().clone()))

    hook = model.net.register_forward_hook(capture)
    train_step = make_train_fn(model, cfg, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    metrics = []
    with recording_row_shift([] if calls is None else calls) as calls:
        for i in range(steps):
            grab["on"] = i == 0
            metrics.append(train_step(batch))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    expected = {**dict.fromkeys(launches, 0), **expected}
    if launches != expected:
        raise AssertionError(f"train launches {launches}, expected {expected}")
    losses = [m["loss"].item() for m in metrics]
    assert all(math.isfinite(v) and v > 0 for v in losses), losses

    plain_model = build_pose_model(cfg.model, device=dev, seed=0)
    plain_model.net.load_state_dict(start)
    plain_hook = plain_model.net.register_forward_hook(capture)
    plain_step = make_train_fn(plain_model, cfg, device=dev)
    grab["on"] = True
    kernels.reset_launch_counts()
    with plain_head(), plain_row_shift():
        ref = plain_step(batch)
    torch.cuda.synchronize()
    grab["on"] = False
    hook.remove()
    plain_hook.remove()
    assert not any(kernels.launch_counts().values()), kernels.launch_counts()
    first = metrics[0]
    loss_rel = abs(first["loss"].item() - ref["loss"].item()) / abs(ref["loss"].item())
    dheat, dheat_ref = grab["dheat"]
    dheat_err = (dheat - dheat_ref).abs().max().item()
    dheat_rel = dheat_err / dheat_ref.abs().max().item()
    norm_rel = (abs(first["grad_norm"].item() - ref["grad_norm"].item())
                / ref["grad_norm"].item())
    heat_equal = torch.equal(grab["heat"][0], grab["heat"][1])
    if (not heat_equal or loss_rel > TRAIN_TOL["loss_rtol"]
            or dheat_rel > TRAIN_TOL["dheat_rel_to_max"]
            or norm_rel > TRAIN_TOL["grad_norm_rtol"]):
        raise AssertionError(
            f"train step, kernel path vs plain path: heatmaps bitwise "
            f"equal {heat_equal}, loss rel {loss_rel}, "
            f"dL/dheatmaps rel {dheat_rel}, grad norm rel {norm_rel}")
    return {"metrics": metrics, "losses": losses, "launches": launches,
            "row_shift_calls": calls, "heat": grab["heat"][0], "dheat": dheat,
            "step": train_step, "plain_step": plain_step,
            "plain_path": {"loss": ref["loss"].item(), "loss_rel_diff": loss_rel,
                           "heatmaps_bitwise_equal": heat_equal,
                           "dheat_max_diff": dheat_err,
                           "dheat_rel_to_max": dheat_rel,
                           "grad_norm": ref["grad_norm"].item(),
                           "grad_norm_rel_diff": norm_rel}}


def eval_vs_plain(eval_step, batch):
    """The eval step against itself with the head's and row_shift's plain
    versions forced (the same step object), held to STEP_TOL."""
    from dsnt_pose2d_tpu_torch.ops import cuda as kernels

    out = eval_step(batch)
    kernels.reset_launch_counts()
    with plain_head(), plain_row_shift():
        ref = eval_step(batch)
    torch.cuda.synchronize()
    assert not any(kernels.launch_counts().values()), kernels.launch_counts()
    loss_rel = abs(out["loss"].item() - ref["loss"].item()) / abs(ref["loss"].item())
    pred_err = (out["pred_orig"] - ref["pred_orig"]).abs().max().item()
    counts_equal = torch.equal(out["pckh_correct"], ref["pckh_correct"])
    if (loss_rel > STEP_TOL["loss_rtol"] or pred_err > STEP_TOL["pred_orig_atol_px"]
            or not counts_equal):
        raise AssertionError(f"eval step vs plain path: loss rel {loss_rel}, "
                             f"pred_orig max err {pred_err} px, counts equal "
                             f"{counts_equal}")
    return {"loss": out["loss"].item(), "loss_rel_diff": loss_rel,
            "pred_orig_max_diff_px": pred_err, "pckh_counts_equal": True}


def peak_memory(fn) -> int:
    """Peak device memory (bytes) of one ``fn()`` call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def bwd_layouts(instances) -> set:
    """The layouts of the head backward's instances in a profile
    (``dsnt_head_bwd_kernel<1, false, StagedRow>`` -> ``StagedRow``)."""
    return {name.rsplit(", ", 1)[-1].rstrip(">") for name in instances
            if name.startswith("dsnt_head_bwd_kernel<")}


def head_on_rows(heat, t, reg, preact, ceiling, gc=None, dheat=None):
    """The head's forward (and, given the coords' cotangent ``gc``, its
    backward) on a path's own heatmaps: held against the plain versions
    (the backward also against the step's ``dheat`` and bitwise across two
    launches), timed, and stated against the bytes bound and the ceiling."""
    from dsnt_pose2d_tpu_torch.bench import timing
    from dsnt_pose2d_tpu_torch.ops.cuda import (fused_dsnt_head,
                                                fused_dsnt_head_bwd,
                                                fused_dsnt_head_bwd_reference,
                                                fused_dsnt_head_reference)

    *lead, h, w = heat.shape
    n = math.prod(lead)
    kw = dict(sigma_px=1.0, reg=reg, preact=preact)
    err = max(compare_head(heat, t, reg, preact, 0.0))
    times = timing.kernel_times(lambda: fused_dsnt_head(heat, t, **kw),
                                lambda: fused_dsnt_head_reference(heat, t, **kw))
    nbytes, nops = head_bytes_ops(n, h * w, reg)
    b_ms, by = bound_ms(nbytes, nops)
    fwd = {"rows": n, "hw": h * w, "max_abs_err": err, **times, "bound_ms": b_ms,
           "bound_by": by, "library_ms": None, "bytes": nbytes,
           "frac_of_ceiling": nbytes / times["ms"] / 1e6 / ceiling}
    if gc is None:
        return fwd, None
    got = fused_dsnt_head_bwd(heat, t, gc, None, **kw)
    again = fused_dsnt_head_bwd(heat, t, gc, None, **kw)
    exp = fused_dsnt_head_bwd_reference(heat, t, gc, None, **kw)
    torch.cuda.synchronize()
    assert_dh_close(got, exp)
    if not torch.equal(got, again):
        raise AssertionError("two launches of the head backward differ")
    step_err = (got - dheat).abs().max().item()
    assert step_err <= TRAIN_TOL["dheat_rel_to_max"] * exp.abs().max().item(), step_err
    times = timing.kernel_times(
        lambda: fused_dsnt_head_bwd(heat, t, gc, None, **kw),
        lambda: fused_dsnt_head_bwd_reference(heat, t, gc, None, **kw))
    nbytes = 8 * n * h * w + 4 * 4 * n      # raw, dh; targets and gc
    b_ms, by = bound_ms(nbytes, HEAD_BWD_FLOPS_PER_ELEMENT[reg] * n * h * w)
    bwd = {"rows": n, "hw": h * w, "max_abs_err": (got - exp).abs().max().item(),
           **times, "bound_ms": b_ms, "bound_by": by, "library_ms": None,
           "bytes": nbytes, "frac_of_ceiling": nbytes / times["ms"] / 1e6 / ceiling,
           "vs_train_step_dheat_max_diff": step_err,
           "bitwise_equal_across_launches": True}
    return fwd, bwd


def phase_resnet(dev, card, ceiling):
    """BASELINE config #5 (ResNet-50, dilate 2, 448 px, bf16, DSNT without
    a regularizer) at batch 32 on 672-px canvases: the eval and infer steps
    and the train step, counted and held against their plain paths, timed;
    the head at 512 rows of 56x56 (forward AnyMap, backward StagedRow) and
    row_shift at the 448-px calls, held and timed on the path's inputs."""
    from dsnt_pose2d_tpu_torch.bench import timing
    from dsnt_pose2d_tpu_torch.data.augment import preprocess_batch
    from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
    from dsnt_pose2d_tpu_torch.ops import cuda as kernels
    from dsnt_pose2d_tpu_torch.ops import euclidean_losses
    from dsnt_pose2d_tpu_torch.ops.cuda import fused_dsnt_head
    from dsnt_pose2d_tpu_torch.train.loop import make_eval_fn, make_infer_fn
    from dsnt_pose2d_tpu_torch.utils.config import config_from_json

    gc.collect()
    torch.cuda.empty_cache()
    cfg = config_from_json(RESNET_CONFIG.read_text())
    m = cfg.model
    assert (m.base, m.dilate, m.truncate, m.resolved_input_size, m.dtype,
            m.output_strat, m.preact, m.reg, m.use_pallas) == (
        "resnet50", 2, 0, 448, "bfloat16", "dsnt", "softmax", "none", True), m
    assert cfg.data.warp_method == "shear" and cfg.train.batch_size == BATCH
    model = build_pose_model(m, device=dev, seed=0)
    side = model.heatmap_size
    assert side == 56, side
    batch = synthetic_batch(dev, RESNET_CANVAS)
    pre_args = (batch["canvases"], batch["coords_px"], batch["mask"],
                batch["head_length"], batch["canvas_from_orig"])
    with torch.inference_mode():
        pre = preprocess_batch(*pre_args, cfg.data, model.input_size,
                               canvas_margin=batch["canvas_margin"])
    temper_scores(model.net, pre["images"], train=False)
    eval_step = make_eval_fn(model, cfg, device=dev)
    infer_step = make_infer_fn(model, cfg, device=dev)
    torch.cuda.synchronize()

    # Serve: the counted eval and infer steps, then the eval step against
    # the plain path.
    kernels.reset_launch_counts()
    with recording_row_shift([]) as serve_calls:
        outs = [eval_step(batch) for _ in range(STEPS)]
        served = [infer_step(batch) for _ in range(STEPS)]
    torch.cuda.synchronize()
    serve_launches = kernels.launch_counts()
    expected = {**dict.fromkeys(serve_launches, 0), "dsnt_head_fwd": 3 * STEPS,
                "row_shift": 4 * STEPS}
    if serve_launches != expected:
        raise AssertionError(f"resnet serve launches {serve_launches}, "
                             f"expected {expected}")
    pred = outs[0]["pred_orig"]
    assert pred.shape == (BATCH, 16, 2) and torch.isfinite(pred).all()
    for s in served:
        assert torch.equal(s, pred), "infer step disagrees with eval step"
    serve_vs_plain = eval_vs_plain(eval_step, batch)
    with torch.inference_mode():
        heat = model.forward(pre["images"]).heatmaps
    assert heat.shape == (1, BATCH, 16, side, side), heat.shape
    infer_ms = timing.time_ms(lambda: infer_step(batch), spread=True)
    eval_ms = timing.time_ms(lambda: eval_step(batch), spread=True)
    serve_peak = peak_memory(lambda: infer_step(batch))

    # The head's forward on the eval step's own 512 rows of 56x56.
    t = pre["coords"][None]
    fwd, _ = head_on_rows(heat, t, "none", m.preact, ceiling)

    # Train: tempered in train mode, counted, against the plain path.
    temper_scores(model.net, pre["images"], train=True)
    train = train_vs_plain(model, cfg, batch, dev, STEPS,
                           {"dsnt_head_fwd": STEPS, "dsnt_head_bwd": STEPS,
                            "row_shift": 2 * STEPS})
    assert set(train["metrics"][0]) == HEAD_METRICS["dsnt"]
    train_step = train["step"]
    train_ms = timing.time_ms(lambda: train_step(batch), spread=True)
    train_peak = peak_memory(lambda: train_step(batch))
    instances = profile_step("resnet_train_step", lambda: train_step(batch),
                             train_ms[0], card)
    if bwd_layouts(instances) != {"StagedRow"}:
        raise AssertionError(f"the ResNet train step's head backward ran in "
                             f"{bwd_layouts(instances)}, not StagedRow")

    # The head's backward on the train step's first heatmaps, with the
    # cotangent of the step's loss (reg none: the coords' only).
    from dsnt_pose2d_tpu_torch.data.augment import sample_train_draws
    from dsnt_pose2d_tpu_torch.train.state import step_seed

    gen = torch.Generator(device=dev)
    gen.manual_seed(step_seed(cfg.train.seed, 0))
    with torch.no_grad():
        pre_t = preprocess_batch(*pre_args, cfg.data, model.input_size, train=True,
                                 canvas_margin=batch["canvas_margin"],
                                 draws=sample_train_draws(BATCH, cfg.data, gen))
    heat_t, t_t = train["heat"], pre_t["coords"][None]
    mask = pre_t["mask"][None]
    x = heat_t.clone().requires_grad_(True)
    coords, _ = fused_dsnt_head(x, t_t, sigma_px=m.hm_sigma, reg="none",
                                preact=m.preact)
    loss = ((euclidean_losses(coords, t_t) * mask).sum(dim=(1, 2))
            / mask.sum(dim=(1, 2)).clamp_min(1.0)).sum()
    (gc_,) = torch.autograd.grad(loss, (coords,))
    _, bwd = head_on_rows(heat_t, t_t, "none", m.preact, ceiling, gc=gc_,
                          dheat=train["dheat"])
    bwd["layout"] = "StagedRow"
    fwd["layout"] = "AnyMap"

    recorded = {"resnet_serve": {(*c[0].shape, c[3]): c for c in serve_calls[:2]},
                "resnet_train": {(*c[0].shape, c[3]): c
                                 for c in train["row_shift_calls"][:2]}}
    shapes = {p: assert_row_shift_bitwise(p, list(calls.values()))
              for p, calls in recorded.items()}
    shift, shift_lib_err = phase_row_shift_timing(recorded, ceiling)
    launches = {k: serve_launches[k] + train["launches"][k] for k in serve_launches}
    emit("resnet", card=card, config=str(RESNET_CONFIG.relative_to(ROOT)),
         batch=BATCH, canvas=RESNET_CANVAS, heatmap_side=side, steps=STEPS,
         launches={"serve": serve_launches, "train": train["launches"]},
         serve={"loss": outs[0]["loss"].item(), "vs_plain": serve_vs_plain,
                "tolerance": STEP_TOL},
         train={"losses": train["losses"],
                "grad_norms": [mm["grad_norm"].item() for mm in train["metrics"]],
                "metric_keys": sorted(train["metrics"][0]),
                "vs_plain": train["plain_path"], "tolerance": TRAIN_TOL},
         heatmap_logit_std=heat.std().item(),
         infer_ms=infer_ms[0], infer_img_per_s=BATCH / infer_ms[0] * 1e3,
         eval_ms=eval_ms[0], eval_img_per_s=BATCH / eval_ms[0] * 1e3,
         train_ms=train_ms[0], train_img_per_s=BATCH / train_ms[0] * 1e3,
         spread_min_max_ms={"infer": infer_ms[1:], "eval": eval_ms[1:],
                            "train": train_ms[1:]},
         peak_mem_bytes={"infer": serve_peak, "train": train_peak},
         head_fwd_56=fwd, head_bwd_56=bwd, train_bwd_layouts=sorted(bwd_layouts(instances)),
         row_shift={"shapes": shapes, "by_path": shift, "library_err": shift_lib_err,
                    "bitwise_equal": True},
         ceiling_GB_per_s=ceiling,
         clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu"))
    del model, eval_step, infer_step, train, train_step
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "fwd": fwd, "bwd": bwd, "row_shift": shift,
            "max_row_shift_err": 0.0}


def heads_config(variant):
    """BASELINE config #4 with one head of the ablation, eval with flip and
    3 scales."""
    import dataclasses

    from dsnt_pose2d_tpu_torch.utils.config import config_from_json

    cfg = config_from_json(HEADS_CONFIG.read_text())
    m = cfg.model
    assert (m.base, m.hg_features, m.resolved_input_size, m.dtype, m.use_pallas) == (
        "hg4", 256, 256, "bfloat16", True), m
    assert cfg.train.batch_size == BATCH and cfg.data.warp_method == "shear"
    return dataclasses.replace(
        cfg, model=dataclasses.replace(m, **HEAD_VARIANTS[variant]),
        train=dataclasses.replace(cfg.train, flip_eval=True,
                                  eval_scales=HEADS_SCALES))


def phase_heads(dev, card):
    """The head ablation on hg4: for dsnt+js, gauss and fc, HEADS_STEPS
    train steps and an eval step with flip and 3 scales at batch 32,
    counted; the eval step and the first train step against the plain
    path; row_shift bitwise on the calls the steps made; step times, peak
    memory and a train-step profile; then fc through cli.train ->
    cli.evaluate."""
    import io
    import tempfile

    from dsnt_pose2d_tpu_torch.bench import timing
    from dsnt_pose2d_tpu_torch.cli import evaluate as evaluate_cli
    from dsnt_pose2d_tpu_torch.cli import train as train_cli
    from dsnt_pose2d_tpu_torch.data.augment import preprocess_batch
    from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
    from dsnt_pose2d_tpu_torch.ops import cuda as kernels
    from dsnt_pose2d_tpu_torch.train.loop import EvalDriver, make_eval_fn

    gc.collect()
    torch.cuda.empty_cache()
    batch = synthetic_batch(dev)
    out, total = {}, {}
    # Per eval step with flip and 3 scales: 3 + 2 * 2 head forwards (dsnt
    # only) and 2 row_shift a scale; per train step 1 forward and 1 backward
    # (dsnt only) and 2 row_shift.
    n_scales = len(HEADS_SCALES)
    for variant in HEAD_VARIANTS:
        cfg = heads_config(variant)
        dsnt = variant == "dsnt"
        model = build_pose_model(cfg.model, device=dev, seed=0)
        if dsnt:
            with torch.no_grad():
                images = preprocess_batch(
                    batch["canvases"], batch["coords_px"], batch["mask"],
                    batch["head_length"], batch["canvas_from_orig"], cfg.data,
                    model.input_size, canvas_margin=batch["canvas_margin"])["images"]
            temper_scores(model.net, images, train=True)
        per_train = {"dsnt_head_fwd": int(dsnt), "dsnt_head_bwd": int(dsnt),
                     "row_shift": 2}
        train = train_vs_plain(model, cfg, batch, dev, HEADS_STEPS,
                               {k: HEADS_STEPS * v for k, v in per_train.items()})
        keys = set(train["metrics"][0])
        if keys != HEAD_METRICS[variant]:
            raise AssertionError(f"{variant} train metrics {keys}, the JAX "
                                 f"package's {HEAD_METRICS[variant]}")
        eval_step = make_eval_fn(model, cfg, device=dev)
        kernels.reset_launch_counts()
        with recording_row_shift([]) as eval_calls:
            ev = eval_step(batch)
        torch.cuda.synchronize()
        eval_launches = kernels.launch_counts()
        expected = {**dict.fromkeys(eval_launches, 0), "row_shift": 2 * n_scales,
                    "dsnt_head_fwd": (3 + 2 * (n_scales - 1)) if dsnt else 0}
        if eval_launches != expected:
            raise AssertionError(f"{variant} eval launches {eval_launches}, "
                                 f"expected {expected}")
        pred = ev["pred_orig"]
        assert pred.shape == (BATCH, 16, 2) and torch.isfinite(pred).all()
        assert math.isfinite(ev["loss"].item())
        vs_plain = eval_vs_plain(eval_step, batch)
        shapes = assert_row_shift_bitwise(
            f"heads_{variant}", train["row_shift_calls"][:2] + eval_calls)
        train_step = train["step"]
        train_ms = timing.time_ms(lambda: train_step(batch), spread=True)
        eval_ms = timing.time_ms(lambda: eval_step(batch), spread=True)
        peak = peak_memory(lambda: train_step(batch))
        profile_step(f"hg4_{variant}_train_step", lambda: train_step(batch),
                     train_ms[0], card)
        for k, v in train["launches"].items():
            total[k] = total.get(k, 0) + v + eval_launches.get(k, 0)
        out[variant] = {
            "flags": HEAD_VARIANTS[variant], "losses": train["losses"],
            "metric_keys": sorted(keys),
            "metrics_step0": {k: v.item() for k, v in train["metrics"][0].items()},
            "train_vs_plain": train["plain_path"],
            "eval_loss": ev["loss"].item(), "eval_vs_plain": vs_plain,
            "launches": {"train": train["launches"], "eval_flip_scales": eval_launches},
            "row_shift_bitwise_shapes": shapes,
            "train_ms": train_ms[0], "train_img_per_s": BATCH / train_ms[0] * 1e3,
            "eval_flip_scales_ms": eval_ms[0],
            "eval_flip_scales_img_per_s": BATCH / eval_ms[0] * 1e3,
            "spread_min_max_ms": {"train": train_ms[1:], "eval": eval_ms[1:]},
            "peak_mem_bytes": peak}
        del model, train, train_step, eval_step, ev
        gc.collect()
        torch.cuda.empty_cache()

    # fc through the CLIs: cli.train (one epoch: 2 resident steps in one
    # dispatch, one eval step) -> cli.evaluate, whose PCKh must equal the
    # train run's val_pckh.
    drivers = []

    class RecordingDriver(EvalDriver):
        def evaluate(self, *args, **kw):
            result = super().evaluate(*args, **kw)
            drivers.append(result)
            return result

    data = ["--data-source", "synthetic", "--synthetic-size", str(HEADS_CLI_ROWS),
            "--canvas-size", str(CANVAS), "--device", dev.type]
    saved = evaluate_cli.EvalDriver
    evaluate_cli.EvalDriver = RecordingDriver
    cli_launches = {}
    try:
        with tempfile.TemporaryDirectory(prefix="dsnt_heads_") as tmp:
            for name, argv in (
                    ("train", ["--base-model", "hg4", "--output-strat", "fc",
                               "--batch-size", str(BATCH), "--epochs", "1",
                               "--device-resident", "on", "--steps-per-dispatch", "2",
                               "--out-dir", tmp, "--experiment-id", "fc"]),
                    ("evaluate", ["--model-dir", os.path.join(tmp, "fc")])):
                main = train_cli.main if name == "train" else evaluate_cli.main
                kernels.reset_launch_counts()
                with contextlib.redirect_stdout(io.StringIO()):
                    assert main(argv + data) == 0
                torch.cuda.synchronize()
                cli_launches[name] = kernels.launch_counts()
            with open(os.path.join(tmp, "fc", "metrics.jsonl")) as f:
                summary = [r for r in map(json.loads, f) if "step" not in r][-1]
    finally:
        evaluate_cli.EvalDriver = saved
    # row_shift: 2 a step; the train run's steps and its one eval pass, then
    # evaluate's pass over the val split (cli.common.make_datasets' size).
    eval_steps = -(-max(HEADS_CLI_ROWS // 4, 8) // BATCH)
    expected = {"train": 2 * (HEADS_CLI_ROWS // BATCH + eval_steps),
                "evaluate": 2 * eval_steps}
    for name, counts in cli_launches.items():
        if (counts["row_shift"], counts["dsnt_head_fwd"], counts["dsnt_head_bwd"]) != (
                expected[name], 0, 0):
            raise AssertionError(f"heads cli {name} launches {counts}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    (result,) = drivers
    if result["pckh"] != summary["val_pckh"]:
        raise AssertionError(f"fc: evaluate's PCKh {result['pckh']} != the "
                             f"train run's {summary['val_pckh']}")
    emit("heads", card=card, config=str(HEADS_CONFIG.relative_to(ROOT)), batch=BATCH,
         canvas=CANVAS, steps=HEADS_STEPS, eval_scales=list(HEADS_SCALES),
         flip_eval=True, per_head=out,
         fc_cli={"launches": cli_launches, "val_pckh": summary["val_pckh"],
                 "evaluate_pckh": result["pckh"], "round_trip_equal": True},
         tolerance={"eval": STEP_TOL, "train": TRAIN_TOL},
         clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu"))
    return total


def calib_fns(kind):
    """A calibration kernel's wrapper and its plain version."""
    from dsnt_pose2d_tpu_torch.ops.cuda import calib

    return (getattr(calib, f"calib_{kind}"),
            getattr(calib, f"calib_{kind}_reference"))


def assert_calib_close(kind, got, exp):
    tol = CALIB_TOL[kind]
    if tol is None:
        if not torch.equal(got, exp):
            raise AssertionError(f"calib_{kind} differs from its plain version: "
                                 f"max {(got - exp).abs().max().item()}")
    else:
        torch.testing.assert_close(got, exp, **tol)


def phase_calib_vs_plain(dev):
    """Each calibration kernel against its plain version on random rows and
    a nonzero scalar, at the bench's shape, a row count that is no multiple
    of the TPU's 128-row blocks, and a ragged width (257 float4 a row)."""
    errs = {kind: 0.0 for kind in CALIB_TOL}
    for i, (rows, cols) in enumerate(CALIB_SHAPES):
        g = torch.Generator().manual_seed(i)
        x = (torch.randn((rows, cols), generator=g) * 3.0).to(dev)
        s = torch.full((1,), 0.37, device=dev)
        for kind in CALIB_TOL:
            kernel, plain = calib_fns(kind)
            got, exp = kernel(x, s), plain(x, s)
            torch.cuda.synchronize()
            assert_calib_close(kind, got, exp)
            errs[kind] = max(errs[kind], (got - exp).abs().max().item())
    emit("calib_vs_plain", shapes=[list(sh) for sh in CALIB_SHAPES],
         tolerance=CALIB_TOL, max_abs_err=errs)
    return errs


# Operations per element: the add; the add and expf; the add, max, subtract,
# expf, sum and division.
CALIB_OPS_PER_ELEMENT = {"copy": 1, "exp": 2, "smax": 6}
EXP_ROUNDS = 6


def phase_calibration(card):
    """The calibration kernels timed at the bench's (8192, 4096), beside
    their plain versions and one PyTorch call each.  s is 0 here, so
    ``torch.add(x, s)``, ``torch.exp(x)`` and ``torch.softmax(x, dim=1)``
    compute the kernels' functions on these inputs."""
    from dsnt_pose2d_tpu_torch.bench import timing
    from dsnt_pose2d_tpu_torch.bench.kernel import COLS

    rows = CALIB_SHAPES[0][0]
    x = torch.randn((rows, COLS), generator=torch.Generator().manual_seed(0))
    x = x.cuda()
    s = torch.zeros((1,), device=x.device)
    library = {"copy": lambda: torch.add(x, s), "exp": lambda: torch.exp(x),
               "smax": lambda: torch.softmax(x, dim=1)}
    nbytes = 2 * rows * COLS * 4 + 4      # x read, o written, s read
    out = {}
    for kind, lib in library.items():
        kernel, plain = calib_fns(kind)
        assert_calib_close(kind, kernel(x, s), lib())
        times = timing.kernel_times(lambda: kernel(x, s), lambda: plain(x, s), lib)
        b_ms, by = bound_ms(nbytes, CALIB_OPS_PER_ELEMENT[kind] * rows * COLS)
        out[kind] = {**times, "bound_ms": b_ms, "bound_by": by, "bytes": nbytes,
                     "GB_per_s": nbytes / times["ms"] / 1e6,
                     "library_GB_per_s": nbytes / times["library_ms"] / 1e6}
    ceiling = out["copy"]["GB_per_s"]
    # calib_exp against torch.exp in turns (kernel, library, library,
    # kernel), EXP_ROUNDS times: the two differ by less than either's
    # spread between runs, so they are compared only inside one window.
    kernel = calib_fns("exp")[0]
    turns = {"kernel": [], "library": []}
    for _ in range(EXP_ROUNDS):
        for who in ("kernel", "library", "library", "kernel"):
            fn = (lambda: kernel(x, s)) if who == "kernel" else library["exp"]
            turns[who].append(timing.device_ms(fn)[0])
    exp_turns = {who: {"median_ms": statistics.median(t), "min_ms": min(t),
                       "max_ms": max(t), "ms": t} for who, t in turns.items()}
    exp_turns["kernel_over_library"] = (exp_turns["kernel"]["median_ms"]
                                        / exp_turns["library"]["median_ms"])
    emit("calibration", card=card, shape=[rows, COLS], per_kernel=out,
         ceiling_GB_per_s=ceiling, exp_vs_torch_exp_in_turns=exp_turns,
         library_calls=["torch.add(x, s)", "torch.exp(x)",
                        "torch.softmax(x, dim=1)"])
    return out, ceiling


def phase_kernel_bench(card):
    """``bench.kernel``'s records at its defaults (8192 rows: hg8 at batch
    64), counted: the first run of the bench path."""
    from dsnt_pose2d_tpu_torch.bench import kernel as bench_kernel
    from dsnt_pose2d_tpu_torch.ops import cuda as kernels

    kernels.reset_launch_counts()
    records = bench_kernel.run("cuda")
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    for rec in records[2:]:
        assert rec["fwd_frac_of_ceiling"] <= 1.05, rec
    emit("kernel_bench", card=card, records=records, launches=launches)
    return launches


def phase_bench(card):
    """``bench.step``'s device step, streaming epochs (k=1) and resident
    epochs (k=4) of the flagship at batch 32 and small counts, counted: the
    second run of the bench path."""
    from dsnt_pose2d_tpu_torch.bench import step as bench_step
    from dsnt_pose2d_tpu_torch.ops import cuda as kernels

    kernels.reset_launch_counts()
    dev_step = bench_step.measure_step(batch=BATCH, device="cuda", **BENCH_KW)
    gc.collect()
    torch.cuda.empty_cache()
    e2e = {}
    for key, resident, k in (("e2e", False, 1), ("e2e_resident", True, 4)):
        r = bench_step.measure_e2e(batch=BATCH, resident=resident,
                                   steps_per_dispatch=k, device="cuda", **E2E_KW)
        r["vs_device_step_pct"] = 100.0 * r["median"] / dev_step["median"]
        e2e[key] = r
        gc.collect()              # the previous run's model and optimizer
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    assert dev_step["median"] > 0 and 0 < dev_step["implied_mfu"] <= 1, dev_step
    assert dev_step["tflops_per_step"] > 0, dev_step
    emit("bench", card=card, batch=BATCH, value=dev_step["median"],
         device_step=dev_step, **e2e, launches=launches,
         clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu"))
    return launches


def synthetic_split(rows, seed):
    """``rows`` synthetic samples at CANVAS px from ``data/synthetic.py``,
    made 16 rows at a time on a thread pool (chunk ``c`` from seed
    ``seed * 1000 + c``)."""
    from concurrent.futures import ThreadPoolExecutor

    from dsnt_pose2d_tpu_torch.data.synthetic import make_synthetic_mpii

    chunks = [(min(16, rows - i), seed * 1000 + i // 16) for i in range(0, rows, 16)]
    with ThreadPoolExecutor(8) as pool:
        parts = list(pool.map(lambda c: make_synthetic_mpii(c[0], CANVAS, seed=c[1]),
                              chunks))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def trainer_config():
    """The flagship config as ``Trainer.run`` takes it, nothing cut but the
    number of epochs; eval every epoch, a step checkpoint every 4 steps."""
    import dataclasses

    from dsnt_pose2d_tpu_torch.utils.config import config_from_json

    cfg = config_from_json(CONFIG.read_text())
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=TRAINER_EPOCHS, eval_every_epochs=1,
        checkpoint_every_epochs=1,
        checkpoint_every_steps=TRAINER_CKPT_EVERY_STEPS))
    m, o, t = cfg.model, cfg.optim, cfg.train
    assert (m.base, m.hg_features, m.resolved_input_size, m.dtype, m.reg,
            m.hm_sigma, m.use_pallas) == ("hg8", 256, 256, "bfloat16", "js",
                                          1.0, True), m
    assert (o.optimizer, o.lr, o.schedule) == ("rmsprop", 2.5e-4, "step"), o
    assert (t.batch_size, t.steps_per_dispatch) == (BATCH, 4), t
    assert cfg.data.device_resident == "auto", cfg.data
    return cfg


def build_trainer(cfg, dev, out_dir, splits):
    from dsnt_pose2d_tpu_torch.data.loader import ShardedLoader
    from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
    from dsnt_pose2d_tpu_torch.train.checkpoint import CheckpointManager
    from dsnt_pose2d_tpu_torch.train.loop import Trainer
    from dsnt_pose2d_tpu_torch.train.metrics import MetricWriter

    return Trainer(
        model=build_pose_model(cfg.model, device=dev, seed=0), cfg=cfg,
        train_loader=ShardedLoader(splits["train"], BATCH, shuffle=True,
                                   seed=cfg.train.seed),
        val_loader=ShardedLoader(splits["val"], BATCH, shuffle=False,
                                 drop_last=False),
        checkpointer=CheckpointManager(str(out_dir), cfg),
        metric_writer=MetricWriter(str(out_dir), echo=False), device=dev)


def trained_state(state) -> dict:
    """The parameters, BN statistics and optimizer state of ``state``, on
    the host, with its step, count and learning rate."""
    from dsnt_pose2d_tpu_torch.train.checkpoint import state_payload

    opt = state.optimizer.optimizer
    return {**state_payload(state), "lr": opt.param_groups[0]["lr"]}


def state_diffs(a: dict, b: dict) -> dict:
    """Tensors of two :func:`trained_state` dicts that are not bitwise
    equal, with their largest difference."""
    diffs = {}
    for k, v in a["model"].items():
        if not torch.equal(v, b["model"][k]):
            diffs[f"model.{k}"] = (v.double() - b["model"][k].double()).abs().max().item()
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            if not torch.equal(v, b["optimizer"]["state"][i][k]):
                diffs[f"optimizer.{i}.{k}"] = (
                    v.double() - b["optimizer"]["state"][i][k].double()).abs().max().item()
    return diffs


def steps_ms(fn, n=4):
    """Host-clock ms per call of ``fn`` over ``n`` calls that end in a
    synchronize, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def phase_trainer(dev, card, device_step_img_per_s):
    """``Trainer.run`` on the flagship config: run A (2 epochs, counted),
    then run B from run A's mid-epoch checkpoint, held bitwise against run
    A, then the streaming eval pass against the resident scan."""
    import shutil
    import tempfile

    from dsnt_pose2d_tpu_torch.data.loader import ShardedLoader
    from dsnt_pose2d_tpu_torch.data.mpii import ArrayDataset
    from dsnt_pose2d_tpu_torch.ops import cuda as kernels
    from dsnt_pose2d_tpu_torch.train.checkpoint import STATE_FILENAME
    from dsnt_pose2d_tpu_torch.train.loop import run_evaluation

    gc.collect()
    torch.cuda.empty_cache()
    cfg = trainer_config()
    t0 = time.time()
    splits = {name: ArrayDataset(synthetic_split(rows, seed=i + 1))
              for i, (name, rows) in enumerate(TRAINER_ROWS.items())}
    data_s = time.time() - t0
    spe = TRAINER_ROWS["train"] // BATCH
    eval_steps = -(-TRAINER_ROWS["val"] // BATCH)
    steps = TRAINER_EPOCHS * spe
    cudnn = torch.backends.cudnn
    saved_flags = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        with tempfile.TemporaryDirectory(prefix="dsnt_trainer_") as tmp:
            tmp = Path(tmp)
            trainer = build_trainer(cfg, dev, tmp / "a", splits)
            assert trainer.resident is not None and trainer.val_resident is not None
            assert trainer.resident_multi is not None
            assert (trainer.resident.steps_per_epoch,
                    trainer.val_resident.steps_per_epoch) == (spe, eval_steps)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            t0 = time.time()
            state, best = trainer.run()
            torch.cuda.synchronize()
            run_s = time.time() - t0
            launches = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            expected = {**dict.fromkeys(launches, 0),
                        "dsnt_head_fwd": steps + 2 * TRAINER_EPOCHS * eval_steps,
                        "dsnt_head_bwd": steps,
                        "row_shift": 2 * (steps + TRAINER_EPOCHS * eval_steps)}
            if launches != expected:
                raise AssertionError(f"trainer launches {launches}, expected {expected}")
            assert state.step == state.optimizer.count == steps, (
                state.step, state.optimizer.count)
            run_a = trained_state(state)
            out_a = tmp / "a"
            with open(out_a / "metrics.jsonl") as f:
                records = [json.loads(line) for line in f]
            summaries = [r for r in records if "step" not in r]
            step_records = [(r["epoch"], r["step"]) for r in records if "step" in r]
            assert [r["epoch"] for r in summaries] == list(range(TRAINER_EPOCHS))
            for r in summaries:
                assert math.isfinite(r["train_loss"]) and 0.0 <= r["val_pckh"] <= 1.0, r
            # One record per multi-step dispatch whose index is a multiple
            # of log_every_steps // k (the flagship's 20 // 4: the first of
            # each epoch), with the global step after it.
            k = cfg.train.steps_per_dispatch
            every = max(1, cfg.train.log_every_steps // k)
            assert step_records == [(e, e * spe + (d + 1) * k)
                                    for e in range(TRAINER_EPOCHS)
                                    for d in range(0, spe // k, every)], step_records
            saved = {d: sorted(os.listdir(out_a / d), key=int)
                     for d in ("ckpt", "ckpt_best", "ckpt_step")}
            assert saved["ckpt"] == [str(e) for e in range(TRAINER_EPOCHS)], saved
            assert saved["ckpt_step"] == ["4", "12"] and len(saved["ckpt_best"]) == 1, saved
            assert (out_a / "best.json").exists()
            samples = sorted(os.listdir(out_a / "samples"))
            assert samples == [f"epoch{e:04d}_s{i}.png" for e in range(TRAINER_EPOCHS)
                               for i in range(4)], samples
            ckpt_bytes = os.path.getsize(out_a / "ckpt" / "1" / STATE_FILENAME)
            del trainer, state
            gc.collect()
            torch.cuda.empty_cache()

            # Run B: a fresh Trainer resumes from run A's mid-epoch save
            # (epoch 1, step_in_epoch 4), restored in place.
            out_b = tmp / "b"
            shutil.copytree(out_a / "ckpt_step" / "12", out_b / "ckpt_step" / "12")
            trainer = build_trainer(cfg, dev, out_b, splits)
            restored, meta = trainer.checkpointer.restore_latest(trainer.init_state())
            assert (meta["epoch"], meta["step_in_epoch"], restored.step) == (1, 4, 12), meta
            t0 = time.time()
            state, _ = trainer.run(restored, start_epoch=meta["epoch"],
                                   start_step=meta["step_in_epoch"],
                                   best_pckh=summaries[0]["val_pckh"])
            torch.cuda.synchronize()
            resume_s = time.time() - t0
            run_b = trained_state(state)
            diffs = state_diffs(run_a, run_b)
            same = {k: run_a[k] == run_b[k] for k in ("step", "count", "lr")}
            if diffs or not all(same.values()):
                raise AssertionError(
                    f"resumed run differs from the uninterrupted one: {same}, "
                    f"{len(diffs)} tensors, largest {sorted(diffs.items(), key=lambda kv: -kv[1])[:5]}")

            # The streaming eval pass against the resident scan, same weights.
            scan = trainer.evaluate()
            streamed = run_evaluation(
                trainer.eval_step, dev,
                ShardedLoader(splits["val"], BATCH, shuffle=False, drop_last=False),
                cfg.model.num_joints)
            counts_equal = all(np.array_equal(getattr(scan["evaluator"], k),
                                              getattr(streamed["evaluator"], k))
                               for k in ("correct", "total"))
            loss_rel = abs(streamed["loss"] - scan["loss"]) / abs(scan["loss"])
            if not counts_equal or loss_rel > TRAINER_EVAL_LOSS_RTOL:
                raise AssertionError(
                    f"streaming eval vs resident scan: counts equal {counts_equal}, "
                    f"loss rel {loss_rel}")

            # What the phase's determinism costs: the Trainer's resident
            # single step with cuDNN's deterministic algorithms and with its
            # default ones, in turns (host clock over synchronised steps).
            res, idx = trainer.resident.resident, next(trainer.resident.epoch(0))
            det_ms = {"deterministic": [], "default": []}
            for det in (True, False, True, False):
                cudnn.deterministic = det
                det_ms["deterministic" if det else "default"].append(
                    steps_ms(lambda: trainer.resident_step(res, idx)))
            cudnn.deterministic = True
            del trainer, state, restored
    finally:
        cudnn.deterministic, cudnn.benchmark = saved_flags
    ips = [r["images_per_sec"] for r in summaries]
    emit("trainer", card=card, config=str(CONFIG.relative_to(ROOT)), batch=BATCH,
         canvas=CANVAS, rows=TRAINER_ROWS, epochs=TRAINER_EPOCHS,
         steps_per_dispatch=cfg.train.steps_per_dispatch, resident=True,
         cudnn_deterministic=True, launches=launches,
         epoch_images_per_sec=ips, device_step_images_per_sec=device_step_img_per_s,
         epoch_vs_device_step=[v / device_step_img_per_s for v in ips],
         epoch_seconds=[r["epoch_seconds"] for r in summaries],
         eval_seconds=[r["eval_seconds"] for r in summaries],
         ckpt_seconds=[r["ckpt_seconds"] for r in summaries],
         checkpoint_bytes=ckpt_bytes, peak_mem_bytes=peak, run_seconds=run_s,
         data_seconds=data_s, summaries=summaries, saved=saved, best_pckh=best,
         resume={"from": meta, "seconds": resume_s, "bitwise_equal": True,
                 "tensors": len(run_a["model"]) + sum(
                     len(st) for st in run_a["optimizer"]["state"].values()),
                 **same},
         resident_step_ms_in_turns=det_ms,
         eval_agreement={"pckh_counts_equal": True, "loss_rel_diff": loss_rel,
                         "scan_loss": scan["loss"], "streamed_loss": streamed["loss"],
                         "pckh": scan["pckh"], "loss_rtol": TRAINER_EVAL_LOSS_RTOL},
         clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu"))
    return launches


# The cli phase: the flagship through the train, evaluate and infer CLIs at
# batch 32 on 384-px synthetic canvases: 128 train rows (4 steps, one
# resident dispatch of k=4) and 32 val rows (one eval step), one epoch; then
# the Trainer's auto-pack over a decode-backed stand-in of the same 128 rows,
# 2 epochs.
CLI_MODEL = ["--base-model", "hg8", "--reg", "js", "--hm-sigma", "1.0"]
CLI_ROWS = 128
CLI_SCALES = "0.9,1.0,1.1"
CLI_AUTOPACK_EPOCHS = 2
# Kernel launches of one run of each, from the code: the train CLI's 4 steps
# (1 head fwd, 1 bwd, 2 row_shift each) and its one resident eval step (2
# fwd: decode and loss; 2 row_shift); a single-pass eval step (2 fwd, 2
# row_shift); the eval step with flip and 3 scales (the canonical pass:
# decode, loss, flipped decode = 3 fwd, 2 row_shift; each other scale:
# decode and flipped decode = 2 fwd, 2 row_shift; the flip reuses the warped
# images); the infer step with flip and 3 scales (2 fwd, 2 row_shift a
# scale); auto-pack: 4 streamed + 4 resident train steps.
CLI_LAUNCHES = {
    "train": {"dsnt_head_fwd": 4 + 2, "dsnt_head_bwd": 4, "row_shift": 8 + 2},
    "evaluate": {"dsnt_head_fwd": 2, "dsnt_head_bwd": 0, "row_shift": 2},
    "evaluate_flip_scales": {"dsnt_head_fwd": 3 + 2 * 2, "dsnt_head_bwd": 0,
                             "row_shift": 2 * 3},
    "infer_flip_scales": {"dsnt_head_fwd": 2 * 3, "dsnt_head_bwd": 0,
                          "row_shift": 2 * 3},
    "autopack": {"dsnt_head_fwd": 8, "dsnt_head_bwd": 8, "row_shift": 16},
}


def assert_cli_flagship(cfg):
    """The train CLI's config, as its run wrote it: the flagship at full
    width (the CLI's defaults: 256 features, 256 px, bf16, the fused head),
    at batch 32."""
    m = cfg.model
    assert (m.base, m.hg_features, m.resolved_input_size, m.dtype, m.reg,
            m.hm_sigma, m.use_pallas) == ("hg8", 256, 256, "bfloat16", "js",
                                          1.0, True), m
    assert cfg.train.batch_size == BATCH and cfg.data.warp_method == "shear"


class DecodeBackedStandIn:
    """Rows of a dict of arrays behind the surface that the Trainer's
    auto-pack takes for a decode-backed MPII split (``images_dir``,
    ``canvas_size``, ``subset``): the card machine has neither PIL nor
    h5py, so no MPII layout can be decoded there."""

    images_dir = "synthetic"
    subset = "train"

    def __init__(self, arrays: dict):
        self.arrays = arrays
        self.canvas_size = arrays["canvases"].shape[1]

    def __len__(self):
        return len(self.arrays["canvases"])

    def __getitem__(self, i: int) -> dict:
        return {k: v[i] for k, v in self.arrays.items()}


def phase_cli(dev, card):
    """The CLIs' main(argv) in this process (so the launch counters count),
    at the flagship's full width, then the Trainer's auto-pack."""
    import dataclasses
    import functools
    import io
    import tempfile

    from scipy.io import loadmat

    from dsnt_pose2d_tpu_torch import native
    from dsnt_pose2d_tpu_torch.bench import timing
    from dsnt_pose2d_tpu_torch.cli import common
    from dsnt_pose2d_tpu_torch.cli import evaluate as evaluate_cli
    from dsnt_pose2d_tpu_torch.cli import infer as infer_cli
    from dsnt_pose2d_tpu_torch.cli import train as train_cli
    from dsnt_pose2d_tpu_torch.data.loader import ShardedLoader, to_device
    from dsnt_pose2d_tpu_torch.data.pack import PackedDataset
    from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
    from dsnt_pose2d_tpu_torch.ops import cuda as kernels
    from dsnt_pose2d_tpu_torch.train.loop import EvalDriver, Trainer
    from dsnt_pose2d_tpu_torch.train.metrics import MetricWriter
    from dsnt_pose2d_tpu_torch.utils.config import config_from_json

    gc.collect()
    torch.cuda.empty_cache()
    drivers = []

    class RecordingDriver(EvalDriver):
        """The CLIs' EvalDriver, kept with what evaluate() returned."""

        def __post_init__(self):
            super().__post_init__()
            self.result = None
            drivers.append(self)

        def evaluate(self, *args, **kw):
            self.result = super().evaluate(*args, **kw)
            return self.result

    launches, walls, printed = {}, {}, {}

    def counted(name, fn):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        launches[name] = {k: v for k, v in kernels.launch_counts().items()
                          if k in CLI_LAUNCHES[name]}
        printed[name] = out.getvalue().splitlines()
        if launches[name] != CLI_LAUNCHES[name]:
            raise AssertionError(f"cli {name} launches {launches[name]}, "
                                 f"expected {CLI_LAUNCHES[name]}")
        return result

    # Same seeds, same arrays: each CLI makes the synthetic splits again, and
    # the smoke makes each split once.
    synth = functools.cache(common.make_synthetic_mpii)
    saved = (common.make_synthetic_mpii, evaluate_cli.EvalDriver,
             infer_cli.EvalDriver)
    common.make_synthetic_mpii = synth
    evaluate_cli.EvalDriver = infer_cli.EvalDriver = RecordingDriver
    val_rows = max(CLI_ROWS // 4, 8)     # cli.common.make_datasets' val split
    assert val_rows == BATCH, "one eval step"
    data = ["--data-source", "synthetic", "--synthetic-size", str(CLI_ROWS),
            "--canvas-size", str(CANVAS), "--device", dev.type]
    try:
        with tempfile.TemporaryDirectory(prefix="dsnt_cli_") as tmp:
            tmp = Path(tmp)
            exp_dir = tmp / "cli"
            # 1. Train: one epoch of 4 resident steps in one dispatch.
            counted("train", lambda: train_cli.main(
                CLI_MODEL + ["--batch-size", str(BATCH), "--epochs", "1",
                             "--device-resident", "on", "--steps-per-dispatch", "4",
                             "--out-dir", str(tmp), "--experiment-id", "cli"] + data))
            for name in ("config.json", "metrics.jsonl"):
                assert (exp_dir / name).exists(), name
            assert_cli_flagship(config_from_json((exp_dir / "config.json").read_text()))
            assert os.listdir(exp_dir / "ckpt") == ["0"]
            with open(exp_dir / "metrics.jsonl") as f:
                summary = [r for r in map(json.loads, f) if "step" not in r][-1]
            final = printed["train"][-1]
            assert final == f"done; best val PCKh@0.5 = {100 * summary['val_pckh']:.2f}", final
            assert "device_resident=on: staging train split" in "\n".join(printed["train"])

            # 2. Round trip: evaluate with no flip and no scales.
            model_dir = ["--model-dir", str(exp_dir)]
            counted("evaluate", lambda: evaluate_cli.main(model_dir + data))
            single = drivers[-1]
            eval_pckh = single.result["pckh"]
            if eval_pckh != summary["val_pckh"]:
                raise AssertionError(f"evaluate's PCKh {single.result['pckh']} "
                                     f"!= the train run's {summary['val_pckh']}")

            # 3. Flip and 3 scales, then its eval step against the same
            # step with the head's and row_shift's plain versions.
            flip_args = ["--flip-eval", "--eval-scales", CLI_SCALES]
            counted("evaluate_flip_scales",
                    lambda: evaluate_cli.main(model_dir + flip_args + data))
            flip = drivers[-1]
            assert flip.cfg.train.flip_eval and flip.cfg.train.eval_scales == (0.9, 1.0, 1.1)
            batch = to_device(next(flip.loader.epoch(0)), dev)
            with recording_row_shift([]) as shift_calls:
                out = flip.eval_step(batch)
            kernels.reset_launch_counts()
            with plain_head(), plain_row_shift():
                ref = flip.eval_step(batch)
            torch.cuda.synchronize()
            assert not any(kernels.launch_counts().values()), kernels.launch_counts()
            loss_rel = abs(out["loss"].item() - ref["loss"].item()) / abs(ref["loss"].item())
            pred_err = (out["pred_orig"] - ref["pred_orig"]).abs().max().item()
            if (loss_rel > STEP_TOL["loss_rtol"]
                    or pred_err > STEP_TOL["pred_orig_atol_px"]
                    or not torch.equal(out["pckh_correct"], ref["pckh_correct"])):
                raise AssertionError(f"flip x 3 scales eval step vs plain: loss rel "
                                     f"{loss_rel}, pred_orig max err {pred_err} px")
            assert len(shift_calls) == 6
            # Calls 2-3 are scale 0.9's, 4-5 scale 1.1's (scale 1.0 is the
            # canonical pass, calls 0-1).
            shift_shapes = assert_row_shift_bitwise("cli", shift_calls[2:])

            # 4. Infer with flip and 3 scales into a .mat (no h5py here).
            mat = tmp / "preds.mat"
            counted("infer_flip_scales", lambda: infer_cli.main(
                model_dir + flip_args + ["--preds-file", str(mat)] + data))
            preds = loadmat(mat)["preds"]
            assert preds.shape == (val_rows, 16, 2) and np.isfinite(preds).all(), preds.shape
            infer_err = float(np.abs(preds - out["pred_orig"].cpu().numpy()).max())
            assert infer_err <= 1e-3, infer_err

            # 6. Times: the eval step with flip x 3 scales against the
            # single pass, in turns; predict's img/s.
            single_ms = timing.time_ms(lambda: single.eval_step(batch), spread=True)
            flip_ms = timing.time_ms(lambda: flip.eval_step(batch), spread=True)
            single_ms_2 = timing.time_ms(lambda: single.eval_step(batch), spread=True)
            flip_ms_2 = timing.time_ms(lambda: flip.eval_step(batch), spread=True)
            infer_driver = drivers[-1]
            predict_s = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                infer_driver.predict()
                predict_s.append(time.perf_counter() - t0)
            train_rows = synth(CLI_ROWS, canvas_size=CANVAS, seed=1)
            del drivers[:], single, flip, infer_driver, batch, out, ref
            gc.collect()
            torch.cuda.empty_cache()

            # 5. Auto-pack: 2 epochs of the flagship over a decode-backed
            # stand-in of the train rows (uint8 canvases, as a decoder
            # gives): epoch 0 streams and writes, epoch 1 trains resident.
            source = {**train_rows, "canvases": np.round(
                train_rows["canvases"] * 255.0).astype(np.uint8)}
            ap_cfg = trainer_config()
            ap_cfg = dataclasses.replace(
                ap_cfg, data=dataclasses.replace(ap_cfg.data,
                                                 data_dir=str(tmp / "data")),
                train=dataclasses.replace(ap_cfg.train, epochs=CLI_AUTOPACK_EPOCHS))
            boundary = []
            trainer = Trainer(
                model=build_pose_model(ap_cfg.model, device=dev, seed=0),
                cfg=ap_cfg, device=dev,
                train_loader=ShardedLoader(DecodeBackedStandIn(source), BATCH,
                                           shuffle=True, seed=ap_cfg.train.seed,
                                           workers=4),
                metric_writer=MetricWriter(str(tmp / "autopack"), echo=False),
                hooks=(lambda e, st, summ: boundary.append(
                    (st.step, st.optimizer.count, summ["images_per_sec"])),))
            assert trainer._autopack is not None and trainer.resident is None
            optimizer = trainer.state.optimizer
            state, _ = counted("autopack", trainer.run)
            assert isinstance(trainer.train_loader.dataset, PackedDataset)
            assert trainer.resident is not None and trainer.resident_multi is not None
            assert trainer.resident_multi.state is state is trainer.train_step.state
            assert state.optimizer is optimizer
            assert [b[:2] for b in boundary] == [(4, 4), (8, 8)], boundary
            rms_steps = {int(st["step"]) for st in optimizer.optimizer.state.values()}
            assert rms_steps == {8}, rms_steps
            packed = trainer.train_loader.dataset
            archive_equal = bool(np.array_equal(packed.canvases, source["canvases"]) and all(
                np.array_equal(packed.meta[k], source[k]) for k in packed.meta))
            assert archive_equal, "the auto-packed archive differs from its source"
            del trainer, state, optimizer, packed
    finally:
        common.make_synthetic_mpii, evaluate_cli.EvalDriver, infer_cli.EvalDriver = saved
    t0 = time.perf_counter()
    native_built = native.available()
    native_s = time.perf_counter() - t0
    emit("cli", card=card, config=" ".join(CLI_MODEL), batch=BATCH, canvas=CANVAS,
         rows={"train": CLI_ROWS, "val": val_rows},
         launches=launches, wall_seconds=walls,
         train={"final_line": final, "epoch_images_per_sec": summary["images_per_sec"],
                "val_pckh": summary["val_pckh"], "val_loss": summary["val_loss"]},
         evaluate={"pckh": eval_pckh, "round_trip_equal": True},
         flip_scales_vs_plain={"loss_rel_diff": loss_rel,
                               "pred_orig_max_diff_px": pred_err,
                               "pckh_counts_equal": True, "tolerance": STEP_TOL,
                               "row_shift_bitwise_shapes": shift_shapes},
         infer={"preds_shape": list(preds.shape), "vs_evaluate_max_diff_px": infer_err},
         eval_step_ms={"single": single_ms[0], "flip_x3_scales": flip_ms[0],
                       "single_again": single_ms_2[0], "flip_x3_scales_again": flip_ms_2[0],
                       "spread_min_max": {"single": single_ms[1:],
                                          "flip_x3_scales": flip_ms[1:]}},
         eval_step_img_per_s={"single": BATCH / single_ms[0] * 1e3,
                              "flip_x3_scales": BATCH / flip_ms[0] * 1e3},
         predict_img_per_s=[val_rows / t for t in predict_s],
         autopack={"epochs": CLI_AUTOPACK_EPOCHS, "step_count_at_boundaries":
                   [b[:2] for b in boundary],
                   "epoch_images_per_sec": [b[2] for b in boundary],
                   "archive_bitwise_equal": archive_equal},
         native_decoder_built=native_built, native_build_seconds=native_s,
         clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu"))
    total = {}
    for counts in launches.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def main():
    card = phase_device()
    dev = torch.device("cuda")
    phase_build()
    # The calibration first: its copy rate is the ceiling the other kernels'
    # rates are stated against.
    calib_errs = phase_calib_vs_plain(dev)
    calib_times, ceiling = phase_calibration(card)
    phase_head_vs_plain(dev)
    bwd_err = phase_head_bwd_vs_plain(dev)
    run = phase_serve(dev)
    head = phase_head_on_main_path(run, ceiling)
    emit("dsnt_head_fwd_times", card=card, **head)
    phase_times(run, card)
    phase_profile(run, card)
    serve_launches = run["launches"]
    recorded = {"serve": run["row_shift_calls"]}
    del run
    torch.cuda.empty_cache()
    train = phase_train(dev, card)
    train_launches = train["launches"]
    train_img_per_s = train["train_img_per_s"]
    recorded["train"] = train["row_shift_calls"]
    bwd = phase_head_bwd_on_main_path(train, card)
    bwd["max_abs_err"] = max(bwd["max_abs_err"], bwd_err)
    emit("dsnt_head_bwd_times", card=card, **bwd)
    shift_err, shift_legacy = phase_row_shift_vs_plain(recorded)
    shift, shift_lib_err = phase_row_shift_timing(recorded, ceiling)
    emit("row_shift_times", card=card, by_path=shift, library_err=shift_lib_err,
         ceiling_GB_per_s=ceiling)
    del train, recorded
    torch.cuda.empty_cache()
    bench_launches = phase_kernel_bench(card)
    for name, n in phase_bench(card).items():
        bench_launches[name] += n
    trainer_launches = phase_trainer(dev, card, train_img_per_s)
    cli_launches = phase_cli(dev, card)
    resnet = phase_resnet(dev, card, ceiling)
    heads_launches = phase_heads(dev, card)
    paths = {"serve": serve_launches, "train": train_launches,
             "bench": bench_launches, "trainer": trainer_launches,
             "cli": cli_launches, "resnet": resnet["launches"],
             "heads": heads_launches}

    def launches(name):
        by_path = {p: counts.get(name, 0) for p, counts in paths.items()}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    def frac_of_ceiling(nbytes, ms):
        return nbytes / ms / 1e6 / ceiling

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def at_56(r):   # the ResNet-50 2x path's 512 rows of 56x56
        return {k: r[k] for k in (*keys, "rows", "layout", "frac_of_ceiling")}

    head_bytes = sum(c["bytes"] for c in head["per_call"].values())
    shift_bytes = sum(c["bytes"] for c in shift["serve"]["per_call"].values())
    entries = [
        {"name": "dsnt_head_fwd", "route": "cuda",
         "source": "dsnt_pose2d_tpu_torch/ops/cuda/dsnt_head.cu",
         "replaces": "dsnt_pose2d_tpu/ops/pallas/dsnt_head.py:184",
         **launches("dsnt_head_fwd"),
         "max_abs_err": max(head["max_abs_err"], resnet["fwd"]["max_abs_err"]),
         **{k: head[k] for k in keys},
         "frac_of_ceiling": frac_of_ceiling(head_bytes, head["ms"]),
         "at_56x56": at_56(resnet["fwd"])},
        {"name": "dsnt_head_bwd", "route": "cuda",
         "source": "dsnt_pose2d_tpu_torch/ops/cuda/dsnt_head.cu",
         "replaces": "dsnt_pose2d_tpu/ops/pallas/dsnt_head.py:213",
         **launches("dsnt_head_bwd"),
         "max_abs_err": max(bwd["max_abs_err"], resnet["bwd"]["max_abs_err"]),
         **{k: bwd[k] for k in keys}, "layout": bwd["layout"],
         "frac_of_ceiling": frac_of_ceiling(bwd["bytes"], bwd["ms"]),
         "at_56x56": at_56(resnet["bwd"])},
        # ms and the other times: the two calls of one serve step; those of
        # one train step are under by_path.
        {"name": "row_shift", "route": "cuda",
         "source": "dsnt_pose2d_tpu_torch/ops/cuda/row_shift.cu",
         "replaces": "dsnt_pose2d_tpu/ops/pallas/row_shift.py:57",
         **launches("row_shift"), "max_abs_err": shift_err,
         **{k: shift["serve"][k] for k in keys},
         "by_path": {p: {k: v[k] for k in keys}
                     for p, v in {**shift, **resnet["row_shift"]}.items()},
         "legacy_check": shift_legacy,
         "frac_of_ceiling": frac_of_ceiling(shift_bytes, shift["serve"]["ms"])},
    ]
    for kind, line in (("copy", 247), ("exp", 250), ("smax", 253)):
        t = calib_times[kind]
        entries.append(
            {"name": f"calib_{kind}", "route": "cuda",
             "source": "dsnt_pose2d_tpu_torch/ops/cuda/calib.cu",
             "replaces": f"bench_kernel.py:{line}",
             **launches(f"calib_{kind}"), "max_abs_err": calib_errs[kind],
             **{k: t[k] for k in keys},
             "frac_of_ceiling": frac_of_ceiling(t["bytes"], t["ms"])})
    for e in entries:
        for k in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            assert math.isfinite(e[k]), (e["name"], k)
        assert e["launches"] > 0, e["name"]
    for e in entries[3:]:
        assert math.isfinite(e["library_ms"]), e["name"]
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
