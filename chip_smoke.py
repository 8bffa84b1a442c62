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
eval pass held against the resident one.

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


def phase_row_shift_vs_plain(recorded):
    """row_shift against its plain version, bitwise, at every shape that the
    main path's counted runs gave it: on the inputs the path gave it, and on
    random rows, starts and fracs of the same shape (the eval crop has no
    shear, so its fracs are 0; random ones exercise the lerp)."""
    from dsnt_pose2d_tpu_torch.ops.cuda import shift_rows, shift_rows_reference

    checked = {}
    for path, calls in recorded.items():
        for i, (shape, call) in enumerate(calls.items()):
            for inputs in (call, random_row_shift_inputs(call, seed=i)):
                rows, starts, fracs, out, stride = inputs
                got = shift_rows(rows, starts, fracs, out, stride=stride)
                exp = shift_rows_reference(rows, starts, fracs, out, stride=stride)
                torch.cuda.synchronize()
                if not torch.equal(got, exp):
                    raise AssertionError(
                        f"row_shift {path} {shape} differs from its plain "
                        f"version: max {(got - exp).abs().max().item()}")
            checked.setdefault(path, []).append(list(shape))
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
def recording_row_shift(calls: dict):
    """The shear warp's row_shift calls pass on to the kernel; the first
    call of each ``(rows, row length, out length)`` is kept in ``calls``
    as ``(rows, starts, fracs, out, stride)``."""
    from dsnt_pose2d_tpu_torch.data import augment

    kernel = augment.shift_rows

    def record(rows, starts, fracs, out, stride=1):
        key = (*rows.shape, out)
        if key not in calls:
            with torch.inference_mode(False):   # plain tensors, not inference ones
                calls[key] = (rows.clone(), starts.clone(), fracs.clone(), out,
                              stride)
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


def synthetic_batch(dev):
    from dsnt_pose2d_tpu_torch.data.synthetic import make_synthetic_mpii

    data = make_synthetic_mpii(BATCH, CANVAS, seed=0)
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


def temper_scores(net, images, target_std=HEATMAP_STD, train=False):
    """Scales each stack's score conv so its heatmap logits have std
    ``target_std`` on these images, in eval or train mode, stack by stack (a
    stack's scores feed the next stack through ``score_back``).  The BN
    running statistics are left as they were.

    The random-init hg8's residual sums grow from stack to stack, to logits
    of std ~1e5-1e6 at the last one in eval mode, where every softmax row is
    one-hot; train-mode BN renormalises them, to a nearly uniform softmax.
    Tempered, the main path drives the head on real softmax rows."""
    hg = net.backbone
    buffers = {k: v.clone() for k, v in net.named_buffers()}
    net.train(train)
    with torch.no_grad():
        for i in range(hg.num_stacks):
            conv = getattr(hg, f"score{i}")
            scale = target_std / net(images)[i].std().item()
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
        heatmaps = model.forward(pre["images"])
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
    from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
    from dsnt_pose2d_tpu_torch.ops import cuda as kernels
    from dsnt_pose2d_tpu_torch.train.loop import make_train_fn

    cfg, model = build_flagship(dev)
    assert cfg.optim.optimizer == "rmsprop" and cfg.data.max_rotation_deg > 0
    batch = synthetic_batch(dev)
    pre_args = (batch["canvases"], batch["coords_px"], batch["mask"],
                batch["head_length"], batch["canvas_from_orig"])
    with torch.no_grad():
        images = preprocess_batch(*pre_args, cfg.data, model.input_size,
                                  canvas_margin=batch["canvas_margin"])["images"]
    temper_scores(model.net, images, train=True)
    start = {k: v.clone() for k, v in model.net.state_dict().items()}

    grab = {"on": False, "heat": [], "dheat": []}

    def capture(module, inputs, heatmaps):
        # The first step's heatmaps and dL/dheatmaps at the head.
        if grab["on"]:
            grab["heat"].append(heatmaps.detach().clone())
            heatmaps.register_hook(lambda g: grab["dheat"].append(g.detach().clone()))

    model.net.register_forward_hook(capture)
    train_step = make_train_fn(model, cfg, device=dev)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    metrics = []
    with recording_row_shift({}) as row_shift_calls:
        for i in range(STEPS):
            grab["on"] = i == 0
            metrics.append(train_step(batch))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    expected = {**dict.fromkeys(launches, 0), "dsnt_head_fwd": STEPS,
                "dsnt_head_bwd": STEPS, "row_shift": 2 * STEPS}
    if launches != expected:
        raise AssertionError(f"train launches {launches}, expected {expected}")
    losses = [m["loss"].item() for m in metrics]
    assert all(math.isfinite(v) and v > 0 for v in losses), losses
    assert train_step.state.step == STEPS

    # The same first step with both plain versions forced, same weights and
    # draws (the draws are a function of (seed, step) only).
    plain_model = build_pose_model(cfg.model, device=dev, seed=0)
    plain_model.net.load_state_dict(start)
    plain_model.net.register_forward_hook(capture)
    plain_step = make_train_fn(plain_model, cfg, device=dev)
    grab["on"] = True
    kernels.reset_launch_counts()
    with plain_head(), plain_row_shift():
        ref = plain_step(batch)
    torch.cuda.synchronize()
    grab["on"] = False
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
    max_prob = torch.softmax(grab["heat"][0][-1].flatten(2), -1).amax(-1).mean()
    emit("train_step", config=str(CONFIG.relative_to(ROOT)), batch=BATCH,
         canvas=CANVAS, steps=STEPS, launches=launches, losses=losses,
         grad_norms=[m["grad_norm"].item() for m in metrics],
         euclidean=first["euclidean"].item(), reg=first["reg"].item(),
         heatmap_logit_std=grab["heat"][0].std().item(),
         last_stack_mean_max_prob=max_prob.item(),
         plain_path={"loss": ref["loss"].item(), "loss_rel_diff": loss_rel,
                     "heatmaps_bitwise_equal": heat_equal,
                     "dheat_max_diff": dheat_err, "dheat_rel_to_max": dheat_rel,
                     "grad_norm": ref["grad_norm"].item(),
                     "grad_norm_rel_diff": norm_rel},
         tolerance=TRAIN_TOL)

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
    return {"cfg": cfg, "batch": batch, "pre_args": pre_args, "launches": launches,
            "train_img_per_s": BATCH / step_ms[0] * 1e3,
            "profile_instances": instances,
            "row_shift_calls": row_shift_calls,
            "heat": grab["heat"][0], "dheat": dheat, "model": model}


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
    paths = {"serve": serve_launches, "train": train_launches,
             "bench": bench_launches, "trainer": trainer_launches}

    def launches(name):
        by_path = {p: counts[name] for p, counts in paths.items()}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    def frac_of_ceiling(nbytes, ms):
        return nbytes / ms / 1e6 / ceiling

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    head_bytes = sum(c["bytes"] for c in head["per_call"].values())
    shift_bytes = sum(c["bytes"] for c in shift["serve"]["per_call"].values())
    entries = [
        {"name": "dsnt_head_fwd", "route": "cuda",
         "source": "dsnt_pose2d_tpu_torch/ops/cuda/dsnt_head.cu",
         "replaces": "dsnt_pose2d_tpu/ops/pallas/dsnt_head.py:184",
         **launches("dsnt_head_fwd"), "max_abs_err": head["max_abs_err"],
         **{k: head[k] for k in keys},
         "frac_of_ceiling": frac_of_ceiling(head_bytes, head["ms"])},
        {"name": "dsnt_head_bwd", "route": "cuda",
         "source": "dsnt_pose2d_tpu_torch/ops/cuda/dsnt_head.cu",
         "replaces": "dsnt_pose2d_tpu/ops/pallas/dsnt_head.py:213",
         **launches("dsnt_head_bwd"), "max_abs_err": bwd["max_abs_err"],
         **{k: bwd[k] for k in keys}, "layout": bwd["layout"],
         "frac_of_ceiling": frac_of_ceiling(bwd["bytes"], bwd["ms"])},
        # ms and the other times: the two calls of one serve step; those of
        # one train step are under by_path.
        {"name": "row_shift", "route": "cuda",
         "source": "dsnt_pose2d_tpu_torch/ops/cuda/row_shift.cu",
         "replaces": "dsnt_pose2d_tpu/ops/pallas/row_shift.py:57",
         **launches("row_shift"), "max_abs_err": shift_err,
         **{k: shift["serve"][k] for k in keys},
         "by_path": {p: {k: v[k] for k in keys} for p, v in shift.items()},
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
