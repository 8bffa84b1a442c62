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
``cli.train`` -> ``cli.evaluate``).  Then the ViT: ``vit``
(``configs/vit_s16_dsnt_2x.json``: ViT-S/16 at 448 px, driven and held as
the ResNet-50 2x model, then its train step with remat against the same
step without, ``vit_remat``), ``remat`` (the flagship hg8 train step with
remat against without: losses and BN statistics bitwise, peak memory and
step time of each), ``telemetry`` (``cli.train`` on the ViT in a
process of its own with ``--profile-dir``, ``--dashboard-port`` and
``--debug-nans``, and a NaN train step that must raise), ``dp``, data
parallelism: ``cli.train`` on the flagship under
``torch.distributed.run --nproc_per_node=1`` (NCCL, world size 1) against
the same run without a launcher, bitwise; then two ranks sharing the card
over gloo against one process on the same global batch (bf16 hg8, 3
steps; fp32 hg2 at the flagship's widths, an eval pass, ``predict`` and a
step), the ranks bitwise equal to each other and held relative to
one-process runs of the same math in other orders, each rank's head and
row_shift calls held against their plain versions; and last ``tp``,
tensor parallelism: two ranks sharing the card over gloo at
``model_parallel`` 2 (fp32 hg2 at the flagship's widths, 8 rows), each
holding its shards of the model, against one process the same way, with
each rank's shard shapes, its replicated leaves against the other rank's,
the bytes it holds and the model-axis collectives of a step.  Last,
``tools``: the experiment drivers of ``dsnt_pose2d_tpu_torch/tools/`` over
the CLIs' synthetic fallback: the heads grid (hg2, dsnt+JS, gauss, fc) as
``python -m``, the resolution grid's dsnt cells (ResNet-34, dilate 0/1/2:
7x7, 14x14, 28x28 maps) and the flagship report in this process with
their launches counted, the sweep's b16 and b64_nopallas rows,
bench_infer and profile_step; then each resolution cell's checkpoint
through its eval and train steps against the plain path, and the head's
kernels at its map held, timed and their layouts named.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

(``--dp-rank <dir>`` and ``--dp-cli <flags>`` are the ``dp`` phase's own
child processes, ``--tp-rank <dir>`` the ``tp`` phase's, ``--head-layouts
<shapes>`` the ``tools`` phase's.)

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
CANVAS_448 = 672          # the canvas rule's 1.5x of a 448-px input
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
# The vit phase: BASELINE config #5's ViT-S/16 as its file gives it (384
# wide, 12 blocks, 6 heads, 448 px: 56x56 heatmaps), as the resnet phase;
# then its train step with remat on the same weights, batch and draws.
VIT_CONFIG = ROOT / "configs" / "vit_s16_dsnt_2x.json"
# The telemetry phase: cli.train on that config in a process of its own,
# with --profile-dir, --dashboard-port and --debug-nans, on 64 synthetic
# rows (2 train steps an epoch, 16 val rows), 2 epochs.
# remat against no remat: each step's median over this many windows, one
# turn each (the hg8 step takes ~0.6-0.8 s).
REMAT_REPS = 5              # timed windows each way (the dp phase runs after)
TELEMETRY_ROWS = 64
TELEMETRY_TIMEOUT_S = 300
TELEMETRY_KERNELS = ("dsnt_head_fwd", "dsnt_head_bwd", "row_shift")


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


def compare_head(raw, t, reg, preact, threshold=0.5, sigma_px=1.0):
    from dsnt_pose2d_tpu_torch.ops.cuda import (fused_dsnt_head,
                                                fused_dsnt_head_reference)

    kw = dict(sigma_px=sigma_px, reg=reg, preact=preact, threshold=threshold)
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
def recording_head(calls):
    """The heads' fused-head calls pass on to the kernels; the first call of
    each input shape, with and without autograd, is kept in ``calls`` as
    ``{"raw", "t", "kw", "gc", "gr"}``: its inputs and, once the backward
    pass has run, the cotangents of its coords and regularizer."""
    from dsnt_pose2d_tpu_torch.models import heads

    kernel = heads.fused_dsnt_head

    def keep(call, name):
        def hook(g):
            call[name] = g.detach().clone()
        return hook

    def record(raw, t=None, **kw):
        coords, reg = kernel(raw, t, **kw)
        key = (*raw.shape, coords.requires_grad)
        if key not in calls:
            call = calls[key] = {"raw": raw.detach().clone(), "kw": kw,
                                 "t": None if t is None else t.detach().clone(),
                                 "gc": None, "gr": None}
            if coords.requires_grad:
                coords.register_hook(keep(call, "gc"))
            if reg is not None and reg.requires_grad:
                reg.register_hook(keep(call, "gr"))
        return coords, reg

    heads.fused_dsnt_head = record
    try:
        yield calls
    finally:
        heads.fused_dsnt_head = kernel


@contextlib.contextmanager
def plain_row_shift():
    """The shear warp with row_shift's plain version in place of its kernel."""
    from dsnt_pose2d_tpu_torch.data import augment

    with augment.plain_row_shift():
        yield


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
    a regularizer) at batch 32 on 672-px canvases: :func:`drive_448px`."""
    from dsnt_pose2d_tpu_torch.utils.config import config_from_json

    cfg = config_from_json(RESNET_CONFIG.read_text())
    m = cfg.model
    assert (m.base, m.dilate, m.truncate, m.resolved_input_size, m.dtype,
            m.output_strat, m.preact, m.reg, m.use_pallas) == (
        "resnet50", 2, 0, 448, "bfloat16", "dsnt", "softmax", "none", True), m
    out = drive_448px("resnet", RESNET_CONFIG, cfg, dev, card, ceiling)
    del out["model"], out["batch"]
    gc.collect()
    torch.cuda.empty_cache()
    return out


def drive_448px(phase, path, cfg, dev, card, ceiling):
    """A config #5 model (56x56 heatmaps, DSNT without a regularizer) from
    seed 0 at batch 32 on 672-px canvases: the eval and infer steps and the
    train step, counted and held against their plain paths, timed, peak
    memory and a profiled train step whose head backward must be
    StagedRow; the head at 512 rows of 56x56 (forward AnyMap, backward
    StagedRow) and row_shift at the 448-px calls, held and timed on the
    path's inputs.  Returns the launches and readings, and the model (its
    weights after the timed steps) and the batch."""
    from dsnt_pose2d_tpu_torch.bench import timing
    from dsnt_pose2d_tpu_torch.data.augment import preprocess_batch
    from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
    from dsnt_pose2d_tpu_torch.ops import cuda as kernels
    from dsnt_pose2d_tpu_torch.ops import euclidean_losses
    from dsnt_pose2d_tpu_torch.ops.cuda import fused_dsnt_head
    from dsnt_pose2d_tpu_torch.train.loop import make_eval_fn, make_infer_fn

    gc.collect()
    torch.cuda.empty_cache()
    m = cfg.model
    assert cfg.data.warp_method == "shear" and cfg.train.batch_size == BATCH
    model = build_pose_model(m, device=dev, seed=0)
    side = model.heatmap_size
    assert side == 56, side
    batch = synthetic_batch(dev, CANVAS_448)
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
        raise AssertionError(f"{phase} serve launches {serve_launches}, "
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
    instances = profile_step(f"{phase}_train_step", lambda: train_step(batch),
                             train_ms[0], card)
    if bwd_layouts(instances) != {"StagedRow"}:
        raise AssertionError(f"the {phase} train step's head backward ran in "
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

    recorded = {f"{phase}_serve": {(*c[0].shape, c[3]): c for c in serve_calls[:2]},
                f"{phase}_train": {(*c[0].shape, c[3]): c
                                   for c in train["row_shift_calls"][:2]}}
    shapes = {p: assert_row_shift_bitwise(p, list(calls.values()))
              for p, calls in recorded.items()}
    shift, shift_lib_err = phase_row_shift_timing(recorded, ceiling)
    launches = {k: serve_launches[k] + train["launches"][k] for k in serve_launches}
    emit(phase, card=card, config=str(path.relative_to(ROOT)),
         batch=BATCH, canvas=CANVAS_448, heatmap_side=side, steps=STEPS,
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
    del eval_step, infer_step, train, train_step
    return {"launches": launches, "fwd": fwd, "bwd": bwd, "row_shift": shift,
            "max_row_shift_err": 0.0, "train_ms": train_ms[0],
            "train_peak": train_peak, "model": model, "batch": batch}




def phase_vit(dev, card, ceiling):
    """BASELINE config #5's ViT-S/16 (448 px, bf16, DSNT without a
    regularizer) at batch 32 on 672-px canvases: :func:`drive_448px`, then
    the train step with remat against the same step without it."""
    from dsnt_pose2d_tpu_torch.utils.config import config_from_json

    cfg = config_from_json(VIT_CONFIG.read_text())
    m = cfg.model
    assert (m.base, m.resolved_input_size, m.dtype, m.output_strat, m.preact,
            m.reg, m.use_pallas) == (
        "vit_s16", 448, "bfloat16", "dsnt", "softmax", "none", True), m
    assert not m.remat
    out = drive_448px("vit", VIT_CONFIG, cfg, dev, card, ceiling)
    model, batch = out.pop("model"), out.pop("batch")
    state = {k: v.clone() for k, v in model.net.state_dict().items()}
    del model
    out["remat"] = remat_vs_no_remat("vit_remat", cfg, state, batch, dev, card)
    return out


def remat_vs_no_remat(phase, cfg, state, batch, dev, card):
    """One train step of ``cfg`` without remat and one with it, each from
    the weights ``state`` on ``batch`` with the draws of step 0, cuDNN's
    deterministic algorithms on: the launches asserted (a head forward and
    backward, two row_shift), the losses bitwise equal, the BN running
    statistics after the step bitwise equal (they moved once with remat
    too), the gradients' norms within TRAIN_TOL; then each step's peak
    memory and its median time over REMAT_REPS windows."""
    import dataclasses

    from dsnt_pose2d_tpu_torch.bench import timing
    from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
    from dsnt_pose2d_tpu_torch.ops import cuda as kernels
    from dsnt_pose2d_tpu_torch.train.loop import make_train_fn

    gc.collect()
    torch.cuda.empty_cache()
    expected = {"dsnt_head_fwd": 1, "dsnt_head_bwd": 1, "row_shift": 2}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs, launches = {}, {}
        for remat in (False, True):
            mcfg = dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, remat=remat))
            model = build_pose_model(mcfg.model, device=dev, seed=0)
            model.net.load_state_dict(state)
            step = make_train_fn(model, mcfg, device=dev)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            metrics = step(batch)
            torch.cuda.synchronize()
            got = kernels.launch_counts()
            if got != {**dict.fromkeys(got, 0), **expected}:
                raise AssertionError(f"{phase} remat={remat} launches {got}, "
                                     f"expected {expected}")
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
            runs[remat] = {
                "step": step, "loss": metrics["loss"].clone(),
                "grad_norm": metrics["grad_norm"].item(),
                "grads": {n: p.grad.clone() for n, p in model.net.named_parameters()},
                "stats": {k: v.clone() for k, v in model.net.state_dict().items()
                          if "running" in k}}
        off, on = runs[False], runs[True]
        loss_equal = torch.equal(on["loss"], off["loss"])
        stats_equal = all(torch.equal(on["stats"][k], v)
                          for k, v in off["stats"].items())
        norm_rel = abs(on["grad_norm"] - off["grad_norm"]) / off["grad_norm"]
        gmax = max(g.abs().max().item() for g in off["grads"].values())
        grad_diff = max((on["grads"][n] - g).abs().max().item()
                        for n, g in off["grads"].items())
        if not (loss_equal and stats_equal and norm_rel <= TRAIN_TOL["grad_norm_rtol"]):
            raise AssertionError(
                f"{phase}: remat against no remat: loss equal {loss_equal} "
                f"({on['loss'].item()} vs {off['loss'].item()}), BN "
                f"statistics equal {stats_equal}, grad norm rel {norm_rel}")
        for run in (off, on):
            del run["grads"]
        times, peaks = {}, {}
        for remat in (False, True):
            times[remat] = timing.time_ms(lambda: runs[remat]["step"](batch),
                                          spread=True, reps=REMAT_REPS)
            peaks[remat] = peak_memory(lambda: runs[remat]["step"](batch))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    median = {r: t[0] for r, t in times.items()}
    emit(phase, card=card, batch=BATCH, base=cfg.model.base,
         cudnn_deterministic=True, launches=launches,
         loss={"no_remat": off["loss"].item(), "remat": on["loss"].item(),
               "bitwise_equal": loss_equal},
         bn_running_stats={"count": len(off["stats"]), "bitwise_equal": stats_equal},
         grad_norm={"no_remat": off["grad_norm"], "remat": on["grad_norm"],
                    "rel_diff": norm_rel, "tolerance": TRAIN_TOL["grad_norm_rtol"]},
         grads_max_diff=grad_diff, grads_max_diff_rel_to_max=grad_diff / gmax,
         step_ms={"no_remat": median[False], "remat": median[True]},
         timed_windows=REMAT_REPS,
         spread_min_max_ms={"no_remat": times[False][1:], "remat": times[True][1:]},
         remat_time_ratio=median[True] / median[False],
         peak_mem_bytes={"no_remat": peaks[False], "remat": peaks[True]},
         remat_peak_mem_ratio=peaks[True] / peaks[False],
         clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu"))
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_remat(dev, card):
    """The flagship (hg8) train step with remat=True against remat=False
    (:func:`remat_vs_no_remat`), from the seed-0 weights on the hg8
    batch."""
    cfg, model = build_flagship(dev)
    state = {k: v.clone() for k, v in model.net.state_dict().items()}
    del model
    return remat_vs_no_remat("remat", cfg, state, synthetic_batch(dev), dev, card)


def phase_telemetry(dev, card):
    """``python -m dsnt_pose2d_tpu_torch.cli.train`` on the ViT config, in a
    process of its own (a fresh profiler: see PROFILE_ATTEMPTS), with
    ``--profile-dir``, ``--dashboard-port`` and ``--debug-nans``, 2 epochs
    on TELEMETRY_ROWS synthetic rows: ``/metrics`` fetched from the
    dashboard while it runs, the trace of epoch 1 naming the head's two
    kernels and row_shift.  Then, in this process, a train step on a NaN
    batch under ``set_debug_nans`` raises ``FloatingPointError``."""
    import socket
    import tempfile
    import urllib.error
    import urllib.request

    from dsnt_pose2d_tpu_torch.data.synthetic import make_synthetic_mpii
    from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
    from dsnt_pose2d_tpu_torch.train import loop
    from dsnt_pose2d_tpu_torch.utils.config import config_from_json

    gc.collect()
    torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="telemetry_") as tmp:
        prof_dir = os.path.join(tmp, "prof")
        argv = [sys.executable, "-m", "dsnt_pose2d_tpu_torch.cli.train",
                "--config", str(VIT_CONFIG), "--data-source", "synthetic",
                "--synthetic-size", str(TELEMETRY_ROWS), "--canvas-size",
                str(CANVAS_448), "--epochs", "2", "--out-dir", tmp,
                "--experiment-id", "telemetry", "--profile-dir", prof_dir,
                "--dashboard-port", str(port), "--debug-nans"]
        t0 = time.perf_counter()
        proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        fetched = None
        try:
            while proc.poll() is None and time.perf_counter() - t0 < TELEMETRY_TIMEOUT_S:
                try:
                    body = urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics", timeout=10).read()
                    if b"loss" in body and fetched is None:
                        fetched = body
                except (urllib.error.URLError, OSError):
                    pass
                time.sleep(0.2)
            out, _ = proc.communicate(timeout=max(
                1.0, TELEMETRY_TIMEOUT_S - (time.perf_counter() - t0)))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        wall = time.perf_counter() - t0
        lines = out.splitlines()
        if proc.returncode != 0:
            raise AssertionError(f"cli.train with telemetry exited "
                                 f"{proc.returncode}:\n" + "\n".join(lines[-30:]))
        if fetched is None:
            raise AssertionError("the dashboard served no metrics while the run lasted")
        records = [json.loads(x) for x in fetched.decode().splitlines() if x.strip()]
        trace_path = os.path.join(prof_dir, "epoch1.pt.trace.json")
        trace_bytes = os.path.getsize(trace_path)
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        names = [e.get("name", "") for e in events]
        kernels_named = {k: sum(1 for n in names if re.search(rf"\b{k}_kernel\b", n))
                         for k in TELEMETRY_KERNELS}
        if not all(kernels_named.values()):
            raise AssertionError(f"the telemetry trace names the kernels "
                                 f"{kernels_named}")
        assert os.listdir(prof_dir) == ["epoch1.pt.trace.json"]
        done = [x for x in lines if x.startswith("done; best val PCKh@0.5")]
        assert len(done) == 1 and f"dashboard: http://localhost:{port}/" in lines

    # --debug-nans: a train step on a NaN batch raises before its update.
    cfg = config_from_json(VIT_CONFIG.read_text())
    model = build_pose_model(cfg.model, device=dev, seed=0)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in make_synthetic_mpii(4, CANVAS_448, seed=0).items()}
    batch["canvases"] = torch.full_like(batch["canvases"], float("nan"))
    step = loop.make_train_fn(model, cfg, device=dev)
    loop.set_debug_nans(True)
    try:
        step(batch)
    except FloatingPointError as e:
        nan_error = str(e)
    else:
        raise AssertionError("a NaN train step under debug_nans did not raise")
    finally:
        loop.set_debug_nans(False)
    assert step.state.step == 0 and step.state.optimizer.count == 0
    assert not torch.is_anomaly_enabled()
    emit("telemetry", card=card, config=str(VIT_CONFIG.relative_to(ROOT)),
         rows=TELEMETRY_ROWS, epochs=2, wall_s=wall,
         dashboard={"port": port, "records_fetched": len(records),
                    "first_record": records[0]},
         trace={"file": "epoch1.pt.trace.json", "bytes": trace_bytes,
                "events": len(events), "kernel_events": kernels_named},
         debug_nans={"raised": "FloatingPointError", "message": nan_error[:120]},
         cli_tail=lines[-3:])
    del model, step, batch
    gc.collect()
    torch.cuda.empty_cache()


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


# -- dp: data parallelism ----------------------------------------------------

DP_RANKS = 2
DP_STEPS = 3               # bf16 train steps held rank against rank
DP_VAL_ROWS = 40           # odd over 2 ranks of 16: the streams end in pad rows
DP_FP32_MODEL = {"base": "hg2", "dtype": "float32"}   # the flagship's widths
# Each rank step is held against one process taking the same step on the
# global batch from the same state: the first from the tempered weights,
# each later one from rank 0's parameters, BN statistics and optimizer
# state before it (the trajectories themselves part after the first step:
# RMSProp's first update is about 10 lr sign(g), so wherever rounding
# decided the sign of a gradient element the parameter moves 20 lr apart,
# in any two sound runs).  The ranks' readings are limited relative to
# witnesses, the same one-process step from the same state with the
# batch's rows (and their draws) reversed or permuted: the same math in
# other sum orders.  Each reading (the relative error of the loss and the
# grad norm at every step; in fp32 also the running statistics' worst
# error of their tensor's largest value, the gradients' of the model's
# largest gradient, and the share of updated parameters further than 5% of
# a full RMSProp step, 10 lr, from the reference's) may be at most the
# larger of its floor and DP_WITNESS_FACTOR times the worst witness's.
# The floors are the bounds this phase was first given (bf16 1e-2, PERF.md
# section 2; fp32 loss 1e-5, grad norm 1e-4, statistics 1e-5 of max) and
# tests/test_torch_train_step.py's rule for an fp32 RMSProp step (at most
# 5% of the elements further than 5% of a step).  In fp32 the gradients
# follow the order of the BN statistics' sums (flax's fast variance;
# ROADMAP Queue 3).  The biases whose gradient is 0 in exact arithmetic
# are left out (their fp32 gradient is all noise): the score convs' (a
# softmax is blind to a constant logit) and fc_back's and score_back's (the
# next stack's train-mode BNs remove a constant offset).
DP_ZERO_GRAD = re.compile(r"\.(score|fc_back|score_back)\d+\.bias$")
DP_WITNESSES = {"reversed_rows": np.arange(BATCH)[::-1].copy(),
                "permuted_rows": np.random.default_rng(1).permutation(BATCH),
                "permuted_rows_2": np.random.default_rng(2).permutation(BATCH)}
DP_WITNESS_FACTOR = 3.0
DP_TOL = {"bf16": {"loss_rel": 1e-2, "grad_norm_rel": 1e-2},
          "fp32": {"loss_rel": 1e-5, "grad_norm_rel": 1e-4,
                   "running_stats_err_of_max": 1e-5,
                   "grads_err_of_model_max": 3e-2,
                   "params_share_off_5pct_step": 0.05},
          "witness_factor": DP_WITNESS_FACTOR, "pred_orig_px": 1e-3}
DP_TIMEOUT_S = 420
DP_RANK_DEVICE = "cuda:0"  # both ranks, explicitly
DP_NCCL_LINE = "distributed: backend=nccl world_size=1 device=cuda:0"
DP_CLI = CLI_MODEL + ["--batch-size", str(BATCH), "--epochs", "1",
                      "--data-source", "synthetic", "--canvas-size",
                      str(CANVAS), "--synthetic-size", str(CLI_ROWS),
                      "--device-resident", "on", "--steps-per-dispatch", "4"]


def dp_config(kind):
    import dataclasses

    from dsnt_pose2d_tpu_torch.utils.config import config_from_json

    cfg = config_from_json(CONFIG.read_text())
    if kind == "fp32":
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, **DP_FP32_MODEL))
    return cfg


def dp_digest(net, replicated_only=False) -> str:
    """SHA-256 of every parameter and BN statistic, in state-dict order (the
    leaves no rank holds a shard of, with ``replicated_only``)."""
    import hashlib

    from dsnt_pose2d_tpu_torch.parallel.tp import shard_of

    params = dict(net.named_parameters())
    h = hashlib.sha256()
    for k, v in net.state_dict().items():
        if replicated_only and shard_of(params.get(k)) is not None:
            continue
        h.update(k.encode())
        h.update(v.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_snapshot(state) -> dict:
    """A train state's parameters, BN statistics, optimizer state, step and
    count, on the host."""
    opt = state.optimizer.optimizer.state_dict()
    return {"net": {k: v.detach().cpu().clone()
                    for k, v in state.model.net.state_dict().items()},
            "opt": {"param_groups": opt["param_groups"],
                    "state": {i: {k: v.cpu().clone() if torch.is_tensor(v) else v
                                  for k, v in st.items()}
                              for i, st in opt["state"].items()}},
            "step": state.step, "count": state.optimizer.count}


def dp_restore(state, snap):
    """:func:`dp_snapshot`'s state back into ``state``, in place."""
    state.model.net.load_state_dict(snap["net"])
    state.optimizer.optimizer.load_state_dict(snap["opt"])
    state.step, state.optimizer.count = snap["step"], snap["count"]


def dp_drive(kind, cfg, state_dict, dev, mesh=None, order=None,
             eval_state_dict=None, starts=None, global_batch=BATCH,
             val_rows=DP_VAL_ROWS) -> dict:
    """The dp and tp phases' path for one precision, in one process
    (``mesh`` None) or as one rank: for fp32 without ``order`` first the
    eval pass and ``predict`` over ``val_rows`` rows with
    ``eval_state_dict`` (the weights tempered in eval mode); then train
    steps from ``state_dict`` on this process's rows of the global batch
    (the synthetic batch of ``global_batch`` rows), each followed by a digest of
    the state (of its replicated leaves too); the collectives (in all and
    over the model axis, with their bytes), the gradient all-reduce's
    device time (CUDA events), the step times, the peak memory and the
    bytes of the parameters and the optimizer state this process holds.
    On a mesh with a model axis the model is sharded over it
    (:func:`..parallel.tp.shard_model_`) and the fp32 state and gradients
    come back whole.  A rank runs DP_STEPS (bf16) or 1 (fp32) steps in a row;
    rank 0 keeps a :func:`dp_snapshot` before each step after the first,
    and each rank then holds its head and row_shift calls against their
    plain versions (:func:`dp_kernels_vs_plain`).  One process runs one
    step from each of ``starts`` (None: the state ``state_dict`` gives,
    else a rank's snapshot).  With ``order`` (a witness of DP_WITNESSES):
    the global batch and each step's draws with their rows in that
    order."""
    from dsnt_pose2d_tpu_torch.data.loader import ShardedLoader
    from dsnt_pose2d_tpu_torch.data.mpii import ArrayDataset
    from dsnt_pose2d_tpu_torch.data.synthetic import make_synthetic_mpii
    from dsnt_pose2d_tpu_torch.device import strict_fp32
    from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
    from dsnt_pose2d_tpu_torch.ops import cuda as kernels
    from dsnt_pose2d_tpu_torch.parallel import mesh as pmesh
    from dsnt_pose2d_tpu_torch.parallel import tp
    from dsnt_pose2d_tpu_torch.train import loop
    from dsnt_pose2d_tpu_torch.train import state as tstate

    world, rank = (1, 0) if mesh is None else (mesh.world_size, mesh.rank)
    data, data_index = (1, 0) if mesh is None else (mesh.data_size,
                                                    mesh.data_index)
    if starts is None:
        starts = [None] * (DP_STEPS if kind == "bf16" else 1)
    model = build_pose_model(cfg.model, device=dev, state_dict=state_dict)
    if mesh is not None:
        tp.shard_model_(model.net, mesh)
    out = {"kind": kind, "world": world, "rank": rank,
           "bns": sum(isinstance(m, torch.nn.BatchNorm2d)
                      for m in model.net.modules()),
           "shapes": {k: tuple(p.shape) for k, p in model.net.named_parameters()}}
    heads_seen, shifts_seen = {}, {}
    recording = contextlib.ExitStack()
    if mesh is not None:
        recording.enter_context(recording_head(heads_seen))
        recording.enter_context(recording_row_shift(shifts_seen))
    with strict_fp32() if kind == "fp32" else contextlib.nullcontext(), \
            recording:
        if kind == "fp32" and order is None:
            val = ArrayDataset(make_synthetic_mpii(val_rows, CANVAS, seed=5))
            loader = ShardedLoader(val, global_batch, shuffle=False, drop_last=False,
                                   num_hosts=data, host_id=data_index)
            driver = loop.EvalDriver(
                model=build_pose_model(cfg.model, device=dev,
                                       state_dict=eval_state_dict),
                cfg=cfg, loader=loader, device=dev, mesh=mesh)
            ev = driver.evaluate()
            out["eval"] = {"loss": ev["loss"],
                           "correct": ev["evaluator"].correct.tolist(),
                           "total": ev["evaluator"].total.tolist()}
            out["pred_orig"] = driver.predict()
            out["gidx"] = np.concatenate(loader.global_index_batches(0))
            del driver
        host = make_synthetic_mpii(global_batch, CANVAS, seed=0)

        def draws(i):
            if order is None:
                return None
            rows = torch.as_tensor(order, device=dev)
            return {k: None if v is None else v[rows] for k, v in loop._rank_draws(
                global_batch, cfg, dev, tstate.step_seed(cfg.train.seed, i)).items()}

        if order is not None:
            host = {k: v[order] for k, v in host.items()}
        if mesh is None:
            batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        else:
            batch = pmesh.shard_batch(mesh, host)
        step = loop.make_train_fn(model, cfg, device=dev)
        base_reduce, events = tstate.all_reduce_grads_, []

        def timed_reduce(grads, *args, **kw):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            n = base_reduce(grads, *args, **kw)
            e1.record()
            events.append((e0, e1, n))
            return n

        # On a model axis: the sizes of the convs' gathers and input-
        # gradient sums, replayed after the step (the same all-reduces on
        # zeroed buffers, timed together), so that timing them does not
        # slow the step.
        base_model_reduce, model_sizes = tp._all_reduce, []

        def sized_model_reduce(t, axis):
            model_sizes.append((t.shape, t.dtype))
            base_model_reduce(t, axis)

        def replay_ms() -> float:
            bufs = [torch.zeros(shape, dtype=dt, device=dev)
                    for shape, dt in model_sizes]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in bufs:
                base_model_reduce(b, pmesh.MODEL_AXIS)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        tstate.all_reduce_grads_ = timed_reduce
        if mesh is not None and mesh.model_parallel > 1:
            tp._all_reduce = sized_model_reduce
        rec = {"metrics": [], "digests": [], "replicated_digests": [],
               "collectives": [], "model_collectives": [], "step_ms": [],
               "snapshots": []}
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            for i, start in enumerate(starts):
                if start is not None:
                    dp_restore(step.state, start)
                elif i and rank == 0 and mesh is not None:
                    rec["snapshots"].append(dp_snapshot(step.state))
                pmesh.reset_collective_counts()
                model_sizes.clear()
                t0 = time.perf_counter()
                m = step(batch, draws(step.state.step))
                torch.cuda.synchronize()
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
                rec["collectives"].append(pmesh.collective_counts())
                rec["model_collectives"].append(
                    {"counts": pmesh.collective_counts(pmesh.MODEL_AXIS),
                     "bytes": pmesh.collective_bytes(pmesh.MODEL_AXIS),
                     "gathers_and_grad_sums_replayed_ms":
                         replay_ms() if model_sizes else 0.0})
                rec["metrics"].append({k: v.item() for k, v in m.items()})
                rec["digests"].append(dp_digest(model.net))
                rec["replicated_digests"].append(
                    dp_digest(model.net, replicated_only=True))
            rec["launches"] = kernels.launch_counts()
        finally:
            tstate.all_reduce_grads_ = base_reduce
            tp._all_reduce = base_model_reduce
        rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        rec["grad_all_reduce_ms"] = [e0.elapsed_time(e1) for e0, e1, _ in events]
        rec["grad_buckets"] = [n for _, _, n in events]
        rec["param_bytes"] = sum(p.numel() * p.element_size()
                                 for p in model.net.parameters())
        rec["optimizer_bytes"] = sum(
            v.numel() * v.element_size()
            for st in step.state.optimizer.optimizer.state.values()
            for v in st.values() if torch.is_tensor(v))
        out.update(rec)
        if kind == "fp32":
            out["state"] = {k: v.detach().cpu() for k, v in
                            tp.whole_state_dict(model.net).items()}
            params = dict(model.net.named_parameters())
            cut = [k for k, p in params.items() if tp.shard_of(p) is not None]
            grads = {k: p.grad.detach() for k, p in params.items()}
            if cut:
                grads.update(zip(cut, tp.gather_whole(
                    [(grads[k], params[k].tp) for k in cut])))
            out["grads"] = {k: g.cpu() for k, g in grads.items()}
    if mesh is not None:
        out["kernels_vs_plain"] = dp_kernels_vs_plain(heads_seen, shifts_seen)
    del model, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dp_weights(kind, dev, tmp: Path, rows=BATCH) -> dict:
    """The weights of :func:`dp_config`'s ``kind`` from seed 0, their score
    convs tempered on the first ``rows`` rows of the synthetic batch in
    train mode (``weights``) and, for fp32, in eval mode first
    (``eval_weights``); each saved as ``<kind>_<name>.pt`` under ``tmp``
    for the ranks.  The card is freed after."""
    from dsnt_pose2d_tpu_torch.data.augment import preprocess_batch
    from dsnt_pose2d_tpu_torch.models.factory import build_pose_model

    batch = {k: v[:rows] for k, v in synthetic_batch(dev).items()}
    cfg = dp_config(kind)
    model = build_pose_model(cfg.model, device=dev, seed=0)
    with torch.no_grad():
        images = preprocess_batch(
            batch["canvases"], batch["coords_px"], batch["mask"],
            batch["head_length"], batch["canvas_from_orig"], cfg.data,
            model.input_size, canvas_margin=batch["canvas_margin"])["images"]
    weights = {}
    tempers = (("eval_weights", False),) if kind == "fp32" else ()
    for name, train in (*tempers, ("weights", True)):
        temper_scores(model.net, images, train=train)
        weights[name] = {k: v.detach().cpu().clone()
                         for k, v in model.net.state_dict().items()}
        torch.save(weights[name], tmp / f"{kind}_{name}.pt")
    del model, images, batch
    gc.collect()
    torch.cuda.empty_cache()
    return weights


def dp_kernels_vs_plain(heads_seen, shifts_seen) -> dict:
    """A rank's own kernel calls (:func:`recording_head`,
    :func:`recording_row_shift`) against their plain versions: the head's
    forward at HEAD_TOL, its backward on the step's cotangents at
    HEAD_BWD_TOL, row_shift bitwise.  These launches come after the
    counted run."""
    from dsnt_pose2d_tpu_torch.ops.cuda import (fused_dsnt_head_bwd,
                                                fused_dsnt_head_bwd_reference)

    fwd, bwd = [], []
    for call in heads_seen.values():
        raw, t, kw = call["raw"], call["t"], call["kw"]
        err_c, err_r = compare_head(raw, t, kw["reg"], kw["preact"],
                                    kw["threshold"], kw["sigma_px"])
        fwd.append({"shape": list(raw.shape), "coords_err": err_c,
                    "reg_err": err_r})
        if call["gc"] is not None:
            got = fused_dsnt_head_bwd(raw, t, call["gc"], call["gr"], **kw)
            exp = fused_dsnt_head_bwd_reference(raw, t, call["gc"], call["gr"],
                                                **kw)
            torch.cuda.synchronize()
            assert_dh_close(got, exp)
            bwd.append({"shape": list(raw.shape),
                        "max_abs_err": (got - exp).abs().max().item()})
    if not fwd or not bwd or not shifts_seen:
        raise AssertionError(f"dp: a rank recorded {len(fwd)} head forward, "
                             f"{len(bwd)} backward and {len(shifts_seen)} "
                             "row_shift calls")
    return {"dsnt_head_fwd": fwd, "dsnt_head_bwd": bwd,
            "row_shift": assert_row_shift_bitwise("dp", list(shifts_seen.values())),
            "max_abs_err": {
                "dsnt_head_fwd": max(max(c["coords_err"], c["reg_err"]) for c in fwd),
                "dsnt_head_bwd": max(c["max_abs_err"] for c in bwd),
                "row_shift": 0.0}}


def dp_rank_main(work: str):
    """One rank of the dp phase (``chip_smoke.py --dp-rank <dir>``, under
    the launcher's variables): both ranks on cuda:0 over gloo."""
    from dsnt_pose2d_tpu_torch.parallel import mesh as pmesh

    dev = torch.device(DP_RANK_DEVICE)
    pmesh.initialize_distributed(dev, backend="gloo")
    mesh = pmesh.make_mesh(device=dev)
    assert mesh.world_size == DP_RANKS and torch.distributed.get_backend() == "gloo"
    try:
        for kind in ("bf16", "fp32"):
            sds = {w: torch.load(Path(work) / f"{kind}_{w}.pt", weights_only=True)
                   for w in ("weights", "eval_weights")
                   if (Path(work) / f"{kind}_{w}.pt").exists()}
            out = dp_drive(kind, dp_config(kind), sds["weights"], dev, mesh,
                           eval_state_dict=sds.get("eval_weights"))
            torch.save(out, Path(work) / f"{kind}_rank{mesh.rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def dp_cli_main(argv):
    """``cli.train`` with cuDNN's deterministic algorithms
    (``chip_smoke.py --dp-cli <train flags>``)."""
    from dsnt_pose2d_tpu_torch.cli import train as train_cli

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    sys.exit(train_cli.main(argv))


def dp_launch(argv, env):
    """Start ``argv``; returns the Popen (stdout and stderr merged)."""
    return subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def dp_wait(procs, timeout) -> list:
    """Wait for every process; kill what is left; raise on a failure."""
    t0, outs = time.perf_counter(), []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, timeout - (time.perf_counter() - t0)))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        if p.returncode:
            raise AssertionError(f"{p.args[:4]} exited {p.returncode}:\n"
                                 + "\n".join(out.splitlines()[-40:]))
    return outs


def _plain_env() -> dict:
    """This process's environment without a launcher's variables."""
    drop = {"WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
            "TORCHELASTIC_RUN_ID", "LOCAL_WORLD_SIZE", "GROUP_RANK"}
    return {k: v for k, v in os.environ.items() if k not in drop}


def dp_nccl_world_one(tmp: Path) -> dict:
    """``cli.train`` on the flagship under ``torchrun --nproc_per_node=1``
    (NCCL, world size 1) and the same run without a launcher, both with
    cuDNN's deterministic algorithms, at once: the losses must be bitwise
    equal."""
    script = str(ROOT / "chip_smoke.py")
    runs = {"plain": [sys.executable, script, "--dp-cli"],
            "torchrun": [sys.executable, "-m", "torch.distributed.run",
                         "--standalone", "--nproc_per_node=1", script, "--dp-cli"]}
    t0 = time.perf_counter()
    procs = [dp_launch(argv + DP_CLI + ["--out-dir", str(tmp),
                                        "--experiment-id", name],
                       _plain_env())
             for name, argv in runs.items()]
    outs = dict(zip(runs, dp_wait(procs, DP_TIMEOUT_S)))
    wall = time.perf_counter() - t0
    records = {}
    for name in runs:
        with open(tmp / name / "metrics.jsonl") as f:
            records[name] = [json.loads(x) for x in f]
    keys = ("loss", "train_loss", "val_loss", "val_pckh")
    seen = {name: [{k: r[k] for k in keys if k in r} for r in recs]
            for name, recs in records.items()}
    if seen["plain"] != seen["torchrun"] or not seen["plain"]:
        raise AssertionError(f"NCCL world-size-1 run differs: {seen}")
    line = DP_NCCL_LINE
    if line not in outs["torchrun"].splitlines() or "distributed:" in outs["plain"]:
        raise AssertionError("the torchrun run did not report its NCCL group:\n"
                             + outs["torchrun"][-3000:])
    return {"wall_s": wall, "records": len(seen["plain"]),
            "losses": [r["loss"] for r in seen["plain"] if "loss" in r],
            "val_pckh": [r["val_pckh"] for r in seen["plain"] if "val_pckh" in r],
            "group": line}


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def dp_readings(kind, run, ref) -> dict:
    """A run's readings against the one-process reference, each a list over
    the steps (fp32: one step): the loss's and the grad norm's relative
    error; in fp32 also the running statistics' worst error of their
    tensor's largest value, the gradients' worst error of the model's
    largest gradient, and the share of updated parameters further than 5%
    of a full RMSProp step (10 lr) from the reference's.  DP_ZERO_GRAD's
    leaves are left out."""
    out = {k: [_rel(m[k], r[k]) for m, r in zip(run["metrics"], ref["metrics"])]
           for k in ("loss", "grad_norm")}
    out = {"loss_rel": out["loss"], "grad_norm_rel": out["grad_norm"]}
    if kind == "bf16":
        return out
    full = 10 * dp_config("fp32").optim.lr
    stats_err = param_err = grad_err = 0.0
    off = total = 0
    gmax = max(g.abs().max().item() for k, g in ref["grads"].items()
               if not DP_ZERO_GRAD.search(k))
    for k, v in ref["state"].items():
        scale = max(v.abs().max().item(), 1e-30)
        diff = (run["state"][k] - v).abs()
        if k not in ref["grads"]:
            stats_err = max(stats_err, diff.max().item() / scale)
        elif not DP_ZERO_GRAD.search(k):
            grad_err = max(grad_err, (run["grads"][k] - ref["grads"][k]).abs()
                           .max().item() / gmax)
            param_err = max(param_err, diff.max().item() / scale)
            off += int((diff > 0.05 * full).sum())
            total += diff.numel()
    return {**out, "running_stats_err_of_max": [stats_err],
            "grads_err_of_model_max": [grad_err],
            "params_share_off_5pct_step": [off / total],
            "params_worst_err_of_max": [param_err]}


def dp_hold(kind, ranks, witnesses) -> dict:
    """Each of DP_TOL[kind]'s readings of the ranks, at every step, against
    the larger of its floor and DP_WITNESS_FACTOR times the worst witness's
    reading; raises at the first one above.  Returns the readings and
    limits."""
    held = {}
    for key, floor in DP_TOL[kind].items():
        worst = [max(w[key][s] for w in witnesses.values())
                 for s in range(len(ranks[key]))]
        limit = [max(floor, DP_WITNESS_FACTOR * w) for w in worst]
        held[key] = {"ranks": ranks[key], "limit": limit,
                     "witnesses": {n: w[key] for n, w in witnesses.items()}}
        if any(r > lim for r, lim in zip(ranks[key], limit)):
            raise AssertionError(f"dp {kind} {key} against one process: "
                                 f"{held[key]}")
    return held


def phase_dp(dev, card):
    """Data parallelism on the card: the NCCL world-size-1 ``cli.train``
    against the plain run; then 2 ranks on the one card over gloo (bf16 hg8
    at full width, 3 steps; fp32 hg2 at the flagship's widths with TF32
    off, 1 step, after an eval pass and ``predict`` over DP_VAL_ROWS rows),
    each rank's kernel calls against their plain versions, and each rank
    step against one process's step on the same global batch from the same
    state, held relative to the witnesses of DP_WITNESSES."""
    import socket
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dsnt_dp_") as tmp:
        tmp = Path(tmp)
        nccl = dp_nccl_world_one(tmp)
        emit("dp_nccl_world_size_1", card=card, **nccl)

        # The tempered weights first, in this process; then it frees the card.
        weights = {kind: dp_weights(kind, dev, tmp) for kind in ("bf16", "fp32")}

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        procs = [dp_launch(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dp-rank", str(tmp)],
            {**_plain_env(), "WORLD_SIZE": str(DP_RANKS), "RANK": str(r),
             "LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": str(port)}) for r in range(DP_RANKS)]
        dp_wait(procs, DP_TIMEOUT_S)
        ranks_wall = time.perf_counter() - t0
        ranks = {kind: [torch.load(tmp / f"{kind}_rank{r}.pt", weights_only=False)
                        for r in range(DP_RANKS)] for kind in ("bf16", "fp32")}

    # One process on the global batch, each step from the ranks' state
    # before it; then the witnesses from the same states.
    one, witnesses = {}, {}
    t_one = time.perf_counter()
    for kind in ("bf16", "fp32"):
        cfg, sds = dp_config(kind), weights[kind]
        starts = [None, *ranks[kind][0].pop("snapshots")]
        one[kind] = dp_drive(kind, cfg, sds["weights"], dev,
                             eval_state_dict=sds.get("eval_weights"), starts=starts)
        witnesses[kind] = {
            name: dp_readings(kind, dp_drive(kind, cfg, sds["weights"], dev,
                                             order=order, starts=starts), one[kind])
            for name, order in DP_WITNESSES.items()}
    one_s = time.perf_counter() - t_one

    report, held, errs = {}, {}, {}
    for kind in ("bf16", "fp32"):
        a, b = ranks[kind]
        ref = one[kind]
        if a["digests"] != b["digests"]:
            raise AssertionError(f"dp {kind}: the ranks' states differ")
        for r in (a, b):
            want = {"dsnt_head_fwd": len(r["metrics"]),
                    "dsnt_head_bwd": len(r["metrics"]),
                    "row_shift": 2 * len(r["metrics"])}
            if {k: r["launches"].get(k, 0) for k in want} != want:
                raise AssertionError(f"dp {kind} rank launches {r['launches']}")
            for c, n in zip(r["collectives"], r["grad_buckets"]):
                if c != {"all_reduce": 2 * r["bns"] + 2 + n, "broadcast": 0}:
                    raise AssertionError(f"dp {kind} collectives {c}")
            for k, err in r["kernels_vs_plain"]["max_abs_err"].items():
                errs[k] = max(errs.get(k, 0.0), err)
        readings = dp_readings(kind, a, ref)
        report[kind] = {
            **readings,
            "losses_one_process": [m["loss"] for m in ref["metrics"]],
            "losses_ranks": [m["loss"] for m in a["metrics"]],
            "ranks_bitwise_equal_after_each_step": True,
            "kernels_vs_plain": a["kernels_vs_plain"],
            "bns": a["bns"], "collectives_per_step": a["collectives"][-1],
            "grad_buckets": a["grad_buckets"][-1],
            "rank_step_ms": {r["rank"]: r["step_ms"] for r in (a, b)},
            "one_process_step_ms": ref["step_ms"],
            "grad_all_reduce_ms": {r["rank"]: r["grad_all_reduce_ms"] for r in (a, b)},
            "peak_mem_bytes": {"one_process": ref["peak_mem_bytes"],
                               **{f"rank{r['rank']}": r["peak_mem_bytes"] for r in (a, b)}}}
        med = statistics.median(a["step_ms"][1:] or a["step_ms"])
        report[kind].update(rank_step_ms_median=med,
                            rank_img_per_s=BATCH // DP_RANKS / med * 1e3,
                            global_img_per_s=BATCH / med * 1e3)
        try:
            held[kind] = dp_hold(kind, readings, witnesses[kind])
        except AssertionError:
            report[kind]["witnesses"] = witnesses[kind]
            emit("dp", card=card, failed=kind, tolerance=DP_TOL, **report)
            raise
    a, ref = ranks["fp32"][0], one["fp32"]
    fp = report["fp32"]
    pred_err = float(np.abs(a["pred_orig"] - ref["pred_orig"]).max())
    fp.update(eval_loss_rel=_rel(a["eval"]["loss"], ref["eval"]["loss"]),
              pred_orig_max_err_px=pred_err, val_rows=DP_VAL_ROWS,
              pckh_total=sum(ref["eval"]["total"]))
    emit("dp", card=card, ranks=DP_RANKS, backend="gloo (both ranks on cuda:0)",
         note="gloo stages CUDA tensors through the host: these times are no "
              "measure of NCCL across cards",
         ranks_wall_s=ranks_wall, one_process_and_witnesses_wall_s=one_s,
         wall_s=time.perf_counter() - t_phase, tolerance=DP_TOL,
         fp32_model=DP_FP32_MODEL, held=held, kernels_vs_plain_max_err=errs,
         **report)

    for r in ranks["fp32"]:
        if r["eval"]["correct"] != ref["eval"]["correct"] or \
                r["eval"]["total"] != ref["eval"]["total"]:
            raise AssertionError(f"dp eval counts {r['eval']} != {ref['eval']}")
        rows = r["gidx"][r["gidx"] >= 0]
        if sorted(rows.tolist()) != list(range(DP_VAL_ROWS)):
            raise AssertionError("dp predict does not cover each row once")
    if not np.array_equal(a["pred_orig"], ranks["fp32"][1]["pred_orig"]) \
            or pred_err > DP_TOL["pred_orig_px"]:
        raise AssertionError(f"dp predict: max err {pred_err} px")
    launches = {}
    for kind in ranks:
        for r in ranks[kind]:
            for k, n in r["launches"].items():
                launches[k] = launches.get(k, 0) + n
    return {"launches": launches, "errs": errs}


# -- tp: tensor parallelism --------------------------------------------------

TP_RANKS = 2               # one model group: data 1 x model 2
# The global batch, cut from BATCH: both ranks take all of its rows, and
# under gloo every conv's output crosses the host twice a step (its gather
# forward, its input gradient's sum backward): at 8 rows one 256 x 64 x 64
# fp32 map is 33.5 MB, and the hg2 step carries about 2 GB each way.
TP_BATCH = 8
TP_VAL_ROWS = 12           # two batches of 8: the second ends in 4 pad rows
TP_WITNESSES = {"reversed_rows": np.arange(TP_BATCH)[::-1].copy(),
                "permuted_rows": np.random.default_rng(1).permutation(TP_BATCH),
                "permuted_rows_2": np.random.default_rng(2).permutation(TP_BATCH)}
TP_TIMEOUT_S = 300


def tp_rank_main(work: str):
    """One rank of the tp phase (``chip_smoke.py --tp-rank <dir>``, under
    the launcher's variables): both ranks on cuda:0 over gloo, one model
    group of TP_RANKS."""
    from dsnt_pose2d_tpu_torch.parallel import mesh as pmesh

    dev = torch.device(DP_RANK_DEVICE)
    pmesh.initialize_distributed(dev, backend="gloo")
    mesh = pmesh.make_mesh(TP_RANKS, device=dev)
    assert mesh.shape == {"data": 1, "model": TP_RANKS}, mesh.shape
    assert torch.distributed.get_backend() == "gloo"
    try:
        sds = {w: torch.load(Path(work) / f"fp32_{w}.pt", weights_only=True)
               for w in ("weights", "eval_weights")}
        out = dp_drive("fp32", dp_config("fp32"), sds["weights"], dev, mesh,
                       eval_state_dict=sds["eval_weights"],
                       global_batch=TP_BATCH, val_rows=TP_VAL_ROWS)
        torch.save(out, Path(work) / f"tp_rank{mesh.rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def tp_local_shapes(cfg, rank) -> dict:
    """Each parameter's shape on model rank ``rank`` of TP_RANKS, from the
    JAX package's rule over the whole model's flax leaves."""
    from dsnt_pose2d_tpu_torch.models.factory import PoseNet
    from dsnt_pose2d_tpu_torch.parallel import tp

    with torch.device("meta"):
        net = PoseNet(cfg.model)
    return {k: tp.Shard(lay, rank, TP_RANKS).local_shape
            if tp.sharded(lay.flax_shape, TP_RANKS) else lay.shape
            for k, lay in tp.leaf_layouts(net).items()}


def tp_reckoned_bytes(cfg, rows) -> dict:
    """The bytes a train step's model-axis all-reduces carry, from the
    shapes alone (a meta-device forward of the whole model on ``rows``
    rows): each conv's output (its gather) and each conv's input but the
    stem's (its gradient's sum; the images need none)."""
    from dsnt_pose2d_tpu_torch.models.factory import PoseNet

    with torch.device("meta"):
        net = PoseNet(cfg.model)
    stem, tot = net.backbone.stem_conv, {"gathers": 0, "input_grad_sums": 0}

    def hook(mod, inp, out):
        tot["gathers"] += out.numel() * out.element_size()
        if mod is not stem:
            tot["input_grad_sums"] += inp[0].numel() * inp[0].element_size()

    for mod in net.modules():
        if isinstance(mod, torch.nn.Conv2d):
            mod.register_forward_hook(hook)
    side = cfg.model.resolved_input_size
    net.train()(torch.zeros(rows, side, side, 3, device="meta"))
    return tot


def phase_tp(dev, card):
    """Tensor parallelism on the card: 2 ranks on the one card over gloo at
    model_parallel 2 (fp32 hg2 at the flagship's widths, TF32 off): the
    eval pass and ``predict`` over TP_VAL_ROWS rows, then one train step on
    TP_BATCH rows; each rank's shard shapes, its kernel calls against
    their plain versions, its replicated leaves bitwise equal to the other
    rank's, and the step held against one process's step on the same batch
    from the same state, relative to the witnesses of TP_WITNESSES."""
    import socket
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = dp_config("fp32")
    with tempfile.TemporaryDirectory(prefix="dsnt_tp_") as tmp:
        tmp = Path(tmp)
        sds = dp_weights("fp32", dev, tmp, rows=TP_BATCH)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        procs = [dp_launch(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--tp-rank", str(tmp)],
            {**_plain_env(), "WORLD_SIZE": str(TP_RANKS), "RANK": str(r),
             "LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": str(port)}) for r in range(TP_RANKS)]
        dp_wait(procs, TP_TIMEOUT_S)
        ranks_wall = time.perf_counter() - t0
        ranks = [torch.load(tmp / f"tp_rank{r}.pt", weights_only=False)
                 for r in range(TP_RANKS)]

    t_one = time.perf_counter()
    kw = dict(global_batch=TP_BATCH, val_rows=TP_VAL_ROWS)
    one = dp_drive("fp32", cfg, sds["weights"], dev,
                   eval_state_dict=sds["eval_weights"], **kw)
    witnesses = {name: dp_readings("fp32", dp_drive("fp32", cfg, sds["weights"],
                                                    dev, order=order, **kw), one)
                 for name, order in TP_WITNESSES.items()}
    one_s = time.perf_counter() - t_one

    a, b = ranks
    errs = {}
    for r, rank in enumerate(ranks):
        want = tp_local_shapes(cfg, r)
        if rank["shapes"] != want:
            bad = {k: (rank["shapes"].get(k), v) for k, v in want.items()
                   if rank["shapes"].get(k) != v}
            raise AssertionError(f"tp rank {r} shard shapes (got, want): {bad}")
        launches = {k: rank["launches"].get(k, 0)
                    for k in ("dsnt_head_fwd", "dsnt_head_bwd", "row_shift")}
        if launches != {"dsnt_head_fwd": 1, "dsnt_head_bwd": 1, "row_shift": 2}:
            raise AssertionError(f"tp rank {r} launches {rank['launches']}")
        if rank["collectives"][0] != {"all_reduce": rank["model_collectives"][0]
                                      ["counts"]["all_reduce"], "broadcast": 1}:
            raise AssertionError(f"tp rank {r} collectives off the model axis: "
                                 f"{rank['collectives']} {rank['model_collectives']}")
        for k, err in rank["kernels_vs_plain"]["max_abs_err"].items():
            errs[k] = max(errs.get(k, 0.0), err)
    if a["replicated_digests"] != b["replicated_digests"]:
        raise AssertionError("tp: the ranks' replicated leaves differ")
    if any(not torch.equal(a["state"][k], b["state"][k]) for k in a["state"]):
        raise AssertionError("tp: the ranks' gathered states differ")
    sharded = sum(a["shapes"][k] != one["shapes"][k] for k in one["shapes"])
    readings = dp_readings("fp32", a, one)
    report = {
        **readings,
        "loss_one_process": one["metrics"][0]["loss"],
        "loss_ranks": a["metrics"][0]["loss"],
        "replicated_leaves_bitwise_equal": True,
        "sharded_leaves": sharded, "leaves": len(one["shapes"]),
        "kernels_vs_plain": a["kernels_vs_plain"],
        "collectives_per_step": a["collectives"][0],
        "model_axis_per_step": a["model_collectives"][0],
        "rank_step_ms": {r["rank"]: r["step_ms"] for r in ranks},
        "one_process_step_ms": one["step_ms"],
        "bytes_held": {
            "t1_one_process": {"params": one["param_bytes"],
                               "optimizer": one["optimizer_bytes"]},
            **{f"t2_rank{r['rank']}": {"params": r["param_bytes"],
                                       "optimizer": r["optimizer_bytes"]}
               for r in ranks}},
        "peak_mem_bytes": {"one_process": one["peak_mem_bytes"],
                           **{f"rank{r['rank']}": r["peak_mem_bytes"] for r in ranks}}}
    pred_err = float(np.abs(a["pred_orig"] - one["pred_orig"]).max())
    report.update(eval_loss_rel=_rel(a["eval"]["loss"], one["eval"]["loss"]),
                  pred_orig_max_err_px=pred_err, val_rows=TP_VAL_ROWS,
                  pckh_total=sum(one["eval"]["total"]))
    try:
        held = dp_hold("fp32", readings, witnesses)
    except AssertionError:
        emit("tp", card=card, failed="fp32", witnesses=witnesses, **report)
        raise
    emit("tp", card=card, ranks=TP_RANKS, mesh={"data": 1, "model": TP_RANKS},
         backend="gloo (both ranks on cuda:0)",
         note="gloo stages CUDA tensors through the host: these times are no "
              "measure of NCCL across cards",
         cut={"global_batch": TP_BATCH, "from": BATCH,
              "depth": DP_FP32_MODEL["base"]},
         reckoned_model_axis_bytes=tp_reckoned_bytes(cfg, TP_BATCH),
         ranks_wall_s=ranks_wall, one_process_and_witnesses_wall_s=one_s,
         wall_s=time.perf_counter() - t_phase, tolerance=DP_TOL["fp32"],
         witness_factor=DP_WITNESS_FACTOR, held=held,
         kernels_vs_plain_max_err=errs, **report)
    for r in ranks:
        if r["eval"]["correct"] != one["eval"]["correct"] or \
                r["eval"]["total"] != one["eval"]["total"]:
            raise AssertionError(f"tp eval counts {r['eval']} != {one['eval']}")
    if not np.array_equal(a["pred_orig"], b["pred_orig"]) \
            or pred_err > DP_TOL["pred_orig_px"]:
        raise AssertionError(f"tp predict: max err {pred_err} px")
    launches = {}
    for r in ranks:
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    return {"launches": launches, "errs": errs}


# The tools phase: the experiment drivers of dsnt_pose2d_tpu_torch/tools/
# over the synthetic fallback (a directory without MPII: the CLIs' 256
# train and 64 val rows of 96-px canvases).  ablation_heads at hg2's full
# width runs as a module (python -m) in a process of its own; beside it the
# resolution grid and the flagship report run in this process (their CLIs'
# main(argv), so the launch counters count), then sweep_train_step's
# run_one, bench_infer and profile_step (cut to single windows: their times
# beside the heads grid are not measurements); last, alone on the card, the
# head's kernels at the resolution grid's 7x7, 14x14 and 28x28 maps.
TOOLS_EPOCHS = 1
TOOLS_DILATES = (0, 1, 2)   # 7x7, 14x14, 28x28 maps at the ResNet's 224 px
TOOLS_FLAGSHIP_EPOCHS = 3          # the report's steady state skips 0-1
TOOLS_SWEEP = ("b16", "b64_nopallas")
TOOLS_SWEEP_KW = {"iters": 1, "repeats": 1}
TOOLS_INFER = ["--bases", "hg2,resnet50", "--repeats", "2", "--iters", "1"]
TOOLS_PROFILE = ["--steps", "3", "--batch", "16", "--warp", "shear"]
TOOLS_TIMEOUT_S = 600
# Kernel launches of one cell of the in-process grids, from the code: the
# synthetic fallback's 256 train rows (drop_last) and 64 val rows; a train
# step launches 1 head forward, 1 backward and 2 row_shift, an eval step 2
# forwards (decode and loss) and 2 row_shift; the train CLI's eval pass and
# evaluate's pass each cover the val rows once.
TOOLS_ROWS = {"train": 256, "val": 64}


def tools_cell_launches(batch, epochs):
    train = epochs * (TOOLS_ROWS["train"] // batch)
    evals = (epochs + 1) * -(-TOOLS_ROWS["val"] // batch)
    return {"dsnt_head_fwd": train + 2 * evals, "dsnt_head_bwd": train,
            "row_shift": 2 * (train + evals)}


def tools_module(name, args, device):
    """``python -m dsnt_pose2d_tpu_torch.tools.<name>`` in a process of its
    own, started (the Popen; stdout and stderr merged)."""
    return subprocess.Popen(
        [sys.executable, "-m", f"dsnt_pose2d_tpu_torch.tools.{name}", *args,
         "--device", device], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def same_keys(got: dict, doc: dict, where: str):
    """``got`` has ``doc``'s keys, nested dicts too; each cell of a
    ``results`` dict has the keys of the doc's first cell."""
    if set(got) != set(doc):
        raise AssertionError(f"{where}: keys {sorted(got)} != {sorted(doc)}")
    for k, v in doc.items():
        if isinstance(v, dict) and k == "results":
            for cell, r in got[k].items():
                same_keys(r, next(iter(v.values())), f"{where}.{cell}")
        elif isinstance(v, dict) and k != "config":
            same_keys(got[k], v, f"{where}.{k}")


def tools_doc(name) -> dict:
    with open(ROOT / "docs" / name) as f:
        return json.load(f)


def head_layouts_main(spec: str):
    """``chip_smoke.py --head-layouts '[[n, h, w], ...]'``: the head's
    forward and backward instances that one call of each launches, from a
    fresh process's profiler (see PROFILE_ATTEMPTS); one JSON line."""
    from torch.profiler import ProfilerActivity, profile

    from dsnt_pose2d_tpu_torch.ops.cuda import fused_dsnt_head, fused_dsnt_head_bwd

    out = {}
    for n, h, w in json.loads(spec):
        raw, t = head_inputs(n, h, w, seed=h * w, dev=torch.device("cuda"))
        gc_, gr = torch.ones((n, 2), device="cuda"), torch.ones((n,), device="cuda")
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fused_dsnt_head(raw, t, reg="js")
                fused_dsnt_head_bwd(raw, t, gc_, gr, reg="js")
                torch.cuda.synchronize()
            names = {_short_name("", e.name) for e in _device_events(prof)
                     if re.search(r"\bdsnt_head_(fwd|bwd)_kernel\b", e.name)}
            if len(names) == 2:
                break
        else:
            raise RuntimeError(f"no profile of the head at {h}x{w} named both "
                               f"kernels in {PROFILE_ATTEMPTS} attempts")
        out[f"{h}x{w}"] = {"instances": sorted(names), "profiles": attempt,
                           "fwd": next(n.rsplit(", ", 1)[-1].rstrip(">")
                                       for n in names if "fwd" in n),
                           "bwd": next(n.rsplit(", ", 1)[-1].rstrip(">")
                                       for n in names if "bwd" in n)}
    print(json.dumps(out), flush=True)


def head_layouts(shapes) -> dict:
    """:func:`head_layouts_main` in a process of its own."""
    lay = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--head-layouts",
         json.dumps(shapes)], cwd=ROOT, capture_output=True, text=True,
        timeout=TOOLS_TIMEOUT_S)
    if lay.returncode:
        raise AssertionError(f"--head-layouts exited {lay.returncode}:\n"
                             + lay.stderr[-3000:])
    return json.loads(lay.stdout.strip().splitlines()[-1])


def head_at_map(call, ceiling) -> dict:
    """The head's forward and backward kernels on one map size's recorded
    train-step call (its logits, targets and cotangents): against the plain
    versions at the head tolerances, timed, and against the bytes bound."""
    from dsnt_pose2d_tpu_torch.bench import timing
    from dsnt_pose2d_tpu_torch.ops.cuda import (fused_dsnt_head,
                                                fused_dsnt_head_bwd,
                                                fused_dsnt_head_bwd_reference,
                                                fused_dsnt_head_reference)

    raw, t, kw = call["raw"], call["t"], call["kw"]
    gc_, gr = call["gc"], call["gr"]
    *lead, h, w = raw.shape
    n = math.prod(lead)
    reg, preact = kw["reg"], kw.get("preact", "softmax")
    err_c, err_r = compare_head(raw, t, reg, preact, kw.get("threshold", 0.0),
                                kw.get("sigma_px", 1.0))
    got = fused_dsnt_head_bwd(raw, t, gc_, gr, **kw)
    exp = fused_dsnt_head_bwd_reference(raw, t, gc_, gr, **kw)
    torch.cuda.synchronize()
    assert_dh_close(got, exp)
    # A trained cell's logits are peaked (most rows near one-hot); the same
    # shape on head_inputs' rows (std 3, peaked and all-below-threshold rows)
    # and random cotangents, through both kernels and autograd, as well.
    rand_raw, rand_t = head_inputs(n, h, w, seed=h * w + 2, dev=raw.device)
    g = torch.Generator().manual_seed(n + h)
    rand_gc = torch.randn((n, 2), generator=g).to(raw.device)
    rand_gr = torch.randn((n,), generator=g).to(raw.device)
    rand_fwd = compare_head(rand_raw, rand_t, reg, preact)
    rand_bwd = compare_head_bwd(rand_raw, rand_t, rand_gc, rand_gr, reg, preact)
    fwd_t = timing.kernel_times(lambda: fused_dsnt_head(raw, t, **kw),
                                lambda: fused_dsnt_head_reference(raw, t, **kw))
    bwd_t = timing.kernel_times(
        lambda: fused_dsnt_head_bwd(raw, t, gc_, gr, **kw),
        lambda: fused_dsnt_head_bwd_reference(raw, t, gc_, gr, **kw))
    fwd_bytes, fwd_ops = head_bytes_ops(n, h * w, reg)
    bwd_bytes = 8 * n * h * w + 4 * 5 * n      # raw, dh; targets, gc, gr
    bwd_ops = HEAD_BWD_FLOPS_PER_ELEMENT[reg] * n * h * w
    out = {"rows": n, "hw": [h, w], "logit_std": raw.std().item(),
           "random_rows": {"fwd_coords_err": rand_fwd[0], "fwd_reg_err": rand_fwd[1],
                           "bwd_kernel_vs_plain_err": rand_bwd[0],
                           "bwd_plain_vs_autograd_err": rand_bwd[1]}}
    for key, times, nbytes, nops, err, rand in (
            ("fwd", fwd_t, fwd_bytes, fwd_ops, max(err_c, err_r), rand_fwd),
            ("bwd", bwd_t, bwd_bytes, bwd_ops, (got - exp).abs().max().item(),
             rand_bwd[:1])):
        b_ms, by = bound_ms(nbytes, nops)
        out[key] = {"max_abs_err": max(err, *rand), **{k: times[k] for k in (
            "ms", "plain_ms", "library_ms", "ms_spin")},
            "bound_ms": b_ms, "bound_by": by, "bytes": nbytes,
            "frac_of_ceiling": nbytes / times["ms"] / 1e6 / ceiling}
    return out


def tools_resolution_cell(cell_dir, data_dir, dev, ceiling) -> dict:
    """One dsnt cell of the resolution grid on its own checkpoint and the
    first val batch: the eval step against the plain path (the serve
    tolerance), one train step against it (the train tolerance), and the
    head's kernels at the cell's map."""
    import dataclasses

    from dsnt_pose2d_tpu_torch.cli.common import make_datasets
    from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
    from dsnt_pose2d_tpu_torch.train.checkpoint import CheckpointManager
    from dsnt_pose2d_tpu_torch.train.loop import make_eval_fn, make_train_fn

    ckpt = CheckpointManager(cell_dir)
    cfg = ckpt.load_config()
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, data_dir=data_dir, source="auto"))
    _, val_ds = make_datasets(cfg)
    batch = {k: torch.from_numpy(v[:cfg.train.batch_size]).to(dev)
             for k, v in val_ds.arrays.items()}
    model = build_pose_model(cfg.model, device=dev, seed=0)
    state, meta = ckpt.restore(make_train_fn(model, cfg, device=dev).state)
    assert state is not None, cell_dir
    eval_step = make_eval_fn(model, cfg, device=dev)
    serve = eval_vs_plain(eval_step, batch)
    calls = {}
    with recording_head(calls):
        train = train_vs_plain(model, cfg, batch, dev, 1, {
            "dsnt_head_fwd": 1, "dsnt_head_bwd": 1, "row_shift": 2})
    (call,) = [c for c in calls.values() if c["gc"] is not None]
    head = head_at_map(call, ceiling)
    out = {"epoch": meta["epoch"], "eval_vs_plain": serve,
           "train_vs_plain": train["plain_path"], "head": head}
    del model, train, eval_step, calls, call
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tools_finish(proc, name) -> str:
    """Wait for a :func:`tools_module` process (killed at TOOLS_TIMEOUT_S);
    its output; raise if it failed."""
    try:
        out, _ = proc.communicate(timeout=TOOLS_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode:
        raise AssertionError("%s exited %d:\n%s" % (
            name, proc.returncode, "\n".join(out.splitlines()[-40:])))
    return out


def phase_tools(dev, card, ceiling):
    """The experiment drivers (see TOOLS_* above).  Returns the launches of
    the in-process runs (the resolution grid and the flagship report), the
    head kernels' largest errors at the grid's maps, and the maps' records."""
    import tempfile

    from dsnt_pose2d_tpu_torch.ops import cuda as kernels
    from dsnt_pose2d_tpu_torch.tools import (ablation_common,
                                             ablation_resolution,
                                             flagship_report, sweep_train_step)

    gc.collect()
    torch.cuda.empty_cache()
    device = dev.type
    t_phase = time.perf_counter()
    launches, walls = {}, {}

    def done(part, t0):
        walls[part] = time.perf_counter() - t0
        print(f"[tools +{time.perf_counter() - t_phase:.1f}s] {part} "
              f"{walls[part]:.1f}s", file=sys.stderr, flush=True)

    with tempfile.TemporaryDirectory(prefix="dsnt_tools_") as tmp:
        data = os.path.join(tmp, "data")      # no MPII: the synthetic fallback
        os.makedirs(data)
        t_heads = time.perf_counter()
        heads = tools_module("ablation_heads", [
            "--data-dir", data, "--epochs", str(TOOLS_EPOCHS),
            "--batch-size", str(BATCH), "--out-dir", os.path.join(tmp, "heads")],
            device)
        try:
            # Beside the heads grid's process: the in-process grids (counted),
            # then the benches, whose times are therefore not measurements.
            grids = {"resolution": (ablation_resolution.main, [
                "--data-dir", data, "--heads", "dsnt", "--dilates",
                ",".join(map(str, TOOLS_DILATES)), "--epochs", str(TOOLS_EPOCHS),
                "--batch-size", str(BATCH), "--out-dir", os.path.join(tmp, "res")]),
                     "flagship": (flagship_report.main, [
                "--data-dir", data, "--epochs", str(TOOLS_FLAGSHIP_EPOCHS),
                "--skip-device-bench", "--out-dir", os.path.join(tmp, "flagship")])}
            for name, (main_fn, argv) in grids.items():
                t0 = time.perf_counter()
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                with ablation_common.in_process():
                    assert main_fn(argv + ["--device", device]) == 0
                torch.cuda.synchronize()
                launches[name] = kernels.launch_counts()
                done(name, t0)
            gc.collect()
            torch.cuda.empty_cache()

            t0 = time.perf_counter()
            configs = dict(sweep_train_step.CONFIGS)
            sweep = [sweep_train_step.run_one(label, configs[label], device=device,
                                              **TOOLS_SWEEP_KW)
                     for label in TOOLS_SWEEP]
            if not all("ips" in r and r["ips"] > 0 for r in sweep):
                raise AssertionError(f"sweep_train_step rows {sweep}")
            done("sweep", t0)

            t0 = time.perf_counter()
            infer_file = os.path.join(tmp, "infer.json")
            tools_finish(tools_module("bench_infer",
                                      [*TOOLS_INFER, "--out", infer_file], device),
                         "bench_infer")
            with open(infer_file) as f:
                infer_rows = json.load(f)
            for r in infer_rows:
                same_keys(r, tools_doc("infer_bench.json")[0],
                          f"bench_infer.{r.get('base')}")
            done("bench_infer", t0)

            t0 = time.perf_counter()
            prof_out = tools_finish(tools_module(
                "profile_step", [*TOOLS_PROFILE, "--out",
                                 os.path.join(tmp, "prof")], device), "profile_step")
            prof_rec = json.loads(prof_out.strip().splitlines()[-1])
            (trace_path,) = prof_rec["trace_files"]
            with open(trace_path) as f:
                names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
            named = {k: sum(1 for n in names if re.search(rf"\b{k}_kernel\b", n))
                     for k in TELEMETRY_KERNELS}
            if not all(named.values()):
                raise AssertionError(f"profile_step's trace names the kernels {named}")
            done("profile_step", t0)
            tools_finish(heads, "ablation_heads")
            done("heads", t_heads)
        finally:
            if heads.poll() is None:
                heads.kill()
                heads.communicate()

        # The JSON records against the JAX runs' records in docs/.
        with open(os.path.join(data, "ablation_heads.json")) as f:
            heads_json = json.load(f)
        same_keys(heads_json, tools_doc("ablation_heads.json"), "ablation_heads")
        with open(os.path.join(data, "ablation_resolution.json")) as f:
            res_json = json.load(f)
        same_keys(res_json, tools_doc("ablation_resolution.json"),
                  "ablation_resolution")
        with open(os.path.join(tmp, "flagship", "flagship_hg8_report.json")) as f:
            flagship = json.load(f)
        doc = {k: v for k, v in tools_doc("flagship_hg8_report.json").items()
               if "device_step" not in k}
        same_keys(flagship, doc, "flagship_report")
        assert set(flagship["per_epoch"][0]) == set(doc["per_epoch"][0])
        assert len(flagship["per_epoch"]) == TOOLS_FLAGSHIP_EPOCHS
        pckh = {**{f"heads_{k}": r["pckh_total"]
                   for k, r in heads_json["results"].items()},
                **{k: r["pckh_total"] for k, r in res_json["results"].items()},
                "flagship": flagship["pckh_total"]}
        if set(heads_json["results"]) != {"dsnt", "gauss", "fc"} or not all(
                v is not None and math.isfinite(v) for v in pckh.values()):
            raise AssertionError(f"tools: PCKh totals {pckh}")
        expected = {"resolution": {k: len(TOOLS_DILATES) * v for k, v in
                                   tools_cell_launches(BATCH, TOOLS_EPOCHS).items()},
                    "flagship": tools_cell_launches(16, TOOLS_FLAGSHIP_EPOCHS)}
        for name, counts in launches.items():
            want = {**dict.fromkeys(counts, 0), **expected[name]}
            if counts != want:
                raise AssertionError(f"tools {name} launches {counts}, "
                                     f"expected {want}")

        # Alone on the card: each map's cell held and its kernels timed.
        t0 = time.perf_counter()
        cells = {}
        for d in TOOLS_DILATES:
            cell = tools_resolution_cell(
                os.path.join(tmp, "res", f"dilate{d}_dsnt"), data, dev, ceiling)
            cells["%dx%d" % tuple(cell["head"]["hw"])] = {"dilate": d, **cell}
        done("resolution_holds", t0)
        t0 = time.perf_counter()
        layouts = head_layouts([[c["head"]["rows"], *c["head"]["hw"]]
                                for c in cells.values()])
        for key, c in cells.items():
            c["layout"] = layouts[key]
        done("layouts", t0)

    total = {}
    for counts in launches.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    errs = {kind: max(c["head"][kind]["max_abs_err"] for c in cells.values())
            for kind in ("fwd", "bwd")}
    emit("tools", card=card, wall_s=time.perf_counter() - t_phase,
         walls_s=walls, data="synthetic fallback (no MPII in the data dir)",
         pckh=pckh,
         heads={k: {"pckh_total": r["pckh_total"], "train_s": r["train_s"]}
                for k, r in heads_json["results"].items()},
         resolution={k: {kk: r[kk] for kk in ("pckh_total", "train_s")}
                     for k, r in res_json["results"].items()},
         maps=cells,
         flagship={k: v for k, v in flagship.items()
                   if k not in ("pckh_table", "per_epoch", "config")},
         flagship_per_epoch=flagship["per_epoch"],
         beside_the_heads_grid="the grids, sweep, bench_infer and profile_step "
                               "ran beside the heads grid's process: their "
                               "times are not measurements",
         sweep=sweep, bench_infer=infer_rows,
         profile_step={**prof_rec, "kernel_events": named},
         launches=launches,
         tolerance={"eval": STEP_TOL, "train": TRAIN_TOL, "head": HEAD_TOL,
                    "head_bwd": HEAD_BWD_TOL},
         clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu"))
    return {"launches": total, "errs": errs, "maps": cells}


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
    vit = phase_vit(dev, card, ceiling)
    remat_launches = phase_remat(dev, card)
    for name, n in vit["remat"].items():
        remat_launches[name] += n
    # Its profiler runs in a process of its own, after every phase that
    # times or profiles.
    phase_telemetry(dev, card)
    # Last: their ranks and CLI runs are processes of their own.
    dp = phase_dp(dev, card)
    tp = phase_tp(dev, card)
    tools = phase_tools(dev, card, ceiling)
    paths = {"serve": serve_launches, "train": train_launches,
             "bench": bench_launches, "trainer": trainer_launches,
             "cli": cli_launches, "resnet": resnet["launches"],
             "heads": heads_launches, "vit": vit["launches"],
             "remat": remat_launches, "dp": dp["launches"], "tp": tp["launches"],
             "tools": tools["launches"]}

    def launches(name):
        by_path = {p: counts.get(name, 0) for p, counts in paths.items()}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    def frac_of_ceiling(nbytes, ms):
        return nbytes / ms / 1e6 / ceiling

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def at_56(r):   # a config #5 path's 512 rows of 56x56
        return {k: r[k] for k in (*keys, "rows", "layout", "frac_of_ceiling")}

    def at_maps(kind):   # the resolution grid's maps (tools phase)
        return {f"at_{m}": {**{k: c["head"][kind][k] for k in (
            *keys, "frac_of_ceiling")}, "rows": c["head"]["rows"],
            "layout": c["layout"][kind]} for m, c in tools["maps"].items()}

    head_bytes = sum(c["bytes"] for c in head["per_call"].values())
    shift_bytes = sum(c["bytes"] for c in shift["serve"]["per_call"].values())
    entries = [
        {"name": "dsnt_head_fwd", "route": "cuda",
         "source": "dsnt_pose2d_tpu_torch/ops/cuda/dsnt_head.cu",
         "replaces": "dsnt_pose2d_tpu/ops/pallas/dsnt_head.py:184",
         **launches("dsnt_head_fwd"),
         "max_abs_err": max(head["max_abs_err"], resnet["fwd"]["max_abs_err"],
                            vit["fwd"]["max_abs_err"], dp["errs"]["dsnt_head_fwd"],
                            tp["errs"]["dsnt_head_fwd"], tools["errs"]["fwd"]),
         **{k: head[k] for k in keys},
         "frac_of_ceiling": frac_of_ceiling(head_bytes, head["ms"]),
         "at_56x56": at_56(resnet["fwd"]), "at_56x56_vit": at_56(vit["fwd"]),
         **at_maps("fwd")},
        {"name": "dsnt_head_bwd", "route": "cuda",
         "source": "dsnt_pose2d_tpu_torch/ops/cuda/dsnt_head.cu",
         "replaces": "dsnt_pose2d_tpu/ops/pallas/dsnt_head.py:213",
         **launches("dsnt_head_bwd"),
         "max_abs_err": max(bwd["max_abs_err"], resnet["bwd"]["max_abs_err"],
                            vit["bwd"]["max_abs_err"], dp["errs"]["dsnt_head_bwd"],
                            tp["errs"]["dsnt_head_bwd"], tools["errs"]["bwd"]),
         **{k: bwd[k] for k in keys}, "layout": bwd["layout"],
         "frac_of_ceiling": frac_of_ceiling(bwd["bytes"], bwd["ms"]),
         "at_56x56": at_56(resnet["bwd"]), "at_56x56_vit": at_56(vit["bwd"]),
         **at_maps("bwd")},
        # ms and the other times: the two calls of one serve step; those of
        # one train step are under by_path.
        {"name": "row_shift", "route": "cuda",
         "source": "dsnt_pose2d_tpu_torch/ops/cuda/row_shift.cu",
         "replaces": "dsnt_pose2d_tpu/ops/pallas/row_shift.py:57",
         **launches("row_shift"), "max_abs_err": shift_err,
         **{k: shift["serve"][k] for k in keys},
         "by_path": {p: {k: v[k] for k in keys}
                     for p, v in {**shift, **resnet["row_shift"],
                                  **vit["row_shift"]}.items()},
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
    if sys.argv[1:2] == ["--dp-rank"]:
        dp_rank_main(sys.argv[2])
    elif sys.argv[1:2] == ["--tp-rank"]:
        tp_rank_main(sys.argv[2])
    elif sys.argv[1:2] == ["--dp-cli"]:
        dp_cli_main(sys.argv[2:])
    elif sys.argv[1:2] == ["--head-layouts"]:
        head_layouts_main(sys.argv[2])
    else:
        main()
