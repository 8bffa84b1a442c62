#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100, ``sm_90a``).

Builds the port's CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, drives the serving and eval
steps of the flagship config (``configs/hg8_dsnt_js_train.json``: 8-stack
hourglass, 256 features, 256-px input, bf16 backbone, fused DSNT head with
the JS regularizer, shear warp) at batch 32 on 384-px synthetic canvases,
and times the kernels and the steps with CUDA events.

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
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "hg8_dsnt_js_train.json"
BATCH = 32
CANVAS = 384
STEPS = 3                  # eval and infer steps in the counted main-path run
REPS = 25                  # timed windows per measurement (median reported)
WARMUP = 3
BACK_TO_BACK = 20          # kernel calls queued in one window: host time hidden
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
ROW_SHIFT_SHAPES = {           # (rows, row length, out length), stride 3
    "eval_pass1": (12288, 1176, 1158),
    "eval_pass3": (8192, 786, 768),
    "train_xshear": (6144, 3864, 2502),
    "train_yshear": (4096, 1674, 768),
}
HEATMAP_STD = 3.0          # logit std the score convs are scaled to
HEAD_FLOPS_PER_ELEMENT = {"none": 7, "var": 12, "mse": 15, "kl": 20, "js": 25}


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, spread: bool = False, per_window: int = 1):
    """Median over REPS CUDA-event windows, after a warm-up, of one window's
    time over ``per_window``, the number of ``fn()`` calls queued in it.
    With one call per window the time includes the host's work before the
    launch; with many, the card runs them back to back and that work is
    hidden.  With ``spread``, ``(median, min, max)``."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_window):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_window)
    med = statistics.median(times)
    return (med, min(times), max(times)) if spread else med


def device_ms(fn, calls: int = BACK_TO_BACK) -> float:
    """Device time per ``fn()`` call: the summed durations of the device
    activities that ``torch.profiler`` records over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / 1e3 / calls


def kernel_times(fn, plain_fn, library_fn=None) -> dict:
    """A kernel, its plain version and (if any) the library call, each timed
    three ways: profiler device time per call (``ms``, the figure reported:
    no host time in it), back to back in one CUDA-event window (host time
    hidden only where the device outruns the host's launches), and one call
    per window (host dispatch included)."""
    out = {}
    for key, f in (("ms", fn), ("plain_ms", plain_fn), ("library_ms", library_fn)):
        if f is None:
            out[key] = None
            continue
        out[key] = device_ms(f)
        out[f"{key}_back_to_back"] = time_ms(f, per_window=BACK_TO_BACK)
        out[f"{key}_one_call"] = time_ms(f)
    return out


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


def phase_build():
    from dsnt_pose2d_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    took = build.build_all()
    for name in build.SOURCES:
        build.load(name)
    emit("build", sources=list(build.SOURCES), compile_s=took,
         total_s=time.perf_counter() - t0, flags=list(build.NVCC_FLAGS))


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


def row_shift_inputs(r, length, out, stride, seed, dev):
    g = torch.Generator().manual_seed(seed)
    rows = torch.rand((r, length), generator=g)
    px = torch.randint(0, (length - out - stride) // stride + 1, (r,),
                       generator=g)
    starts = (px * stride).to(torch.int32)
    fracs = torch.rand((r,), generator=g)
    return rows.to(dev), starts.to(dev), fracs.to(dev)


def phase_row_shift_vs_plain(dev):
    from dsnt_pose2d_tpu_torch.ops.cuda import shift_rows, shift_rows_reference

    checked, max_err = {}, 0.0
    for name, (r, length, out) in ROW_SHIFT_SHAPES.items():
        rows, starts, fracs = row_shift_inputs(r, length, out, 3, r, dev)
        got = shift_rows(rows, starts, fracs, out, stride=3)
        exp = shift_rows_reference(rows, starts, fracs, out, stride=3)
        torch.cuda.synchronize()
        if not torch.equal(got, exp):
            raise AssertionError(
                f"row_shift {name} differs from its plain version: max "
                f"{(got - exp).abs().max().item()}")
        checked[name] = [r, length, out]
        max_err = max(max_err, (got - exp).abs().max().item())
    emit("row_shift_vs_plain", bitwise_equal=True, shapes=checked,
         max_abs_err=max_err)
    return max_err


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


def temper_scores(net, images, target_std=HEATMAP_STD):
    """Scales each stack's score conv so its heatmap logits have std
    ``target_std`` on these images, stack by stack (a stack's scores feed
    the next stack through ``score_back``).

    The random-init hg8's residual sums grow from stack to stack, to logits
    of std ~1e5-1e6 at the last one, where every softmax row is one-hot;
    tempered, the main path drives the head on real softmax rows."""
    hg = net.backbone
    with torch.inference_mode():
        for i in range(hg.num_stacks):
            conv = getattr(hg, f"score{i}")
            scale = target_std / net(images)[i].std().item()
            conv.weight.mul_(scale)
            conv.bias.mul_(scale)


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
    temper_scores(model.net, pre["images"])
    eval_step = make_eval_fn(model, cfg, device=dev)
    infer_step = make_infer_fn(model, cfg, device=dev)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    outs = [eval_step(batch) for _ in range(STEPS)]
    served = [infer_step(batch) for _ in range(STEPS)]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    expected = {"dsnt_head_fwd": 3 * STEPS, "row_shift": 4 * STEPS}
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
    assert kernels.launch_counts() == {"dsnt_head_fwd": 0, "row_shift": 0}
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
            "eval_step": eval_step, "infer_step": infer_step,
            "plain_eval": plain_eval}


def head_bytes_ops(n, hw, reg):
    nbytes = 4 * n * hw + 4 * 2 * n + 4 * n
    if reg in ("js", "kl", "mse"):
        nbytes += 4 * 2 * n
    return nbytes, HEAD_FLOPS_PER_ELEMENT[reg] * n * hw


def phase_head_on_main_path(run):
    """The head kernel on the main path's own heatmaps, checked and timed."""
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
        times = kernel_times(lambda: fused_dsnt_head(x, tt, **kw),
                             lambda: fused_dsnt_head_reference(x, tt, **kw))
        n = x.numel() // (h * w)
        nbytes, nops = head_bytes_ops(n, h * w, reg)
        b_ms, by = bound_ms(nbytes, nops)
        work[key] = {"rows": n, "hw": h * w, **times, "bound_ms": b_ms,
                     "bound_by": by, "bytes": nbytes,
                     "GB_per_s": nbytes / times["ms"] / 1e6}
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


def phase_row_shift_timing(dev):
    from dsnt_pose2d_tpu_torch.ops.cuda import shift_rows, shift_rows_reference

    work, totals = {}, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                        "library_ms": 0.0}
    lib_err = 0.0
    for name, (r, length, out) in ROW_SHIFT_SHAPES.items():
        rows, starts, fracs = row_shift_inputs(r, length, out, 3, r + 1, dev)
        img, grid = row_shift_library(rows, starts, fracs, out, 3)
        lib = lambda: F.grid_sample(img, grid, mode="bilinear",
                                    padding_mode="zeros", align_corners=True)
        times = kernel_times(
            lambda: shift_rows(rows, starts, fracs, out, stride=3),
            lambda: shift_rows_reference(rows, starts, fracs, out, stride=3),
            lib)
        got = shift_rows(rows, starts, fracs, out, stride=3)
        ref = lib()[:, :, 0, :].permute(0, 2, 1).reshape(r, out)
        lib_err = max(lib_err, (got - ref).abs().max().item())
        # Each row's window (out + stride values), its start and frac read
        # once; the output written once.
        nbytes = 4 * r * (out + 3) + 8 * r + 4 * r * out
        b_ms, by = bound_ms(nbytes, 3 * r * out)
        work[name] = {"shape": [r, length, out], **times, "bound_ms": b_ms,
                      "bound_by": by, "bytes": nbytes,
                      "GB_per_s": nbytes / times["ms"] / 1e6}
        if name.startswith("eval"):
            for k in ("ms", "plain_ms", "library_ms"):
                totals[k] += times[k]
            totals["bound_ms"] += b_ms
    # grid_sample rounds the normalized tap position in fp32 (rows of up to
    # 1288 px), so it agrees to ~1e-3, not bitwise.
    assert lib_err < 1e-2, f"grid_sample yardstick disagrees: {lib_err}"
    return {**totals, "bound_by": "bytes", "per_call": work,
            "library_err": lib_err}


def phase_times(run, card):
    batch = run["batch"]
    # Interleaved: the step is host-bound and the host is shared, so two
    # paths are compared only inside one window of time.
    infer_ms = time_ms(lambda: run["infer_step"](batch), spread=True)
    eval_ms = time_ms(lambda: run["eval_step"](batch), spread=True)
    plain_eval_ms = time_ms(lambda: run["plain_eval"](batch), spread=True)
    eval_ms_2 = time_ms(lambda: run["eval_step"](batch), spread=True)
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


def phase_profile(run, card):
    """Device time by kernel over one infer and one eval step, and the
    device's busy share of each step's wall time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    batch = run["batch"]
    for name in ("infer_step", "eval_step"):
        step = run[name]
        step(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels_by_name, spans = {}, []
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            spans.append((e.time_range.start, e.time_range.end))
            ms, count = kernels_by_name.get(e.name, (0.0, 0))
            kernels_by_name[e.name] = (
                ms + (e.time_range.end - e.time_range.start) / 1e3, count + 1)
        busy_us, reach = 0.0, -math.inf
        for start, end in sorted(spans):      # union of the kernels' spans
            if end > reach:
                busy_us += end - max(start, reach)
                reach = end
        top = sorted(kernels_by_name.items(), key=lambda kv: -kv[1][0])
        emit("profile", card=card, step=name, wall_ms=wall_ms,
             device_busy_ms=busy_us / 1e3,
             device_busy_share=busy_us / 1e3 / wall_ms,
             busy_share_of_unprofiled_median=busy_us / 1e3 / run["step_ms"][name],
             device_launches=len(spans),
             top=[{"name": k[:90], "ms": ms, "count": c}
                  for k, (ms, c) in top[:12]])


def main():
    card = phase_device()
    dev = torch.device("cuda")
    phase_build()
    phase_head_vs_plain(dev)
    shift_err = phase_row_shift_vs_plain(dev)
    run = phase_serve(dev)
    head = phase_head_on_main_path(run)
    emit("dsnt_head_fwd_times", card=card, **head)
    shift = phase_row_shift_timing(dev)
    emit("row_shift_times", card=card, **shift)
    phase_times(run, card)
    phase_profile(run, card)

    entries = [
        {"name": "dsnt_head_fwd", "route": "cuda",
         "source": "dsnt_pose2d_tpu_torch/ops/cuda/dsnt_head.cu",
         "replaces": "dsnt_pose2d_tpu/ops/pallas/dsnt_head.py:184",
         "launches": run["launches"]["dsnt_head_fwd"],
         **{k: head[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")}},
        {"name": "row_shift", "route": "cuda",
         "source": "dsnt_pose2d_tpu_torch/ops/cuda/row_shift.cu",
         "replaces": "dsnt_pose2d_tpu/ops/pallas/row_shift.py:57",
         "launches": run["launches"]["row_shift"], "max_abs_err": shift_err,
         **{k: shift[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")}},
    ]
    for e in entries:
        for k in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            assert math.isfinite(e[k]), (e["name"], k)
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
