"""Fused DSNT head: the Hopper kernel ``dsnt_head.cu`` and its plain version.

Port of ``dsnt_pose2d_tpu/ops/pallas/dsnt_head.py::fused_dsnt_head`` (the
forward; the backward kernel comes with training).  The wrapper dispatches
on the tensor's device: a CUDA tensor goes to the kernel, a CPU tensor to
:func:`fused_dsnt_head_reference`, the plain PyTorch composition of
:mod:`..activations`, :mod:`..dsnt` and :mod:`..losses` (what the kernel is
held against).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import activations, losses
from ..dsnt import dsnt
from . import build

REG_KINDS = ("none", "js", "kl", "mse", "var")
PREACT_KINDS = ("softmax", "thresholded_softmax")
MAX_HW = 16384   # kMaxHw in dsnt_head.cu: two f32 rows of shared memory

# Kernel launches since the last reset (see ops.cuda.reset_launch_counts).
launches = 0


def _check_args(reg: str, preact: str):
    if reg not in REG_KINDS:
        raise ValueError(f"unknown reg {reg!r}")
    if preact not in PREACT_KINDS:
        raise ValueError(f"preact {preact!r} is not fused (supported: "
                         f"{PREACT_KINDS}); use the plain ops path")


def fused_dsnt_head_reference(raw, target_coords=None, sigma_px: float = 1.0,
                              reg: str = "js", preact: str = "softmax",
                              threshold: float = 0.0):
    """Plain PyTorch version of :func:`fused_dsnt_head` (same contract)."""
    _check_args(reg, preact)
    if target_coords is None and reg in ("js", "kl", "mse"):
        reg = "none"
    raw = raw.float()
    if preact == "thresholded_softmax":
        z = activations.thresholded_softmax(raw, threshold)
    else:
        z = activations.flat_softmax(raw)
    coords = dsnt(z)
    if reg == "none":
        return coords, None
    if reg == "var":
        return coords, losses.variance_reg_losses(z, sigma_px)
    return coords, losses.REGULARIZERS[reg](z, target_coords.float(), sigma_px)


def _lib():
    lib = build.load("dsnt_head")
    if not getattr(lib, "_typed", False):
        lib.dsnt_head_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
            + [ctypes.c_float] * 5 + [ctypes.c_void_p])
        lib.dsnt_head_fwd.restype = ctypes.c_int
        lib.dsnt_head_error_string.argtypes = [ctypes.c_int]
        lib.dsnt_head_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def fused_dsnt_head(raw, target_coords=None, sigma_px: float = 1.0,
                    reg: str = "js", preact: str = "softmax",
                    threshold: float = 0.0):
    """Fused flat-softmax + DSNT + regularizer over ``(..., H, W)`` heatmaps.

    Args:
        raw: unactivated heatmaps, any leading shape.
        target_coords: ``(..., 2)`` normalized targets; ``None`` turns
            js/kl/mse into ``none`` (``var`` needs no targets).
        sigma_px: target Gaussian sigma in pixels.
        reg: one of ``none | js | kl | mse | var``.
        preact: ``softmax`` or ``thresholded_softmax``.
        threshold: logit cutoff for ``thresholded_softmax``.

    Returns:
        ``(coords, reg_losses)``: ``coords`` ``(..., 2)`` and ``reg_losses``
        shaped like the leading dims, or ``None`` when ``reg == 'none'``.
    """
    global launches
    _check_args(reg, preact)
    if raw.device.type == "cpu":
        return fused_dsnt_head_reference(raw, target_coords, sigma_px, reg,
                                         preact, threshold)
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    if raw.requires_grad:
        raise NotImplementedError("backward kernel: ROADMAP Queue 2")
    if target_coords is None and reg in ("js", "kl", "mse"):
        reg = "none"
    *lead, h, w = raw.shape
    n = math.prod(lead)
    if h * w > MAX_HW:
        raise ValueError(f"heatmap of {h}x{w} = {h * w} pixels exceeds the "
                         f"kernel's limit of {MAX_HW}")
    raw2 = raw.reshape(n, h * w).to(torch.float32).contiguous()
    if reg in ("js", "kl", "mse"):
        if target_coords.device != raw.device:
            raise ValueError("target_coords must be on the heatmaps' device")
        t2 = target_coords.reshape(n, 2).to(torch.float32).contiguous()
    else:
        t2 = raw2      # never read for none/var
    coords = torch.empty((n, 2), dtype=torch.float32, device=raw.device)
    regv = torch.empty((n,), dtype=torch.float32, device=raw.device)
    if n:
        lib = _lib()
        with torch.cuda.device(raw.device):
            stream = torch.cuda.current_stream(raw.device).cuda_stream
            err = lib.dsnt_head_fwd(
                raw2.data_ptr(), t2.data_ptr(), coords.data_ptr(),
                regv.data_ptr(), n, h, w, REG_KINDS.index(reg),
                int(preact == "thresholded_softmax"), float(threshold),
                w / (2.0 * sigma_px), h / (2.0 * sigma_px),
                (2.0 * sigma_px / w) ** 2, (2.0 * sigma_px / h) ** 2, stream)
        if err:
            raise RuntimeError("dsnt_head_fwd launch failed: "
                               + lib.dsnt_head_error_string(err).decode())
        launches += 1
    coords = coords.reshape(*lead, 2)
    if reg == "none":
        return coords, None
    return coords, regv.reshape(lead)
