"""Fused DSNT head: the Hopper kernels of ``dsnt_head.cu`` and their plain versions.

Port of ``dsnt_pose2d_tpu/ops/pallas/dsnt_head.py::fused_dsnt_head``, forward
and backward.  :func:`fused_dsnt_head` runs a ``torch.autograd.Function``
that, like ``_make_fused``'s ``custom_vjp``, saves only the fp32 raw rows and
the targets and recomputes everything else in its backward.  The Function
dispatches on the tensor's device: a CUDA tensor goes to the kernels
(``dsnt_head_fwd``, ``dsnt_head_bwd``), a CPU tensor to the plain versions,
:func:`fused_dsnt_head_reference` (the plain PyTorch composition of
:mod:`..activations`, :mod:`..dsnt` and :mod:`..losses`) and
:func:`fused_dsnt_head_bwd_reference` (the backward's formula in torch ops).
Those are what the kernels are held against.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from .. import activations, losses
from ..coords import normalized_linspace
from ..dsnt import dsnt
from ..gauss import make_gauss
from . import build

REG_KINDS = ("none", "js", "kl", "mse", "var")
PREACT_KINDS = ("softmax", "thresholded_softmax")
MAX_HW = 16384   # kMaxHw in dsnt_head.cu: two f32 rows of shared memory
_EPS = 1e-24

# Kernel launches since the last reset (see ops.cuda.reset_launch_counts).
fwd_launches = 0
bwd_launches = 0


def _check_args(reg: str, preact: str):
    if reg not in REG_KINDS:
        raise ValueError(f"unknown reg {reg!r}")
    if preact not in PREACT_KINDS:
        raise ValueError(f"preact {preact!r} is not fused (supported: "
                         f"{PREACT_KINDS}); use the plain ops path")


def _activate(raw, preact: str, threshold: float):
    if preact == "thresholded_softmax":
        return activations.thresholded_softmax(raw, threshold)
    return activations.flat_softmax(raw)


def fused_dsnt_head_reference(raw, target_coords=None, sigma_px: float = 1.0,
                              reg: str = "js", preact: str = "softmax",
                              threshold: float = 0.0):
    """Plain PyTorch version of :func:`fused_dsnt_head` (same contract)."""
    _check_args(reg, preact)
    if target_coords is None and reg in ("js", "kl", "mse"):
        reg = "none"
    z = _activate(raw.float(), preact, threshold)
    coords = dsnt(z)
    if reg == "none":
        return coords, None
    if reg == "var":
        return coords, losses.variance_reg_losses(z, sigma_px)
    return coords, losses.REGULARIZERS[reg](z, target_coords.float(), sigma_px)


def _reg_grad(z, target_coords, sigma_px: float, reg: str):
    """d(reg)/dz per element, the exact derivative of the eps-guarded forward
    (``_reg_grad_rows`` of the JAX kernel)."""
    h, w = z.shape[-2:]
    if reg == "var":
        xs = normalized_linspace(w, z.dtype, z.device)
        ys = normalized_linspace(h, z.dtype, z.device)[:, None]
        mu_x = (z * xs).sum(dim=(-2, -1), keepdim=True)
        mu_y = (z * ys).sum(dim=(-2, -1), keepdim=True)
        var_x = (z * xs * xs).sum(dim=(-2, -1), keepdim=True) - mu_x * mu_x
        var_y = (z * ys * ys).sum(dim=(-2, -1), keepdim=True) - mu_y * mu_y
        tvx = (2.0 * sigma_px / w) ** 2
        tvy = (2.0 * sigma_px / h) ** 2
        return (2.0 * (var_x - tvx) * (xs * xs - 2.0 * mu_x * xs)
                + 2.0 * (var_y - tvy) * (ys * ys - 2.0 * mu_y * ys))
    g = make_gauss(target_coords.float(), (h, w), sigma_px)
    if reg == "js":
        m2 = 0.5 * (z + g)
        m2e = m2 + _EPS
        return (0.5 * (torch.log(z + _EPS) - torch.log(m2e))
                + 0.5 * z / (z + _EPS) - 0.5 * m2 / m2e)
    if reg == "kl":
        return torch.log(z + _EPS) - torch.log(g + _EPS) + z / (z + _EPS)
    return 2.0 * (z - g) / (h * w)     # mse


def fused_dsnt_head_bwd_reference(raw, target_coords, g_coords, g_reg=None,
                                  sigma_px: float = 1.0, reg: str = "js",
                                  preact: str = "softmax",
                                  threshold: float = 0.0):
    """Plain PyTorch version of the ``dsnt_head_bwd`` kernel.

    Given the cotangents ``g_coords`` ``(..., 2)`` and ``g_reg`` (shaped like
    the leading dims, or ``None`` for none) of :func:`fused_dsnt_head`'s
    outputs, returns the gradient with respect to ``raw`` ``(..., H, W)``,
    fp32: ``dh = z (u - <z, u>)`` with ``u = g_x X + g_y Y + g_reg dreg/dz``.
    """
    _check_args(reg, preact)
    if g_reg is None or (target_coords is None and reg in ("js", "kl", "mse")):
        reg = "none"
    h, w = raw.shape[-2:]
    z = _activate(raw.float(), preact, threshold)
    xs = normalized_linspace(w, z.dtype, z.device)
    ys = normalized_linspace(h, z.dtype, z.device)[:, None]
    gc = g_coords.float()[..., None, None, :]
    u = gc[..., 0] * xs + gc[..., 1] * ys
    if reg != "none":
        u = u + g_reg.float()[..., None, None] * _reg_grad(
            z, target_coords, sigma_px, reg)
    return z * (u - (z * u).sum(dim=(-2, -1), keepdim=True))


def _lib():
    lib = build.load("dsnt_head")
    if not getattr(lib, "_typed", False):
        lib.dsnt_head_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
            + [ctypes.c_float] * 5 + [ctypes.c_void_p])
        lib.dsnt_head_fwd.restype = ctypes.c_int
        lib.dsnt_head_bwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
            + [ctypes.c_float] * 5 + [ctypes.c_void_p])
        lib.dsnt_head_bwd.restype = ctypes.c_int
        lib.dsnt_head_error_string.argtypes = [ctypes.c_int]
        lib.dsnt_head_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _scalars(h: int, w: int, sigma_px: float, reg: str, preact: str,
             threshold: float) -> tuple:
    """The launchers' trailing scalars, from ``reg_kind`` to ``tvy``."""
    return (REG_KINDS.index(reg), int(preact == "thresholded_softmax"),
            float(threshold), w / (2.0 * sigma_px), h / (2.0 * sigma_px),
            (2.0 * sigma_px / w) ** 2, (2.0 * sigma_px / h) ** 2)


def _raise_on(lib, err: int, name: str):
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.dsnt_head_error_string(err).decode())


def _launch_fwd(raw2, t2, h, w, sigma_px, reg, preact, threshold):
    """``dsnt_head_fwd`` over ``(n, h*w)`` fp32 rows: ``(coords, reg)``."""
    global fwd_launches
    n = raw2.shape[0]
    coords = torch.empty((n, 2), dtype=torch.float32, device=raw2.device)
    regv = torch.empty((n,), dtype=torch.float32, device=raw2.device)
    if n:
        lib = _lib()
        with torch.cuda.device(raw2.device):
            stream = torch.cuda.current_stream(raw2.device).cuda_stream
            err = lib.dsnt_head_fwd(
                raw2.data_ptr(), t2.data_ptr(), coords.data_ptr(),
                regv.data_ptr(), n, h, w,
                *_scalars(h, w, sigma_px, reg, preact, threshold), stream)
        _raise_on(lib, err, "dsnt_head_fwd")
        fwd_launches += 1
    return coords, regv


def _launch_bwd(raw2, t2, g_coords, g_reg, h, w, sigma_px, reg, preact,
                threshold):
    """``dsnt_head_bwd`` over ``(n, h*w)`` fp32 rows: ``dh`` ``(n, h*w)``.
    ``g_reg`` is ``None`` exactly when ``reg`` is none."""
    global bwd_launches
    n = raw2.shape[0]
    dh = torch.empty_like(raw2)
    if n:
        lib = _lib()
        with torch.cuda.device(raw2.device):
            stream = torch.cuda.current_stream(raw2.device).cuda_stream
            err = lib.dsnt_head_bwd(
                raw2.data_ptr(), t2.data_ptr(), g_coords.data_ptr(),
                None if g_reg is None else g_reg.data_ptr(), dh.data_ptr(),
                n, h, w, *_scalars(h, w, sigma_px, reg, preact, threshold),
                stream)
        _raise_on(lib, err, "dsnt_head_bwd")
        bwd_launches += 1
    return dh


def _plain_fwd(raw2, t2, h, w, sigma_px, reg, preact, threshold):
    coords, regv = fused_dsnt_head_reference(raw2.view(-1, h, w), t2, sigma_px,
                                             reg, preact, threshold)
    return coords, (torch.zeros_like(coords[:, 0]) if regv is None else regv)


def fused_dsnt_head_bwd(raw, target_coords, g_coords, g_reg=None,
                        sigma_px: float = 1.0, reg: str = "js",
                        preact: str = "softmax", threshold: float = 0.0):
    """The ``dsnt_head_bwd`` kernel on its own: what the backward of
    :func:`fused_dsnt_head` computes, with the contract of
    :func:`fused_dsnt_head_bwd_reference` (which CPU tensors run)."""
    _check_args(reg, preact)
    if raw.device.type == "cpu":
        return fused_dsnt_head_bwd_reference(raw, target_coords, g_coords, g_reg,
                                             sigma_px, reg, preact, threshold)
    if g_reg is None or (target_coords is None and reg in ("js", "kl", "mse")):
        reg, g_reg = "none", None
    *lead, h, w = raw.shape
    n = math.prod(lead)
    raw2 = raw.reshape(n, h * w).to(torch.float32).contiguous()
    if reg in ("js", "kl", "mse"):
        t2 = target_coords.reshape(n, 2).to(torch.float32).contiguous()
    else:
        t2 = raw2      # never read for none/var
    gc2 = g_coords.reshape(n, 2).to(torch.float32).contiguous()
    gr2 = None if g_reg is None else g_reg.reshape(n).to(torch.float32).contiguous()
    dh = _launch_bwd(raw2, t2, gc2, gr2, h, w, float(sigma_px), reg, preact,
                     float(threshold))
    return dh.reshape(raw.shape)


class _FusedDsntHead(torch.autograd.Function):
    """``(raw2, t2) -> (coords, reg)`` over ``(n, h*w)`` fp32 rows.

    Saves only ``raw2`` and ``t2``; its backward is :func:`fused_dsnt_head_bwd`.
    The backward returns ``None`` for the targets and takes a ``None``
    cotangent for either output (reg ``none``, or coords unused).  The
    launchers are looked up by name at call time."""

    @staticmethod
    def forward(ctx, raw2, t2, h, w, sigma_px, reg, preact, threshold):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(raw2, t2)
        ctx.args = (h, w, sigma_px, reg, preact, threshold)
        fwd = _plain_fwd if raw2.device.type == "cpu" else _launch_fwd
        return fwd(raw2, t2, h, w, sigma_px, reg, preact, threshold)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_coords, g_reg):
        h, w, sigma_px, reg, preact, threshold = ctx.args
        if g_coords is None and g_reg is None:
            return (None,) * 8
        raw2, t2 = ctx.saved_tensors
        n = raw2.shape[0]
        if g_coords is None:
            g_coords = torch.zeros((n, 2), dtype=torch.float32,
                                   device=raw2.device)
        dh = fused_dsnt_head_bwd(raw2.view(n, h, w), t2, g_coords, g_reg,
                                 sigma_px, reg, preact, threshold)
        return (dh.view(n, h * w),) + (None,) * 7


def fused_dsnt_head(raw, target_coords=None, sigma_px: float = 1.0,
                    reg: str = "js", preact: str = "softmax",
                    threshold: float = 0.0):
    """Fused flat-softmax + DSNT + regularizer over ``(..., H, W)`` heatmaps,
    differentiable with respect to ``raw`` (not the targets).

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
    _check_args(reg, preact)
    if raw.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {raw.device}")
    if target_coords is None and reg in ("js", "kl", "mse"):
        reg = "none"
    *lead, h, w = raw.shape
    n = math.prod(lead)
    if raw.device.type == "cuda" and h * w > MAX_HW:
        raise ValueError(f"heatmap of {h}x{w} = {h * w} pixels exceeds the "
                         f"kernel's limit of {MAX_HW}")
    raw2 = raw.reshape(n, h * w).to(torch.float32).contiguous()
    if reg in ("js", "kl", "mse"):
        if target_coords.device != raw.device:
            raise ValueError("target_coords must be on the heatmaps' device")
        t2 = target_coords.detach().reshape(n, 2).to(torch.float32).contiguous()
    else:
        t2 = raw2.detach()      # never read for none/var
    coords, regv = _FusedDsntHead.apply(raw2, t2, h, w, float(sigma_px), reg,
                                        preact, float(threshold))
    coords = coords.reshape(*lead, 2)
    if reg == "none":
        return coords, None
    return coords, regv.reshape(lead)
