"""Calibration kernels: ``calib.cu`` (copy, exp, row softmax) and their plain versions.

Port of the three kernels of ``bench_kernel.py::calibrate`` (``_copy_k``,
``_exp_k``, ``_smax_k``), which measure the memory rate that the other
kernels' rooflines are stated against.  Each wrapper takes ``x`` ``(rows,
cols)`` fp32, contiguous, ``cols % 4 == 0`` (and ``cols <= 4096`` for the
softmax), and ``s``, a 1-element fp32 tensor on ``x``'s device that the
kernel reads, so the scalar never goes through the host.  A CUDA tensor
goes to the kernel, a CPU tensor to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

KINDS = ("copy", "exp", "smax")
MAX_SMAX_COLS = 4096   # kSmaxMaxCols in calib.cu: the row is held in registers

# Kernel launches since the last reset (see ops.cuda.reset_launch_counts).
copy_launches = 0
exp_launches = 0
smax_launches = 0


def _check(x, s, kind: str):
    if x.dtype != torch.float32 or s.dtype != torch.float32:
        raise ValueError(f"x and s must be float32, got {x.dtype} and {s.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be (rows, cols), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if s.numel() != 1:
        raise ValueError(f"s must hold one value, got {s.numel()}")
    if s.device != x.device:
        raise ValueError("s must be on x's device")
    cols = x.shape[1]
    if cols % 4:
        raise ValueError(f"cols must be a multiple of 4 (16-byte rows), got {cols}")
    if kind == "smax" and cols > MAX_SMAX_COLS:
        raise ValueError(f"the softmax kernel holds a row of at most "
                         f"{MAX_SMAX_COLS} values in registers, got {cols}")


def calib_copy_reference(x, s):
    """Plain PyTorch version of :func:`calib_copy`."""
    _check(x, s, "copy")
    return x + s.reshape(())


def calib_exp_reference(x, s):
    """Plain PyTorch version of :func:`calib_exp`."""
    _check(x, s, "exp")
    return torch.exp(x + s.reshape(()))


def calib_smax_reference(x, s):
    """Plain PyTorch version of :func:`calib_smax`."""
    _check(x, s, "smax")
    return torch.softmax(x + s.reshape(()), dim=1)


def _lib():
    lib = build.load("calib")
    if not getattr(lib, "_typed", False):
        for kind in KINDS:
            fn = getattr(lib, f"calib_{kind}")
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.calib_error_string.argtypes = [ctypes.c_int]
        lib.calib_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _run(kind: str, x, s):
    _check(x, s, kind)
    if x.device.type == "cpu":
        return _REFERENCES[kind](x, s)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = torch.empty_like(x)
    for t in (x, out):
        if t.data_ptr() % 16:
            raise ValueError("x must start on a 16-byte boundary")
    rows, cols = x.shape
    if rows:
        lib = _lib()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = getattr(lib, f"calib_{kind}")(x.data_ptr(), s.data_ptr(),
                                                out.data_ptr(), rows, cols, stream)
        if err:
            raise RuntimeError(f"calib_{kind} launch failed: "
                               + lib.calib_error_string(err).decode())
        name = f"{kind}_launches"
        globals()[name] += 1
    return out


def calib_copy(x, s):
    """``o = x + s``: one read and one write of ``x``."""
    return _run("copy", x, s)


def calib_exp(x, s):
    """``o = exp(x + s)``."""
    return _run("exp", x, s)


def calib_smax(x, s):
    """The softmax of each row of ``x + s``."""
    return _run("smax", x, s)


_REFERENCES = {"copy": calib_copy_reference, "exp": calib_exp_reference,
               "smax": calib_smax_reference}
