"""Per-row fractional shift: the Hopper kernel ``row_shift.cu`` and its plain version.

Port of ``dsnt_pose2d_tpu/ops/pallas/row_shift.py::shift_rows``.  A CUDA
tensor goes to the kernel; a CPU tensor to :func:`shift_rows_reference`.  The
two agree bitwise (the kernel rounds each product and the sum separately).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

IMPLS = ("vec", "legacy")

# Kernel launches since the last reset (see ops.cuda.reset_launch_counts).
launches = 0


def _check(rows, starts, fracs, out_len: int, impl: str):
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (supported: {IMPLS})")
    if rows.dim() != 2:
        raise ValueError(f"rows must be (R, L), got {tuple(rows.shape)}")
    r = rows.shape[0]
    if starts.shape != (r,) or fracs.shape != (r,):
        raise ValueError("starts and fracs must be (R,)")
    if out_len <= 0:
        raise ValueError(f"out_len must be positive, got {out_len}")


def shift_rows_reference(rows, starts, fracs, out_len: int, stride: int = 1,
                         impl: str = "vec"):
    """Plain PyTorch version of :func:`shift_rows`; taps outside a row read 0."""
    _check(rows, starts, fracs, out_len, impl)
    rows = rows.to(torch.float32)
    length = rows.shape[1]
    ia = starts.to(torch.int64)[:, None] + torch.arange(
        out_len, device=rows.device)
    ib = ia + stride

    def tap(idx):
        ok = (idx >= 0) & (idx < length)
        vals = rows.gather(1, idx.clamp(0, length - 1))
        return torch.where(ok, vals, torch.zeros((), device=rows.device))

    f = fracs.to(torch.float32)[:, None]
    return (1.0 - f) * tap(ia) + f * tap(ib)


def _lib():
    lib = build.load("row_shift")
    if not getattr(lib, "_typed", False):
        lib.row_shift.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.row_shift.restype = ctypes.c_int
        lib.row_shift_error_string.argtypes = [ctypes.c_int]
        lib.row_shift_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def shift_rows(rows, starts, fracs, out_len: int, stride: int = 1,
               impl: str = "vec"):
    """``out[r, i] = (1-f) * rows[r, k_r + i] + f * rows[r, k_r + i + stride]``.

    Args:
        rows: ``(R, L)`` float32; the caller pads so that every tap is in
            range (taps outside the row read 0 all the same).
        starts: ``(R,)`` int32 slice starts, each in ``[0, L - out_len - stride]``.
        fracs: ``(R,)`` float32 blend weights.
        out_len: output row length.
        stride: element distance of the second tap (C for interleaved rows).
        impl: ``"vec"`` or ``"legacy"``, accepted for parity with the JAX
            package; both run the one Hopper kernel.
    """
    global launches
    _check(rows, starts, fracs, out_len, impl)
    if rows.device.type == "cpu":
        return shift_rows_reference(rows, starts, fracs, out_len, stride, impl)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    if starts.device != rows.device or fracs.device != rows.device:
        raise ValueError("starts and fracs must be on the rows' device")
    n, length = rows.shape
    rows = rows.to(torch.float32).contiguous()
    starts = starts.to(torch.int32).contiguous()
    fracs = fracs.to(torch.float32).contiguous()
    out = torch.empty((n, out_len), dtype=torch.float32, device=rows.device)
    if n:
        lib = _lib()
        with torch.cuda.device(rows.device):
            stream = torch.cuda.current_stream(rows.device).cuda_stream
            err = lib.row_shift(rows.data_ptr(), starts.data_ptr(),
                                fracs.data_ptr(), out.data_ptr(), n, length,
                                out_len, stride, stream)
        if err:
            raise RuntimeError("row_shift launch failed: "
                               + lib.row_shift_error_string(err).decode())
        launches += 1
    return out
