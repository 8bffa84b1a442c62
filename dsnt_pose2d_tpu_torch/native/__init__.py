"""ctypes bindings for the native canvas-IO library (JPEG decode + crop/resize)
(port of ``dsnt_pose2d_tpu/native/__init__.py``).

The port keeps its own copy of the C++ source (``src/canvasio.cpp``) and
builds it at first use with ``g++ -O3 -shared -fPIC ... -ljpeg`` into
``_build/`` beside it (listed in ``.gitignore``), named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
reused.  Where the build fails (no compiler, no libjpeg headers)
:func:`available` is False and callers take the PIL path.  All calls release
the GIL (plain C ABI), so the loader's fetch threads run them in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "canvasio.cpp"
BUILD_DIR = SRC.parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-Wall")
LIBS = ("-ljpeg",)

_lib = None
_tried = False


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def lib_path() -> Path:
    """The shared library built from the source (named by source and flags)."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join((_cxx(), *CXX_FLAGS, *LIBS)).encode())
    return BUILD_DIR / f"libcanvasio-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless it is built; returns the library's path.
    Raises ``RuntimeError`` with the compiler's output if the build fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SRC), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building {SRC.name} failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SRC.name} failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)      # atomic: a reader never sees half a library
    return out


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError):
        return None
    lib.canvasio_jpeg_info.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.canvasio_jpeg_info.restype = ctypes.c_int
    lib.canvasio_decode_jpeg.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int]
    lib.canvasio_decode_jpeg.restype = ctypes.c_int
    lib.canvasio_crop_resize.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_int]
    lib.canvasio_crop_resize.restype = None
    lib.canvasio_decode_crop_resize.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int]
    lib.canvasio_decode_crop_resize.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds (or is built) and loads here."""
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("native canvasio unavailable")
    return lib


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode a JPEG byte string to an (H, W, 3) uint8 RGB array."""
    lib = _require()
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    if lib.canvasio_jpeg_info(data, len(data), ctypes.byref(w),
                              ctypes.byref(h), ctypes.byref(c)):
        raise ValueError("not a decodable JPEG")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.canvasio_decode_jpeg(data, len(data),
                                out.ctypes.data_as(ctypes.c_void_p),
                                w.value, h.value):
        raise ValueError("JPEG decode failed")
    return out


def crop_resize(img: np.ndarray, left: float, top: float, side: float,
                out_size: int) -> np.ndarray:
    """Bilinear square crop/resize with zero-fill out of bounds (the device
    warp's sampling)."""
    lib = _require()
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape}")
    out = np.empty((out_size, out_size, 3), np.uint8)
    lib.canvasio_crop_resize(img.ctypes.data_as(ctypes.c_void_p), h, w,
                             left, top, side,
                             out.ctypes.data_as(ctypes.c_void_p), out_size)
    return out


def decode_crop_resize(data: bytes, left: float, top: float, side: float,
                       out_size: int) -> np.ndarray:
    """Fused decode + person crop + resize (one native call, GIL released)."""
    lib = _require()
    out = np.empty((out_size, out_size, 3), np.uint8)
    if lib.canvasio_decode_crop_resize(data, len(data), left, top, side,
                                       out.ctypes.data_as(ctypes.c_void_p),
                                       out_size):
        raise ValueError("decode_crop_resize failed")
    return out
