"""The default-device rule of the port, strict-fp32 math, and constants
held on the device.

Entry points take ``device=`` and default to ``"cuda"``.  Without a card they
raise unless the caller asked for the CPU: work never moves to the CPU
quietly.
"""

from __future__ import annotations

import contextlib

import torch

DEFAULT_DEVICE = "cuda"

# (values, dtype, device) -> the tensor device_constant made for them.
_CONSTANTS: dict = {}


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a :class:`torch.device`; raises if CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


@contextlib.contextmanager
def strict_fp32():
    """Turn TF32 off for matmuls and convolutions inside the block.

    The JAX package pins ``Precision.HIGHEST`` where a product must be exact
    fp32 (affine composition, the eval warp's resampling products); TF32
    keeps ~10 mantissa bits and would move coordinates by pixels.
    """
    mm = torch.backends.cuda.matmul
    cudnn = torch.backends.cudnn
    old = (mm.allow_tf32, cudnn.allow_tf32)
    mm.allow_tf32 = False
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = old


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)`` for a flat
    sequence of numbers, made at the first call and shared by every later
    one: on a card a new one is a synchronising copy from pageable memory,
    which also stops a CUDA graph's capture.  Callers read it, never write
    it."""
    key = (tuple(values), dtype, torch.device(device))
    const = _CONSTANTS.get(key)
    if const is None:
        # A normal tensor, usable in and out of inference mode.
        with torch.inference_mode(False):
            const = torch.tensor(key[0], dtype=dtype, device=key[2])
        _CONSTANTS[key] = const
    return const
