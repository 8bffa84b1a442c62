"""Hand-written Hopper kernels (CUDA C++ for ``sm_90a``) with plain versions.

=============  ===============================  ============  ============================================
kernel         wrapper                          source        replaces (TPU kernel)
=============  ===============================  ============  ============================================
dsnt_head_fwd  fused_dsnt_head (forward)        dsnt_head.cu  ops/pallas/dsnt_head.py::_fwd_kernel
dsnt_head_bwd  fused_dsnt_head (its backward),  dsnt_head.cu  ops/pallas/dsnt_head.py::_bwd_kernel
               fused_dsnt_head_bwd
row_shift      shift_rows                       row_shift.cu  ops/pallas/row_shift.py::_kernel_vec/_legacy
calib_copy     calib_copy                       calib.cu      bench_kernel.py::calibrate::_copy_k
calib_exp      calib_exp                        calib.cu      bench_kernel.py::calibrate::_exp_k
calib_smax     calib_smax                       calib.cu      bench_kernel.py::calibrate::_smax_k
bn_fwd         batch_norm_train (forward)       batch_norm.cu none: the JAX package leaves train-mode BN
                                                              to XLA, which fuses it; the port's torch-op
                                                              composition took most of the training
                                                              steps' device time and launches
bn_bwd         batch_norm_train (its backward)  batch_norm.cu none (as bn_fwd)
=============  ===============================  ============  ============================================

Each wrapper launches its kernel for a CUDA tensor and runs its plain
PyTorch version for a CPU tensor, and counts its kernel launches (``bn_fwd``
and ``bn_bwd`` count calls: two kernels each, ``bn_stats_kernel`` then
``bn_fwd_kernel``, ``bn_dstats_kernel`` then ``bn_bwd_kernel``).  A wrapper
called inside a CUDA graph's capture counts a launch that did not run: the
capturing code takes it back, and adds it at each replay
(:func:`add_launch_counts`).
"""

from . import batch_norm, calib, dsnt_head, row_shift
from .batch_norm import (batch_norm_train, batch_norm_train_bwd_reference,
                         batch_norm_train_reference)
from .dsnt_head import (MAX_HW, PREACT_KINDS, REG_KINDS, fused_dsnt_head,
                        fused_dsnt_head_bwd, fused_dsnt_head_bwd_reference,
                        fused_dsnt_head_reference)
from .row_shift import shift_rows, shift_rows_reference

# kernel -> (module, name of its launch counter in that module)
KERNEL_MODULES = {
    "dsnt_head_fwd": (dsnt_head, "fwd_launches"),
    "dsnt_head_bwd": (dsnt_head, "bwd_launches"),
    "row_shift": (row_shift, "launches"),
    "calib_copy": (calib, "copy_launches"),
    "calib_exp": (calib, "exp_launches"),
    "calib_smax": (calib, "smax_launches"),
    "bn_fwd": (batch_norm, "fwd_launches"),
    "bn_bwd": (batch_norm, "bwd_launches"),
}


def launch_counts() -> dict:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return {name: getattr(mod, counter)
            for name, (mod, counter) in KERNEL_MODULES.items()}


def reset_launch_counts():
    for mod, counter in KERNEL_MODULES.values():
        setattr(mod, counter, 0)


def add_launch_counts(counts: dict):
    """Add ``counts`` (kernel -> launches, negative to take away) to the
    counters: the replay of a CUDA graph launches the kernels that its
    capture counted without running them."""
    for name, n in counts.items():
        mod, counter = KERNEL_MODULES[name]
        setattr(mod, counter, getattr(mod, counter) + n)


__all__ = [
    "KERNEL_MODULES", "add_launch_counts", "batch_norm_train", "batch_norm_train_bwd_reference",
    "batch_norm_train_reference", "MAX_HW", "PREACT_KINDS", "REG_KINDS", "fused_dsnt_head",
    "fused_dsnt_head_bwd", "fused_dsnt_head_bwd_reference", "fused_dsnt_head_reference",
    "launch_counts", "reset_launch_counts", "shift_rows", "shift_rows_reference",
]
