"""Hand-written Hopper kernels (CUDA C++ for ``sm_90a``) with plain versions.

=================  ==================  ==============================================
wrapper            source              replaces (TPU kernel)
=================  ==================  ==============================================
fused_dsnt_head    dsnt_head.cu        ops/pallas/dsnt_head.py::_fwd_kernel
shift_rows         row_shift.cu        ops/pallas/row_shift.py::_kernel_vec/_legacy
=================  ==================  ==============================================

Each wrapper launches its kernel for a CUDA tensor and runs its plain
PyTorch version for a CPU tensor, and counts its kernel launches.
"""

from . import dsnt_head, row_shift
from .dsnt_head import (MAX_HW, PREACT_KINDS, REG_KINDS, fused_dsnt_head,
                        fused_dsnt_head_reference)
from .row_shift import shift_rows, shift_rows_reference

KERNEL_MODULES = {"dsnt_head_fwd": dsnt_head, "row_shift": row_shift}


def launch_counts() -> dict:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts():
    for mod in KERNEL_MODULES.values():
        mod.launches = 0


__all__ = [
    "MAX_HW", "PREACT_KINDS", "REG_KINDS", "fused_dsnt_head", "fused_dsnt_head_reference",
    "launch_counts", "reset_launch_counts", "shift_rows", "shift_rows_reference",
]
