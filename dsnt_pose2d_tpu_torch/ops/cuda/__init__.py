"""Hand-written Hopper kernels (CUDA C++ for ``sm_90a``) with plain versions.

=============  ===============================  ============  ============================================
kernel         wrapper                          source        replaces (TPU kernel)
=============  ===============================  ============  ============================================
dsnt_head_fwd  fused_dsnt_head (forward)        dsnt_head.cu  ops/pallas/dsnt_head.py::_fwd_kernel
dsnt_head_bwd  fused_dsnt_head (its backward),  dsnt_head.cu  ops/pallas/dsnt_head.py::_bwd_kernel
               fused_dsnt_head_bwd
row_shift      shift_rows                       row_shift.cu  ops/pallas/row_shift.py::_kernel_vec/_legacy
=============  ===============================  ============  ============================================

Each wrapper launches its kernel for a CUDA tensor and runs its plain
PyTorch version for a CPU tensor, and counts its kernel launches.
"""

from . import dsnt_head, row_shift
from .dsnt_head import (MAX_HW, PREACT_KINDS, REG_KINDS, fused_dsnt_head,
                        fused_dsnt_head_bwd, fused_dsnt_head_bwd_reference,
                        fused_dsnt_head_reference)
from .row_shift import shift_rows, shift_rows_reference

# kernel -> (module, name of its launch counter in that module)
KERNEL_MODULES = {
    "dsnt_head_fwd": (dsnt_head, "fwd_launches"),
    "dsnt_head_bwd": (dsnt_head, "bwd_launches"),
    "row_shift": (row_shift, "launches"),
}


def launch_counts() -> dict:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return {name: getattr(mod, counter)
            for name, (mod, counter) in KERNEL_MODULES.items()}


def reset_launch_counts():
    for mod, counter in KERNEL_MODULES.values():
        setattr(mod, counter, 0)


__all__ = [
    "KERNEL_MODULES", "MAX_HW", "PREACT_KINDS", "REG_KINDS", "fused_dsnt_head",
    "fused_dsnt_head_bwd", "fused_dsnt_head_bwd_reference", "fused_dsnt_head_reference",
    "launch_counts", "reset_launch_counts", "shift_rows", "shift_rows_reference",
]
