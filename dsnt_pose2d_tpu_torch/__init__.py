"""PyTorch + CUDA port of ``dsnt_pose2d_tpu/`` for NVIDIA Hopper (H100).

The JAX package ``dsnt_pose2d_tpu/`` is the reference; this package mirrors
its layout module by module.  It imports ``torch`` and numpy only, never JAX
or any module of the JAX package.  Every Pallas kernel on the ported path is
a CUDA C++ kernel written for ``sm_90a`` (:mod:`.ops.cuda`), with a plain
PyTorch version beside it that CPU tensors go to.

Ported so far: the forward-only eval/serve path of the DSNT pose models
(config, ops, fused DSNT head, eval preprocessing, hourglass backbone, dsnt
head, PCKh, and the infer/eval steps of :mod:`.train.loop`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
