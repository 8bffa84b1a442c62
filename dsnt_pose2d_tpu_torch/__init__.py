"""PyTorch + CUDA port of ``dsnt_pose2d_tpu/`` for NVIDIA Hopper (H100).

The JAX package ``dsnt_pose2d_tpu/`` is the reference; this package mirrors
its layout module by module.  It imports ``torch`` and numpy only, never JAX
or any module of the JAX package.  Every Pallas kernel on the ported path is
a CUDA C++ kernel written for ``sm_90a`` (:mod:`.ops.cuda`), with a plain
PyTorch version beside it that CPU tensors go to.

Ported so far: the train, evaluate and infer CLIs (:mod:`.cli`), the
eval/serve path with flip and multi-scale eval, the train step and the
Trainer of the DSNT hourglass models (config, ops, the fused DSNT head's
forward and backward, preprocessing with train augmentation, the hourglass
in train and eval mode, dsnt head, PCKh, optimizer and schedule in
:mod:`.train.state`, the train/infer/eval steps, the eval passes, the epoch
loop with auto-pack and ``EvalDriver`` of :mod:`.train.loop`, checkpoints
in :mod:`.train.checkpoint`, metric records in :mod:`.train.metrics`), the
host data path (:mod:`.data`: MPII reader, packer, prepare, loader,
resident splits; :mod:`.native`: the JPEG canvas decoder), the benches
(:mod:`.bench`) and data parallelism over processes (:mod:`.parallel`:
one process per card under ``torchrun``, global-batch BN, loss and
gradients, host-split loaders and sharded resident splits).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
