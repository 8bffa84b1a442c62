"""optimizer_host_ms.*: the host's milliseconds per train step in the
program's ``train.optimizer`` spans (``zero_grad``, and the optimizer
chain's global norm, clip and RMSProp update), over the traced run's
device-only segment (:mod:`._spans`)."""

from ._spans import layer_ms


def read(ctx):
    return layer_ms(ctx, "optimizer")
