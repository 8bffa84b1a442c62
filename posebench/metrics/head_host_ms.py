"""head_host_ms.*: the host's milliseconds per train step or request in the
program's ``train.head`` or ``serve.head`` spans (train: the fused head's
forward and the loss; serve: the decode and the map to original-image
pixels), over the traced run's device-only segment (:mod:`._spans`)."""

from ._spans import layer_ms


def read(ctx):
    return layer_ms(ctx, "head")
