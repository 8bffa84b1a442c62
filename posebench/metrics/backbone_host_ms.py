"""backbone_host_ms.*: the host's milliseconds per train step or request in
the program's ``train.backbone`` or ``serve.backbone`` spans (the model's
forward, its BN calls included), over the traced run's device-only
segment (:mod:`._spans`)."""

from ._spans import layer_ms


def read(ctx):
    return layer_ms(ctx, "backbone")
