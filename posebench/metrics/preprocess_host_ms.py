"""preprocess_host_ms.*: the host's milliseconds per train step or request
in the program's ``train.preprocess`` or ``serve.preprocess`` spans (the
shear warp, jitter and normalisation), over the traced run's device-only
segment (:mod:`._spans`)."""

from ._spans import layer_ms


def read(ctx):
    return layer_ms(ctx, "preprocess")
