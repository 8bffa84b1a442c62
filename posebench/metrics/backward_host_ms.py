"""backward_host_ms.*: the host's milliseconds per train step in the
program's ``train.backward`` span (``loss.backward()``, which the main
thread waits in), over the traced run's device-only segment
(:mod:`._spans`)."""

from ._spans import layer_ms


def read(ctx):
    return layer_ms(ctx, "backward")
