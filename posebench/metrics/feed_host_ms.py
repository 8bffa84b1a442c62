"""feed_host_ms.*: the host's milliseconds per train step or request in
the program's ``train.feed`` or ``serve.feed`` spans (train: the resident
gather, the copy to the device and the augmentation draws; serve: the
crops' copy to the device), over the traced run's device-only segment
(:mod:`._spans`)."""

from ._spans import layer_ms


def read(ctx):
    return layer_ms(ctx, "feed")
