"""row_shift_roofline_pct.*: the row_shift kernel's share of its roofline over
the traced calls, in %: the least time their shapes need
(:mod:`._roofline`) over the device time the trace gives its launches."""

from ._roofline import share_pct


def read(ctx):
    return share_pct(ctx, "row_shift")
