"""launches_per_step.*: kernels that ran on the device in the traced
window, per train step traced."""


def read(ctx):
    if not ctx.units or not ctx.trace.launches:
        return None
    return ctx.trace.launches / ctx.units
