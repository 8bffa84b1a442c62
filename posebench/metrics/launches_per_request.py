"""launches_per_request.*: kernels that ran on the device in the traced
window, per request traced."""


def read(ctx):
    if not ctx.units or not ctx.trace.launches:
        return None
    return ctx.trace.launches / ctx.units
