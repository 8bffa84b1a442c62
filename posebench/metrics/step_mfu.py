"""step_mfu.*: the whole step's share of the card's peak, in %: the
model's FLOPs over the untraced window (counted after it on the meta
device from the reference and the cell's shapes, never from what the
program dispatches) over the window's host-clock seconds and the peak of the configuration's
compute type (bf16: 989 TFLOP/s)."""


def read(ctx):
    w = ctx.window
    if not w.get("flops") or not w.get("seconds"):
        return None
    peak = ctx.peaks[f"{ctx.compute_dtype}_flops_per_s"]
    return 100.0 * w["flops"] / w["seconds"] / peak
