"""serve_peak_mem_gib: the device memory allocated at its highest over the
serving window (``torch.cuda.max_memory_allocated`` after a reset at the
window's start), in GiB."""


def read(ctx):
    peak = ctx.window.get("peak_bytes")
    return None if not peak else peak / 2 ** 30
