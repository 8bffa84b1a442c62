"""A/B of the 2x2/2 max-pool's two formulations, forward + backward, on the
card (port of ``tools/bench_maxpool.py``).

The JAX tool weighed ``nn.max_pool`` (whose gradient lowers to XLA's slow
SelectAndScatter on a TPU) against a reshape -> max over the two window
axes.  The port's hourglass pools with ``F.max_pool2d(x, 2, 2)``
(``models/hourglass.py``); this times it against the reshape-``amax``
pool at the JAX tool's shapes, batch first and in the port's NCHW layout,
bf16: the stem's (B, 64, 192, 192) and the four recursion levels' (B, 256,
s, s), s = 64, 32, 16, 8.  Each formulation's time is the device time of
one forward + backward of ``sum(pool(x).float() ** 2)``
(:func:`..bench.timing.device_ms`, ``--iters`` calls back to back).

The forward is bit-identical.  The gradients differ only inside windows
whose maximum is tied: ``max_pool2d`` gives the whole gradient to the one
element its forward recorded (the JAX tool's "first wins"), ``amax``
splits it evenly among the tied ones (bf16's 8-bit mantissa makes ties
common); the script checks that every
difference lies in a tied window and prints the largest.

Usage: python -m dsnt_pose2d_tpu_torch.tools.bench_maxpool [--batch 16] [--iters 30] [--device cpu]

The last line is one JSON object: ``{"shapes": [...]}``.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from ..cli.common import add_device_arg
from ..device import resolve_device


def window_pool(x):
    return F.max_pool2d(x, 2, 2)


def reshape_pool(x):
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 2, 2, w // 2, 2).amax(dim=(3, 5))


def shapes_for(batch: int) -> list:
    """The hourglass's pool inputs at ``batch`` (NCHW): the stem, then each
    of a stack's 4 recursion levels."""
    return [(batch, 64, 192, 192)] + [(batch, 256, s, s) for s in (64, 32, 16, 8)]


def _grad(fn, x):
    x = x.detach().requires_grad_(True)
    (g,) = torch.autograd.grad((fn(x).float() ** 2).sum(), x)
    return g


def tied_windows(x) -> torch.Tensor:
    """Per 2x2 window: True where its maximum occurs more than once."""
    b, c, h, w = x.shape
    win = x.reshape(b, c, h // 2, 2, w // 2, 2)
    top = win.amax(dim=(3, 5), keepdim=True)
    return (win == top).sum(dim=(3, 5)) > 1


def run(batch: int = 16, iters: int = 30, device="cuda", shapes=None,
        log=print) -> list[dict]:
    from ..bench.timing import device_ms, host_ms

    dev = resolve_device(device)
    timer = device_ms if dev.type == "cuda" else host_ms
    records = []
    for shape in shapes or shapes_for(batch):
        x = torch.randn(shape, generator=torch.Generator().manual_seed(0)).to(
            dev, torch.bfloat16)
        ms = {name: timer(lambda fn=fn: _grad(fn, x), iters)[0]
              for name, fn in (("window", window_pool), ("reshape", reshape_pool))}
        fwd_eq = bool(torch.equal(window_pool(x), reshape_pool(x)))
        gw, gr = _grad(window_pool, x), _grad(reshape_pool, x)
        diff = (gw.float() - gr.float()).abs()
        b, c, h, w = shape
        per_window = diff.reshape(b, c, h // 2, 2, w // 2, 2).amax(dim=(3, 5))
        ties = tied_windows(x)
        rec = {"shape": list(shape), "window_ms": ms["window"],
               "reshape_ms": ms["reshape"],
               "speedup": ms["window"] / ms["reshape"], "fwd_equal": fwd_eq,
               "max_abs_grad_diff": float(diff.max()),
               "windows_differing": int((per_window > 0).sum()),
               "tied_windows": int(ties.sum()),
               "every_difference_in_a_tie": bool(not (per_window > 0)[~ties].any())}
        log(f"{str(tuple(shape)):>22}  window {ms['window']:7.3f} ms  reshape "
            f"{ms['reshape']:7.3f} ms  speedup {rec['speedup']:5.2f}x  "
            f"fwd_equal={fwd_eq}  max|dgrad| {rec['max_abs_grad_diff']:.3g} in "
            f"{rec['windows_differing']} of {rec['tied_windows']} tied windows "
            "(ties: reshape splits evenly, window gives one element all)")
        records.append(rec)
    return records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--iters", type=int, default=30)
    add_device_arg(p)
    args = p.parse_args(argv)
    print(json.dumps({"shapes": run(args.batch, args.iters, args.device)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
