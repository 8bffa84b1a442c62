"""Run one cell of the benchmark once and print its result line.

    python3 -m posebench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the repository's root.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and ``checks`` last: each number compared
beside its limit); the last lines of standard error give the same checks.
With ``--trace 0`` the metrics are the cell's end-to-end ones, with
``--trace 1`` its per-layer ones.  Without a card, or with fewer cards than
the cell asks for, or where JAX or the JAX package got loaded, it exits
non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dsnt_pose2d_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's, optax's or the
    JAX package's (compared whole: the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from posebench import harness

    torch.set_num_threads(1)
    cell = harness.load_cell(args.workload, args.seed)
    if not torch.cuda.is_available():
        print("posebench: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.workload["chips"]:
        print(f"posebench: {args.workload} needs {cell.workload['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seconds, bool(args.trace), T_START)
    out["device"]["power"] = power_limit()
    bad = forbidden_modules()
    if bad:
        print(f"posebench: loaded {', '.join(bad)} in the measured process",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
