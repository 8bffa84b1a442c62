"""Shared orchestration of the ablation drivers (port of
``tools/_ablation_common.py``).

Each ablation (heads, resolution, regularizer) and the flagship report is a
grid of train-then-evaluate runs of the port's CLIs over one data directory
(a prepared MPII layout, or, without one, the CLIs' synthetic fixture); the
subprocess plumbing and the PCKh-table parse live here.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import os
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = str(Path(__file__).resolve().parents[2])

# reg only applies to the dsnt head (paper setup: JS at sigma_t=1).
HEAD_FLAGS = {
    "dsnt": ["--output-strat", "dsnt", "--reg", "js", "--reg-coeff", "1.0"],
    "gauss": ["--output-strat", "gauss"],
    "fc": ["--output-strat", "fc"],
}

TOTAL_RE = re.compile(r"^\s*total\s+([0-9.]+)", re.M)


def run(argv, timeout=14400):
    """Run ``argv`` from the repo's root; its standard output, or, when it
    fails, the tail of its output printed and ``RuntimeError``."""
    print("  $", " ".join(argv), flush=True)
    r = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode != 0:
        print(r.stdout[-2000:])
        print(r.stderr[-4000:])
        raise RuntimeError(f"command failed: {' '.join(argv)}")
    return r.stdout


def run_in_process(argv, timeout=None):
    """:func:`run`'s contract for ``[python, "-m", module, *args]``, in this
    process: ``module.main(args)`` with its standard output captured (and
    echoed).  For a caller whose kernel launch counters must see the CLIs'
    launches; ``timeout`` is not enforced."""
    if argv[1:2] != ["-m"]:
        raise ValueError(f"not a -m command: {argv}")
    print("  $ (in process)", " ".join(argv), flush=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = importlib.import_module(argv[2]).main(list(argv[3:]))
    sys.stdout.write(out.getvalue())
    if rc not in (0, None):
        raise RuntimeError(f"command failed ({rc}): {' '.join(argv)}")
    return out.getvalue()


@contextlib.contextmanager
def in_process():
    """Inside the block the drivers run their CLIs with
    :func:`run_in_process` instead of :func:`run`."""
    global run
    subprocess_run, run = run, run_in_process
    try:
        yield
    finally:
        run = subprocess_run


def parse_total(out: str) -> tuple[float | None, list]:
    """``(total PCKh, table lines)`` of ``cli.evaluate``'s output."""
    table = out[out.index("PCKh"):] if "PCKh" in out else out
    m = TOTAL_RE.search(table)
    return (float(m.group(1)) if m else None), table.strip().splitlines()


def train_and_eval(data_dir: str, out_root: str, experiment_id: str,
                   train_flags: list, device: str = "cuda") -> dict:
    """One grid cell: train with the flags, evaluate, parse the PCKh table.

    Returns ``{"pckh_total": float|None, "train_s": float, "table": [str]}``.
    """
    t0 = time.time()
    # Resume if this grid cell already has checkpoints (interrupted sweep):
    # a fully-trained cell restores past its last epoch and is a no-op.
    resume = (["--resume"] if os.path.isdir(
        os.path.join(out_root, experiment_id, "ckpt")) else [])
    run([sys.executable, "-m", "dsnt_pose2d_tpu_torch.cli.train",
         "--data-dir", data_dir, "--data-source", "auto",
         *train_flags, *resume,
         "--out-dir", out_root, "--experiment-id", experiment_id,
         "--device", device])
    out = run([sys.executable, "-m", "dsnt_pose2d_tpu_torch.cli.evaluate",
               "--model-dir", os.path.join(out_root, experiment_id),
               "--data-dir", data_dir, "--device", device])
    total, table = parse_total(out)
    return {"pckh_total": total, "train_s": round(time.time() - t0, 1),
            "table": table}

