"""Build the CUDA sources of this directory at first use and load them.

Each ``<name>.cu`` is compiled by ``nvcc`` on its own into a shared library
with a plain C interface (``extern "C"`` launchers taking raw pointers and a
``cudaStream_t``), which :mod:`ctypes` loads.  Nothing includes PyTorch's
headers, so a build takes seconds.  Libraries go to ``_build/`` beside the
sources (listed in ``.gitignore``), named by a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.

A build that fails raises :class:`RuntimeError` with the compiler's output;
nothing falls back to the plain PyTorch versions.  Call :func:`build_all` to
start one ``nvcc`` per source at once; :func:`load` builds one on demand.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "_build"
SOURCES = ("dsnt_head", "row_shift", "calib", "batch_norm")
# sm_90a: Hopper with its architecture-specific features.  No --use_fast_math
# and no -ftz: the kernels keep full-precision expf/logf, IEEE division and
# denormals.  -Xptxas=-v writes registers/shared memory per kernel to the log.
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: dict = {}


def nvcc_path() -> str:
    """The ``nvcc`` to use: ``$CUDA_HOME/bin``, then ``PATH``, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    """The shared library built from ``name``.cu (named by source and flags)."""
    if name not in SOURCES:
        raise ValueError(f"unknown CUDA source {name!r}")
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's output for ``name`` (ptxas register/shared-memory lines)."""
    return lib_path(name).with_suffix(".log")


def build_all(names=SOURCES) -> dict:
    """Compile every source in ``names`` that is not built yet, one ``nvcc``
    each, all started together.  Returns ``{name: seconds}`` for those."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        with open(log_path(name), "w") as log:
            jobs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                          tmp, out)
    took, failures = {}, []
    for name, (proc, tmp, out) in jobs.items():
        rc = proc.wait()
        if rc != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed for {name}.cu (exit {rc}):\n"
                            + log_path(name).read_text())
            continue
        os.replace(tmp, out)      # atomic: a reader never sees half a library
        took[name] = time.perf_counter() - t0
    if failures:
        raise RuntimeError("\n".join(failures))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    if name not in _libs:
        build_all((name,))
        _libs[name] = ctypes.CDLL(str(lib_path(name)))
    return _libs[name]
