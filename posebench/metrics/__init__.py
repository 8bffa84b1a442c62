"""Per-layer metric readers, one module each, found by name.

A metric ``<base>.<path>`` (``device_idle_pct.train``) is read by
``metrics/<base>.py``; its ``read(ctx)`` returns the number, or None where
the traced run holds nothing to read (the harness then leaves the metric
out of the line).  ``ctx`` is a :class:`posebench.harness.Readings`.
"""

import importlib


def reader(name: str):
    return importlib.import_module(f"{__name__}.{name.split('.')[0]}").read
