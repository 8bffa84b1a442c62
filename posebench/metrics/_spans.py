"""The program's spans, as its log (``dsnt_pose2d_tpu_torch/utils/spans.py``)
recorded them in the traced run's device-only segment.

:func:`..harness.traced_summary` profiles that segment, then a host and
device one, and each runs ``ctx.units`` units (train steps or requests);
the program logs a unit only while a profiler records.  So the segment's
units are the log's ``[-2u, -u)``.  A span the program opened outside any
unit (the resident gather of a ``k``-step call) is logged before the units
it feeds: those between the unit before the segment and the segment's last
are its own, divided over its units.  Every reader returns None where the
program keeps no such log, the log holds fewer than ``2u`` units, or the
segment holds no span of the name it reads: it never guesses.
"""

from __future__ import annotations


def segment(ctx) -> tuple[list, list]:
    """The device-only segment's units and the spans logged outside any
    unit there, oldest first, or ``([], [])``."""
    try:
        from dsnt_pose2d_tpu_torch.utils import spans
    except ImportError:
        return [], []
    u = ctx.units
    if not u:
        return [], []
    log = spans.log()
    at = [i for i, e in enumerate(log) if isinstance(e, spans.Unit)]
    if len(at) < 2 * u:
        return [], []
    first = at[-2 * u - 1] + 1 if len(at) > 2 * u else 0
    units = [log[i] for i in at[-2 * u:-u]]
    loose = [e for e in log[first:at[-u - 1]] if isinstance(e, spans.Span)]
    return units, loose


def ns(of, name: str, parent=None) -> list:
    """The nanoseconds of each span named ``name`` (under ``parent``, if
    given)."""
    return [s.ns for s in of if s.name == name and (parent is None or s.parent == parent)]


def layer_ms(ctx, layer: str):
    """The milliseconds a unit of the segment spent in the spans
    ``<kind>.<layer>`` (``train.feed``, ``serve.backbone``...), those
    outside the units shared over them."""
    units, loose = segment(ctx)
    if not units:
        return None
    name = f"{units[0].kind}.{layer}"
    hits = ns(loose, name) + [t for x in units for t in ns(x.spans, name)]
    if not hits:
        return None
    return sum(hits) / len(units) / 1e6
