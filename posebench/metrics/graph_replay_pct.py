"""graph_replay_pct.*: the share of the traced run's device-only segment's
units (requests) that replayed a CUDA graph, in %: those whose spans hold
``<kind>.graph`` (``dsnt_pose2d_tpu_torch/train/loop.py``'s serving step
opens ``serve.graph`` around a replay) (:mod:`._spans`).  None where no
unit of the segment holds one: a program without the graph."""

from ._spans import ns, segment


def read(ctx):
    units, _ = segment(ctx)
    if not units:
        return None
    name = f"{units[0].kind}.graph"
    hits = sum(1 for x in units if ns(x.spans, name))
    if not hits:
        return None
    return 100.0 * hits / len(units)
