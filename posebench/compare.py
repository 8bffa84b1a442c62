"""The numbers that decide ``correct``, and the judgment against limits.

Training: each followed step's loss, each leaf's gradient norm at step 1
and each leaf's change after the last followed step, program against
reference.  A leaf's gap is ``|program - reference|`` over the larger of
the reference's value for that leaf and its median leaf's, and the worst
leaf is what counts.  The change leaves out leaves whose reference gradient
is under a thousandth of the median leaf's: under RMSProp they move by
round-off alone.

Serving: the widest and the mean gap, in original-image pixels, between
the served predictions and the reference's for the same crops.

Every reading is computed; a cell's limits name the ones it compares.
"""

from __future__ import annotations

import math

import torch

ROUND_OFF_SHARE = 1e-3


def median(values) -> float:
    return torch.tensor(list(values), dtype=torch.float64).median().item()


def leaf_gaps(prog: dict, ref: dict, names: list) -> dict:
    """Each leaf's gap over ``names``: ``|program - reference|`` over the
    larger of the reference's value and its median leaf's (over all its
    leaves); a leaf the program lacks reads infinite."""
    floor = median(ref.values())
    return {n: abs(prog.get(n, math.inf) - ref[n]) / max(ref[n], floor) for n in names}


def _global(norms: dict) -> float:
    return math.sqrt(sum(v * v for v in norms.values()))


def train_readings(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` hold ``losses`` (one a step), and ``grad1`` and
    ``change`` (leaf name -> norm)."""
    if len(prog["losses"]) != len(ref["losses"]):
        loss_rel = math.inf
    else:
        loss_rel = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    g = ref["grad1"]
    moved = [n for n, v in g.items() if v >= ROUND_OFF_SHARE * median(g.values())]
    grad = leaf_gaps(prog["grad1"], g, list(g))
    change = leaf_gaps(prog["change"], ref["change"], moved)
    return {"loss_rel": loss_rel,
            "loss1_rel": abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "grad1_gap": max(grad.values(), default=math.inf),
            "grad1_median_gap": median(grad.values()),
            "grad1_norm_rel": abs(_global(prog["grad1"]) - _global(g)) / _global(g),
            "change_gap": max(change.values(), default=math.inf),
            "change_median_gap": median(change.values())}


def serve_readings(prog: torch.Tensor, ref: torch.Tensor) -> dict:
    """The widest and the mean gap, in original-image pixels, over every
    coordinate of the compared crops."""
    if prog.shape != ref.shape or not prog.numel():
        return {"pred_gap_px": math.inf, "pred_gap_mean_px": math.inf}
    gap = (prog.double() - ref.double()).abs()
    return {"pred_gap_px": float(gap.max()), "pred_gap_mean_px": float(gap.mean())}


def judge(readings: dict, limits: dict) -> tuple[bool, list]:
    """``(correct, [(name, value, limit)])``: correct when every number is
    finite and within its limit."""
    rows = [(k, readings.get(k, math.inf), limits[k]) for k in sorted(limits)]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
