"""On the card, at each cell's own size: the program's readings stay within
the cell's limits, and each control put in its place (fp8, half the batch)
breaks at least one of them.  About a minute a cell; skipped without a
card."""

import pytest

from posebench import calibrate, compare, harness

CELLS = ["hg8-train-resident", "resnet50-2x-train-resident", "hg8-serve-photos"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_controls_fail_on_the_card(name, card):
    cell = harness.load_cell(name, 3_900_000_001)
    seconds = 4.0 if cell.traffic["generator"] == "photo_requests" else 0.0
    got = calibrate.readings(name, cell.seed, seconds, ["fp8", "half_batch"], cell=cell)
    assert compare.judge(got["program"], cell.limits)[0], got["program"]
    for control in ("fp8", "half_batch"):
        assert not compare.judge(got[control], cell.limits)[0], (control, got[control])
