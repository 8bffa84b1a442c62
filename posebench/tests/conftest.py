"""Shared fixtures of the harness's tests: tiny CPU versions of the cells,
and the card's presence decided inside a fixture."""

import copy

import pytest
import torch

from posebench import harness


@pytest.fixture
def card():
    """Skips the test where there is no NVIDIA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def tiny_cell(name: str, seed: int = 7, device: str = "cpu") -> harness.Cell:
    """The cell with its limits, its traffic's kind and its head, at a size
    a CPU test holds: an fp32 hg1 of 32 features and depth 2 (or a ResNet-18)
    at 64 px, batch 4, a split of 32 rows or a pool of 24."""
    cell = harness.load_cell(name, seed, device=device)
    cfg = copy.deepcopy(cell.config_file)
    m = cfg["config"]["model"]
    if m["base"].startswith("hg"):
        m.update(base="hg1", hg_features=32, hg_depth=2, input_size=64, dtype="float32")
    else:
        m.update(base="resnet18", input_size=64, dtype="float32")
    cfg["config"]["train"]["batch_size"] = 4
    cell.config_file = cfg
    t = dict(cell.traffic)
    if t["generator"] == "resident_train":
        t.update(rows=32, calibration_rows=4)
    else:
        t.update(pool_rows=24, calibration_rows=4, check_requests=8, trace_requests=2,
                 max_requests=2000, warmup_per_size=1)
    cell.traffic = t
    return cell


@pytest.fixture
def tiny():
    """:func:`tiny_cell`, for tests to call with a cell's name."""
    return tiny_cell
