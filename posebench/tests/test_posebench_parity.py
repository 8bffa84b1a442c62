"""The default backbone path reads as it did before the backbone became a
lookup: the FLOPs, the ported kernels' call shapes and the weights made
from a seed, against numbers recorded from commit b26ddf2
(``parity_default.json``).

The weights are held in two parts.  The drawn leaves (kernels, biases, BN
affines) are hashed and must match to the bit.  The leaves that the
calibrating pass writes (BN running statistics, the score convs' tempered
kernels and biases) come from fp32 sums on the CPU, whose order follows
the thread count and the instruction set (1 and 2 threads differ by
2.3e-7 of a leaf's norm): each leaf's norm is held to 1e-5 of its own.
"""

import hashlib
import json
from pathlib import Path

import pytest

from posebench import harness, inputs
from posebench.metrics._roofline import step_calls

GOLDEN = json.loads(Path(__file__).with_name("parity_default.json").read_text())
CELLS = {"hg8_dsnt_js_train": "hg8-train-resident",
         "resnet50_dsnt_2x": "resnet50-2x-train-resident"}
CALIBRATED = ("running_mean", "running_var")


def digest(state: dict) -> str:
    """sha256 over the leaves in name order: name, dtype, shape, bytes."""
    h = hashlib.sha256()
    for k in sorted(state):
        t = state[k].detach().cpu().contiguous()
        h.update(k.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config", sorted(CELLS))
@pytest.mark.parametrize("case", ["train_32", "serve_1"])
def test_flops(config, case):
    cfg = harness.load_cell(CELLS[config], 1, "cpu").config
    batch, train = (32, True) if case == "train_32" else (1, False)
    assert inputs.flops(cfg, batch, train) == GOLDEN["flops"][config][case]


@pytest.mark.parametrize("config", sorted(CELLS))
@pytest.mark.parametrize("case", ["train_32", "serve_1", "serve_3", "serve_8"])
def test_step_calls(config, case):
    cfg = harness.load_cell(CELLS[config], 1, "cpu").config
    kind, batch = case.split("_")
    assert step_calls(cfg, int(batch), kind == "train") == GOLDEN["calls"][config][case]


@pytest.mark.parametrize("config", sorted(CELLS))
def test_weights(config, tiny):
    cell = tiny(CELLS[config])
    calib = inputs.make_split(4, inputs.canvas_side(cell.config), 5, "cpu")
    w = inputs.make_weights(cell.config, 11, calib, "cpu",
                            **cell.config_file["weights"]["made"])
    want = GOLDEN["weights"][cell.config["model"]["base"]]
    calibrated = set(want["calibrated_norms"])
    assert {k for k in w if k.endswith(CALIBRATED)} <= calibrated
    assert digest({k: v for k, v in w.items() if k not in calibrated}) == want["drawn_sha256"]
    for k, norm in want["calibrated_norms"].items():
        assert float(w[k].double().norm()) == pytest.approx(norm, rel=1e-5), k
