"""The HRNet-W48 cell through the harness on the CPU: the port's and the
reference's ``hrnet_w48`` both set to a tiny plan (widths 8/16/32/64, one
BasicBlock a branch, one module a stage, one stage-1 bottleneck) at 64 px
in fp32, so that the cell's own path runs: the reference module's weights
and residual scaling, the calibrating pass, the program's resident steps
and the comparison under the cell's limits."""

import copy

import pytest
import torch

from dsnt_pose2d_tpu_torch.models import factory, hrnet
from posebench import harness
from posebench.reference import hrnet as RH
from posebench.reference import model as M

CELL = "hrnet-w48-train-resident"
TINY = {"widths": (8, 16, 32, 64), "blocks": 1, "modules": (1, 1, 1), "stage1_blocks": 1}


@pytest.fixture
def built(monkeypatch):
    """Sets both sides' ``hrnet_w48`` to :data:`TINY`; the list it returns
    gathers every backbone either side builds."""
    monkeypatch.setitem(hrnet.HRNET_SPECS, "hrnet_w48", TINY)
    monkeypatch.setitem(RH.SPECS, "hrnet_w48", TINY)
    nets = []

    def port(*args, **kwargs):
        nets.append(hrnet.HRNetPose(*args, **kwargs))
        return nets[-1]

    def ref(model):
        nets.append(RH.HRNetPose(model.get("num_joints", 16), **RH.SPECS[model["base"]]))
        return nets[-1]

    monkeypatch.setattr(factory, "HRNetPose", port)
    monkeypatch.setattr(RH, "backbone", ref)
    return nets


def _cell(seed: int) -> harness.Cell:
    cell = harness.load_cell(CELL, seed, device="cpu")
    cfg = copy.deepcopy(cell.config_file)
    cfg["config"]["model"].update(input_size=64, dtype="float32")
    cfg["config"]["train"]["batch_size"] = 4
    cell.config_file = cfg
    cell.traffic = {**cell.traffic, "rows": 32, "calibration_rows": 4}
    return cell


@pytest.mark.parametrize("seed", [7, 2_100_000_011])
def test_result_line(built, seed):
    cell = _cell(seed)
    out = harness.run_cell(cell, 0.5, False, 0.0)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"peak_mem_gib", "setup_s"}
    assert set(out["checks"]) == set(cell.limits) == {"grad1_gap", "grad1_median_gap",
                                                      "change_median_gap", "grad1_norm_rel"}
    for check in out["checks"].values():
        assert 0 <= check["value"] < check["limit"]
    assert {type(n) for n in built} == {hrnet.HRNetPose, RH.HRNetPose}
    assert all(n.stage1_blocks == 1 for n in built)


def test_residual_scaling_leaves_the_fuse_terms(built):
    """The configuration's ``weights.residual``: the BasicBlocks' ``bn2``
    and the bottleneck's ``bn3`` at the residual scale, every other BN
    (the fuse terms', the transitions', the stem's) at 1."""
    cfg = _cell(7).config_file["config"] | {"reference": "hrnet"}
    net = M.PoseNet(cfg)
    RH.scale_residual_(net, 0.25)
    last = {id(m.bn2) for m in net.modules() if isinstance(m, M.BasicBlock)}
    last |= {id(m.bn3) for m in net.modules() if isinstance(m, M.BottleneckBlock)}
    bns = [m for m in net.modules() if isinstance(m, M.BatchNorm)]
    fuse = [m for name, m in net.named_modules() if ".fuse" in name and isinstance(m, M.BatchNorm)]
    assert len(last) == 10 and len(fuse) == 12 and len(bns) == 40
    for m in bns:
        want = 0.25 if id(m) in last else 1.0
        assert torch.all(m.weight == want)
