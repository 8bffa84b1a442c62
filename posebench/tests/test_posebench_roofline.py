"""The roofline's bytes and operations at the cells' shapes, against sums
by hand, and the shapes of the calls against the calls the port makes."""

import pytest
import torch

from posebench import harness
from posebench.metrics import _roofline as R
from posebench.metrics._roofline import step_calls

PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}


def test_head_hg8_train():
    # 8 stacks x 32 rows x 16 joints of 64x64 maps, JS.
    rows, hw = 4096, 4096
    assert R.head_fwd(rows, hw, "js") == (4 * 4096 * 4096 + 8 * 4096 + 8 * 4096 + 4 * 4096,
                                          25 * 4096 * 4096)
    assert R.head_fwd(rows, hw, "js") == (67_190_784.0, 419_430_400.0)
    assert R.head_bwd(rows, hw, "js") == (134_299_648.0, 603_979_776.0)


def test_head_resnet_train_and_serve():
    # 32 rows x 16 joints of 56x56 maps, no regularizer.
    assert R.head_fwd(512, 3136, "none") == (6_426_624.0, 11_239_424.0)
    assert R.head_bwd(512, 3136, "none") == (12_849_152.0, 19_267_584.0)
    # A 3-crop hg8 request: 48 rows of 64x64, decode only.
    assert R.head_fwd(48, 4096, "none") == (4 * 48 * 4096 + 8 * 48, 7 * 48 * 4096)


def test_row_shift_sums():
    # hg8 train, pass 1: 32 x 384 rows, 834 px out (384 + 2 * 225), 3 channels.
    assert R.row_shift(12288, 2502, 3) == (4 * 12288 * 2505 + 8 * 12288 + 4 * 12288 * 2502,
                                            3 * 12288 * 2502)
    assert R.row_shift(12288, 2502, 3) == (246_202_368.0, 92_233_728.0)
    # ResNet-50 2x train, pass 3: 32 x 448 rows of 1344 values.
    assert R.row_shift(14336, 1344, 3) == (154_427_392.0, 57_802_752.0)


def test_least_time_is_the_larger_bound():
    nbytes, ops = R.head_fwd(4096, 4096, "js")
    assert R.least_seconds("dsnt_head_fwd", {"rows": 4096, "hw": 4096, "reg": "js"},
                           PEAKS) == pytest.approx(nbytes / 3.35e12)
    assert nbytes / 3.35e12 > ops / 67e12


def test_call_shapes_of_the_cells():
    hg8 = harness.load_cell("hg8-train-resident", 1, "cpu").config
    calls = step_calls(hg8, 32, train=True)
    assert calls["dsnt_head_fwd"] == [{"rows": 4096, "hw": 4096, "reg": "js"}]
    assert calls["row_shift"] == [{"rows": 12288, "out_len": 2502, "stride": 3},
                                  {"rows": 8192, "out_len": 768, "stride": 3}]
    rn = harness.load_cell("resnet50-2x-train-resident", 1, "cpu").config
    calls = step_calls(rn, 32, train=True)
    assert calls["dsnt_head_bwd"] == [{"rows": 512, "hw": 3136, "reg": "none"}]
    assert calls["row_shift"] == [{"rows": 21504, "out_len": 4374, "stride": 3},
                                  {"rows": 14336, "out_len": 1344, "stride": 3}]
    serve = step_calls(hg8, 3, train=False)
    assert serve["dsnt_head_fwd"] == [{"rows": 48, "hw": 4096, "reg": "none"}]
    assert serve["row_shift"][0] == {"rows": 3 * 384, "out_len": 386 * 3, "stride": 3}
    assert "dsnt_head_bwd" not in serve


@pytest.mark.parametrize("name", ["hg8-train-resident", "resnet50-2x-train-resident",
                                  "hg8-serve-photos"])
def test_call_shapes_match_the_port(name, tiny, monkeypatch):
    """At a tiny size, the shapes the harness works out are those of the
    calls the port's step makes."""
    from dsnt_pose2d_tpu_torch.data import augment
    from dsnt_pose2d_tpu_torch.models import heads

    seen = {"dsnt_head_fwd": [], "row_shift": []}
    shift, head = augment.shift_rows, heads.fused_dsnt_head

    def rec_shift(rows, starts, fracs, out_len, stride=1, impl="vec"):
        seen["row_shift"].append({"rows": rows.shape[0], "out_len": out_len, "stride": stride})
        return shift(rows, starts, fracs, out_len, stride, impl)

    def rec_head(raw, t, **kw):
        *lead, h, w = raw.shape
        seen["dsnt_head_fwd"].append({"rows": int(torch.tensor(lead).prod()), "hw": h * w,
                                      "reg": kw["reg"] if t is not None else "none"})
        return head(raw, t, **kw)

    monkeypatch.setattr(augment, "shift_rows", rec_shift)
    monkeypatch.setattr(heads, "fused_dsnt_head", rec_head)
    cell = tiny(name)
    traffic = harness.generator(cell).Traffic(cell)
    fn, units, calls = traffic.traced()
    for v in seen.values():
        v.clear()
    fn()
    assert seen["row_shift"] == calls["row_shift"]
    assert seen["dsnt_head_fwd"] == calls["dsnt_head_fwd"]
    assert len(calls.get("dsnt_head_bwd", [])) == (units if "train" in name else 0)
