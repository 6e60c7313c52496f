"""The work counts against counts made by hand."""

import json
from pathlib import Path

import pytest

from portbench.harness import load_module

PB = Path(__file__).resolve().parents[1]


def config(name):
    return json.loads((PB / "configs" / f"{name}.json").read_text())


def test_caffenet_flops_by_hand():
    work = load_module(PB / "work" / "caffenet.py")
    got = work.layer_flops(config("caffenet"))
    # 2 * Cout * (Cin / group) * k * k * out_h * out_w, and 2 * K * N
    hand = {"conv1": 2 * 96 * 3 * 11 * 11 * 55 * 55, "conv2": 2 * 256 * 48 * 5 * 5 * 27 * 27,
            "conv3": 2 * 384 * 256 * 3 * 3 * 13 * 13, "conv4": 2 * 384 * 192 * 3 * 3 * 13 * 13,
            "conv5": 2 * 256 * 192 * 3 * 3 * 13 * 13, "fc6": 2 * 9216 * 4096,
            "fc7": 2 * 4096 * 4096, "fc8": 2 * 4096 * 1000}
    assert got == hand
    assert work.counts(config("caffenet"), {})["flops_per_item"] == sum(hand.values())


def test_resnet152_stage_flops_at_688():
    """bench.py's per-stage count at a 688x688 canvas, in GFLOP (copied):
    conv1 2.2, res2 12.6, res3 34.4, res4 149.8, res5 55.3, all heads 30.8,
    257.4 for the trunk with the pose and locref heads alone."""
    work = load_module(PB / "work" / "deepercut-r152.py")
    cfg = config("deepercut-r152")
    every = work.stage_flops(cfg, (688, 688), ["pose", "locref", "next"])
    for stage, gflop in {"conv1": 2.2, "res2": 12.6, "res3": 34.4, "res4": 149.8, "res5": 55.3,
                         "heads": 30.8}.items():
        assert every[stage] / 1e9 == pytest.approx(gflop, abs=0.06), stage  # 0.1 GFLOP rounding
    assert sum(work.stage_flops(cfg, (688, 688)).values()) / 1e9 == pytest.approx(257.4, abs=0.1)


def test_resnet152_epilogue_bytes_by_hand():
    """conv1's epilogue at the 704 canvas: a (64, 352, 352) f32 output read
    and written, no residual; res2a's branch2c adds its residual read."""
    work = load_module(PB / "work" / "deepercut-r152.py")
    layers = work.convs(config("deepercut-r152"), (704, 704))
    assert layers[0]["out"] == (352, 352) and not layers[0]["residual"]
    assert [c["residual"] for c in layers[1:5]] == [False, False, False, True]
    assert layers[4]["out"] == (176, 176) and layers[4]["cout"] == 256
    assert len(layers) == 1 + 3 * 50 + 4 + 2 * 2
    mix = {"item_hw": [688, 688], "scale": 1.0, "bucket_step": 64, "batch": 8}
    want = sum(4 * c["cout"] * c["out"][0] * c["out"][1] * (3 if c["residual"] else 2)
               + 4 * c["cout"] / 8 for c in layers)
    assert work.counts(config("deepercut-r152"), mix)["epilogue_bytes_per_item"] == pytest.approx(want)
