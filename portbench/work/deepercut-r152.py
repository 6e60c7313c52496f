"""Work counts of the DeeperCut ResNet-152 serving forward, from its shapes.

FLOPs count 2 per multiply-add of every convolution and deconvolution on
the serving path (the trunk and the heads that `serving_heads` names); the
pools, ReLUs, BatchNorms folded away and the decode are left out. The conv
epilogue's bytes count, for every convolution, its f32 output read once
and written once, its f32 residual read once where the block adds one
(each branch2c, and each head's skip conv, which adds the cropped deconv
output), and its f32 bias read once per call.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple


def _out(size: int, k: int, s: int, p: int, d: int = 1) -> int:
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


def _names(cfg: dict, stage: int) -> List[str]:
    n, label = cfg["depths"][stage], stage + 2
    if cfg["block_naming"] == "letters" or n <= 3:
        return [f"{label}{chr(ord('a') + i)}" for i in range(n)]
    return [f"{label}a"] + [f"{label}b{i}" for i in range(1, n)]


def convs(cfg: dict, hw: Tuple[int, int], heads=None) -> List[dict]:
    """Every convolution of the forward on an (H, W) canvas, in order:
    {stage, cin, cout, k, out (h, w), macs, residual}."""
    heads = cfg["serving_heads"] if heads is None else heads
    out = []

    def conv(stage, cin, cout, k, o, residual=False, transposed=False, in_hw=None):
        area = (in_hw[0] * in_hw[1]) if transposed else (o[0] * o[1])
        out.append(dict(stage=stage, cin=cin, cout=cout, k=k, out=o, residual=residual,
                        macs=cin * cout * k * k * area))

    h, w = _out(hw[0], 7, 2, 3), _out(hw[1], 7, 2, 3)
    conv("conv1", 3, cfg["stem_channels"], 7, (h, w))
    h, w = -(-(h - 3) // 2) + 1, -(-(w - 3) // 2) + 1
    cin, skip = cfg["stem_channels"], None
    for stage, width in enumerate(cfg["stage_widths"]):
        cout = cfg["expansion"] * width
        s, d = cfg["stage_strides"][stage], cfg["stage_dilations"][stage]
        label = f"res{stage + 2}"
        for bi, _ in enumerate(_names(cfg, stage)):
            bs = s if bi == 0 else 1
            oh, ow = _out(h, 1, bs, 0), _out(w, 1, bs, 0)
            if bi == 0:
                conv(label, cin, cout, 1, (oh, ow))
            conv(label, cin if bi == 0 else cout, width, 1, (oh, ow))
            conv(label, width, width, 3, (_out(oh, 3, 1, d, d), _out(ow, 3, 1, d, d)))
            conv(label, width, cout, 1, (oh, ow), residual=True)
            h, w = oh, ow
        cin = cout
        if stage == 1:
            skip = (cout, h, w)
    j = cfg["num_joints"]
    chans = {"pose": j, "locref": 2 * j, "next": j * (j - 1) * 2}
    for head in heads:
        ch = chans[head]
        conv("heads", cin, ch, 3, (2 * (h - 1) + 3, 2 * (w - 1) + 3), transposed=True,
             in_hw=(h, w))
        conv("heads", skip[0], ch, 1, (skip[1], skip[2]), residual=True)
    return out


def stage_flops(cfg: dict, hw: Tuple[int, int], heads=None) -> Dict[str, float]:
    """FLOPs of one image by stage: conv1, res2 .. res5, heads."""
    out: Dict[str, float] = {}
    for c in convs(cfg, hw, heads):
        out[c["stage"]] = out.get(c["stage"], 0.0) + 2.0 * c["macs"]
    return out


def canvas_hw(cfg: dict, mix: dict) -> Tuple[int, int]:
    """The canvas the estimator serves the mix's frames on (bucketed)."""
    stride, step, scale = cfg["stride"], mix["bucket_step"], mix["scale"]
    return tuple(int(math.ceil(math.ceil(d * scale / stride) * stride / step) * step)
                 for d in mix["item_hw"])


def counts(cfg: dict, mix: dict) -> Dict[str, float]:
    """Per image of the mix: FLOPs, and the conv epilogue's bytes."""
    layers = convs(cfg, canvas_hw(cfg, mix))
    act = sum(4 * c["cout"] * c["out"][0] * c["out"][1] * (3 if c["residual"] else 2)
              for c in layers)
    bias = sum(4 * c["cout"] for c in layers)
    return {"flops_per_item": sum(2.0 * c["macs"] for c in layers),
            "epilogue_bytes_per_item": act + bias / mix["batch"]}
