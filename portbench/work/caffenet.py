"""Work counts of CaffeNet's forward, from its shapes.

FLOPs count 2 per multiply-add of every convolution (grouped: each output
sees Cin / group inputs) and every InnerProduct; ReLU, pooling, LRN and the
softmax are left out.
"""

from __future__ import annotations

from typing import Dict


def layer_flops(cfg: dict) -> Dict[str, float]:
    """FLOPs of one image by layer."""
    c, h, w = cfg["input"]
    out: Dict[str, float] = {}
    for spec in cfg["conv"]:
        k, s, p, g = spec["kernel"], spec["stride"], spec["pad"], spec["group"]
        h, w = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        out[spec["name"]] = 2.0 * spec["num_output"] * (c // g) * k * k * h * w
        c = spec["num_output"]
        if spec["name"] in cfg["pool_after"]:
            pk, ps = cfg["pool"]["kernel"], cfg["pool"]["stride"]
            h, w = -(-(h - pk) // ps) + 1, -(-(w - pk) // ps) + 1
    k_in = c * h * w
    for spec in cfg["fc"]:
        out[spec["name"]] = 2.0 * k_in * spec["num_output"]
        k_in = spec["num_output"]
    return out


def counts(cfg: dict, mix: dict) -> Dict[str, float]:
    """Per image: FLOPs."""
    return {"flops_per_item": sum(layer_flops(cfg).values())}
