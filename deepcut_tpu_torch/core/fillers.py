"""Weight fillers (counterpart of `deepcut_tpu.core.fillers`; reference:
include/caffe/filler.hpp:19-290).

Each filler maps (FillerParameter node, torch.Generator, shape) -> an f32
tensor on the CPU, drawn from the explicit generator. Shapes are the port's
layouts: conv OIHW ``(Cout, Cin/g, kh, kw)``, deconv ``(Cin, Cout/g, kh,
kw)`` (``deconv=True``), InnerProduct ``(N_out, K)``. The fans and the
per-output normalisations are the JAX package's, which reads them off its
HWIO ``(kh, kw, I, O)`` layouts: fan_in = kh*kw*I, fan_out = kh*kw*O, with
I = Cin/g, O = Cout for a conv and I = Cin, O = Cout/g for a deconv. The
random streams differ from the JAX package's, so the two are held equal by
their statistics (tests/test_torch_graph.py).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from deepcut_tpu_torch.proto.text_format import PbNode


def _io(shape: Tuple[int, ...], deconv: bool) -> Tuple[int, int]:
    """(I, O) of a 4-D weight in the JAX package's sense."""
    return (shape[0], shape[1]) if deconv else (shape[1], shape[0])


def _fans(shape: Tuple[int, ...], deconv: bool) -> Tuple[int, int]:
    if len(shape) == 4:
        rf = shape[2] * shape[3]
        i, o = _io(shape, deconv)
        return rf * i, rf * o
    if len(shape) == 2:  # (N_out, K) Caffe IP layout
        return shape[1], shape[0]
    n = 1
    for s in shape:
        n *= s
    return n, n


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float32)


def bilinear(shape: Tuple[int, ...]) -> torch.Tensor:
    """Bilinear upsampling kernel (filler.hpp:219-290): channel i -> i with
    the interpolation stencil, for i < min(dim 0, dim 1)."""
    n0, n1, kh, kw = shape
    fh, fw = (kh + 1) // 2, (kw + 1) // 2
    ch = (2 * fh - 1 - fh % 2) / (2.0 * fh)
    cw = (2 * fw - 1 - fw % 2) / (2.0 * fw)
    fy = 1 - torch.abs(torch.arange(kh, dtype=torch.float32) / fh - ch)
    fx = 1 - torch.abs(torch.arange(kw, dtype=torch.float32) / fw - cw)
    w = torch.zeros(shape, dtype=torch.float32)
    idx = torch.arange(min(n0, n1))
    w[idx, idx] = fy[:, None] * fx[None, :]
    return w


def fill(node: PbNode, gen: torch.Generator, shape: Tuple[int, ...], *,
         deconv: bool = False) -> torch.Tensor:
    shape = tuple(int(s) for s in shape)
    ftype = node.get_str("type", "constant")
    if ftype == "constant":
        return torch.full(shape, node.get_float("value", 0.0), dtype=torch.float32)
    if ftype == "uniform":
        return _uniform(gen, shape, node.get_float("min", 0.0), node.get_float("max", 1.0))
    if ftype == "gaussian":
        w = node.get_float("mean", 0.0) + node.get_float("std", 1.0) * _normal(gen, shape)
        sparse = node.get_int("sparse", -1)
        if sparse > 0 and len(shape) >= 1:
            # a bernoulli mask with probability sparse / num_outputs, the
            # number of outputs being Cout (filler.hpp:82-83)
            num_outputs = _io(shape, deconv)[1] if len(shape) == 4 else shape[0]
            prob = min(1.0, float(sparse) / max(num_outputs, 1))
            w = w * (torch.rand(shape, generator=gen) < prob)
        return w
    if ftype in ("xavier", "msra"):
        fan_in, fan_out = _fans(shape, deconv)
        n = {"FAN_IN": fan_in, "FAN_OUT": fan_out,
             "AVERAGE": (fan_in + fan_out) / 2.0}[node.get_str("variance_norm", "FAN_IN")]
        if ftype == "xavier":
            scale = math.sqrt(3.0 / n)
            return _uniform(gen, shape, -scale, scale)
        return math.sqrt(2.0 / n) * _normal(gen, shape)
    if ftype == "positive_unitball":
        # each output's weights sum to 1 (filler.hpp:111-121): per Cout for a
        # 4-D weight, per row of dim 0 otherwise
        w = torch.rand(shape, generator=gen, dtype=torch.float32)
        if len(shape) == 4:
            dims = (1, 2, 3) if not deconv else (0, 2, 3)
            return w / w.sum(dim=dims, keepdim=True)
        flat = w.reshape(shape[0] if len(shape) else 1, -1)
        return (flat / flat.sum(dim=1, keepdim=True)).reshape(shape)
    if ftype == "bilinear":
        assert len(shape) == 4, "bilinear filler needs a 4-D kernel"
        return bilinear(shape)
    raise ValueError(f"unknown filler type {ftype!r}")
