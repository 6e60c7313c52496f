"""Elementwise activation / math ops (counterparts of `deepcut_tpu.ops.activations`).

`relu` and `sigmoid` are the native model's. The rest are the graph
engine's layers, written op for op as the JAX package writes them, so that
a bf16 tensor rounds where a bf16 array rounds there: each arithmetic op
of PyTorch on bf16 operands computes in f32 and rounds its result once, as
XLA does, and a Python constant is first rounded to the tensor's dtype
(`const`), as JAX's weak types round it. Channel vectors broadcast over
dim 1 (Caffe's axis; the JAX package broadcasts over its last, NHWC axis).
"""

from __future__ import annotations

import torch


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def const(v: float, x: torch.Tensor) -> torch.Tensor:
    """A scalar in x's dtype and device (a 0-dim tensor, which keeps x's
    dtype), filled on the device: `torch.tensor` would copy it from the
    host, and that copy waits for every kernel queued before it."""
    return torch.full((), v, dtype=x.dtype, device=x.device)


def per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (C,) vector shaped to broadcast over dim 1 of x."""
    return v.reshape((1, -1) + (1,) * (x.dim() - 2)) if x.dim() >= 2 else v


def caffe_relu(x: torch.Tensor, *, negative_slope: float = 0.0) -> torch.Tensor:
    """ReLU with optional leak, as the JAX package's where-form (NaN -> 0)."""
    if negative_slope == 0.0:
        return torch.where(x > 0, x, 0.0)
    return torch.where(x > 0, x, x * const(negative_slope, x))


def elu(x: torch.Tensor, *, alpha: float = 1.0) -> torch.Tensor:
    return torch.where(x > 0, x, const(alpha, x) * (torch.exp(torch.minimum(x, const(0.0, x)))
                                                    - const(1.0, x)))


def prelu(x: torch.Tensor, slopes: torch.Tensor, *, channel_shared: bool = False) -> torch.Tensor:
    """PReLU (prelu_layer.cpp): learned per-channel (or shared) slope."""
    a = slopes.reshape(()) if channel_shared else per_channel(slopes, x)
    return torch.where(x > 0, x, x * a.to(x.dtype))


def bnll(x: torch.Tensor) -> torch.Tensor:
    """BNLL (bnll_layer.cpp): log(1 + exp(x)), overflow-safe."""
    return torch.where(x > 0, x + torch.log1p(torch.exp(-x)), torch.log1p(torch.exp(x)))


def exp_op(x: torch.Tensor, *, base: float = -1.0, scale: float = 1.0,
           shift: float = 0.0) -> torch.Tensor:
    """Exp layer: y = base^(shift + scale*x); base=-1 means e (exp_layer.cpp)."""
    z = shift + scale * x.float()
    y = torch.exp(z) if base == -1.0 else torch.pow(base, z)
    return y.to(x.dtype)


def log_op(x: torch.Tensor, *, base: float = -1.0, scale: float = 1.0,
           shift: float = 0.0) -> torch.Tensor:
    """Log layer: y = log_base(shift + scale*x) (log_layer.cpp)."""
    z = shift + scale * x.float()
    y = torch.log(z)
    if base != -1.0:
        y = y / torch.log(torch.tensor(base, dtype=torch.float32))
    return y.to(x.dtype)


def power_op(x: torch.Tensor, *, power: float = 1.0, scale: float = 1.0,
             shift: float = 0.0) -> torch.Tensor:
    """Power layer: y = (shift + scale*x)^power (power_layer.cpp)."""
    z = shift + scale * x.float()
    y = z if power == 1.0 else torch.pow(z, power)
    return y.to(x.dtype)


def threshold(x: torch.Tensor, *, t: float = 0.0) -> torch.Tensor:
    """Threshold layer: y = 1[x > t] (threshold_layer.cpp)."""
    return (x > t).to(x.dtype)
