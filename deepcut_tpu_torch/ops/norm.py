"""Inference BatchNorm (Caffe 3-blob flavour) and BN+Scale as one affine.

Counterpart of `deepcut_tpu.ops.norm`. Caffe's BatchNorm stores unscaled
running sums and a moving-average scale factor (blobs[2]); the statistics
are divided by it at use time, with a factor of 0 giving 0. Tensors are
NCHW; per-channel vectors broadcast over dim 1.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def scaled_stats(mean: torch.Tensor, var: torch.Tensor,
                 scale_factor: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stored statistics divided by Caffe's scale factor (0 -> 0)."""
    if scale_factor is None:
        return mean, var
    s = scale_factor.reshape(())
    inv = torch.where(s == 0, torch.zeros_like(s), 1.0 / torch.where(s == 0, torch.ones_like(s), s))
    return mean * inv, var * inv


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(1, -1, 1, 1)


def batch_norm_inference(
    x: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    scale_factor: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Caffe BatchNorm with use_global_stats. x: (N, C, H, W); mean/var: (C,)."""
    mean, var = scaled_stats(mean, var, scale_factor)
    inv_std = torch.rsqrt(var.float() + eps)
    out = (x.float() - _per_channel(mean.float())) * _per_channel(inv_std)
    return out.to(x.dtype)


def bn_scale_affine(
    x: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    scale_factor: Optional[torch.Tensor],
    gamma: torch.Tensor,
    beta: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-5,
) -> torch.Tensor:
    """BatchNorm + Scale collapsed into one per-channel affine (the unfolded
    forward's BN):

        y = x * g + b,   g = gamma * rsqrt(var/s + eps),  b = beta - mean/s * g
    """
    mean, var = scaled_stats(mean, var, scale_factor)
    g = gamma.float() * torch.rsqrt(var.float() + eps)
    b = -mean.float() * g
    if beta is not None:
        b = b + beta.float()
    return x * _per_channel(g).to(x.dtype) + _per_channel(b).to(x.dtype)
