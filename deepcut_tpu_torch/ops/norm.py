"""Inference BatchNorm (Caffe 3-blob flavour), BN+Scale as one affine, and
the graph engine's Scale, LRN and MVN.

Counterpart of `deepcut_tpu.ops.norm`. Caffe's BatchNorm stores unscaled
running sums and a moving-average scale factor (blobs[2]); the statistics
are divided by it at use time, with a factor of 0 giving 0. Tensors are
NCHW; per-channel vectors broadcast over dim 1.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deepcut_tpu_torch.ops.activations import per_channel


def scaled_stats(mean: torch.Tensor, var: torch.Tensor,
                 scale_factor: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stored statistics divided by Caffe's scale factor (0 -> 0)."""
    if scale_factor is None:
        return mean, var
    s = scale_factor.reshape(())
    inv = torch.where(s == 0, torch.zeros_like(s), 1.0 / torch.where(s == 0, torch.ones_like(s), s))
    return mean * inv, var * inv


def batch_norm_inference(
    x: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    scale_factor: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Caffe BatchNorm with use_global_stats over dim 1 of x (any rank >= 2;
    mean / var: (C,))."""
    mean, var = scaled_stats(mean, var, scale_factor)
    inv_std = torch.rsqrt(var.float() + eps)
    out = (x.float() - per_channel(mean.float(), x)) * per_channel(inv_std, x)
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
    return x * per_channel(g, x).to(x.dtype) + per_channel(b, x).to(x.dtype)


# -- the graph engine's layers (Caffe's channel axis 1, any rank >= 2) ----------
def scale(x: torch.Tensor, gamma: torch.Tensor, beta: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """Caffe Scale layer: per-channel y = x * gamma (+ beta), each op in x's dtype."""
    y = x * per_channel(gamma.to(x.dtype), x)
    if beta is not None:
        y = y + per_channel(beta.to(x.dtype), x)
    return y


def _window_sum(sq: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """Sums of `size` consecutive entries along `dim` of an already padded
    tensor (VALID), added in window order."""
    n = sq.shape[dim] - size + 1
    out = sq.narrow(dim, 0, n)
    for i in range(1, size):
        out = out + sq.narrow(dim, i, n)
    return out


def lrn(x: torch.Tensor, *, local_size: int = 5, alpha: float = 1.0, beta: float = 0.75,
        k: float = 1.0, across_channels: bool = True) -> torch.Tensor:
    """Local Response Normalisation (lrn_layer.cpp), in f32, NCHW.

    ACROSS_CHANNELS: x / (k + alpha/n * sum_{n channels} x^2)^beta;
    WITHIN_CHANNEL: the n x n spatial window, alpha/(n*n), zero padding."""
    xf = x.float()
    sq = xf * xf
    pad = local_size // 2
    if across_channels:
        windows = _window_sum(F.pad(sq, (0, 0, 0, 0, pad, pad)), 1, local_size)
        denom = torch.pow(k + (alpha / local_size) * windows, beta)
    else:
        sq = F.pad(sq, (pad, pad, pad, pad))
        windows = _window_sum(_window_sum(sq, 2, local_size), 3, local_size)
        denom = torch.pow(k + (alpha / (local_size * local_size)) * windows, beta)
    return (xf / denom).to(x.dtype)


def mvn(x: torch.Tensor, *, normalize_variance: bool = True, across_channels: bool = False,
        eps: float = 1e-9) -> torch.Tensor:
    """Mean-Variance Normalisation (mvn_layer.cpp), per image (and channel)."""
    dims = (1, 2, 3) if across_channels else (2, 3)
    xf = x.float()
    centered = xf - xf.mean(dim=dims, keepdim=True)
    if normalize_variance:
        std = torch.sqrt((centered * centered).mean(dim=dims, keepdim=True))
        centered = centered / (std + eps)
    return centered.to(x.dtype)
