"""BatchNorm (Caffe 3-blob flavour) at inference and in training, BN+Scale
as one affine, and the graph engine's Scale, LRN and MVN.

Counterpart of `deepcut_tpu.ops.norm`. Caffe's BatchNorm stores unscaled
running sums and a moving-average scale factor (blobs[2]); the statistics
are divided by it at use time, with a factor of 0 giving 0. Tensors are
NCHW; per-channel vectors broadcast over dim 1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from deepcut_tpu_torch.ops.activations import per_channel
from deepcut_tpu_torch.ops.shard_rng import as_axis


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


# the axis the batch is sharded over (`sharded_bn_stats`)
_AXIS = None


class sharded_bn_stats:
    """Context: ``with sharded_bn_stats(axis): ...`` makes `batch_norm_train`
    normalise with the GLOBAL batch's moments, all-reduced over the axis
    (`parallel.mesh.Axis`; a `parallel.mesh.Mesh` stands for its 'data'
    axis), and move the statistics by them (the counterpart of the JAX
    package's psum'ed moments). Row shards of the global batch take the
    mesh's `world_axis`: every rank holds a distinct part of each channel's
    elements. ``sharded_bn_stats(None)`` is a no-op."""

    def __init__(self, axis):
        self.axis = as_axis(axis)

    def __enter__(self):
        global _AXIS
        self._prev, _AXIS = _AXIS, self.axis
        return self

    def __exit__(self, *exc):
        global _AXIS
        _AXIS = self._prev
        return False


class _ShardedBatchNorm(torch.autograd.Function):
    """(x f32, axis, eps) -> (y, global mean, global biased variance).

    The forward all-reduces the per-channel sums for the mean, then the
    centred squares for the variance, over the global batch of ``count``
    elements per channel; the backward implements the distributed
    BatchNorm gradient directly,
        dx = inv * (g - mean(g) - c * inv^2 * mean(g * c)),
    with its two means all-reduced (`deepcut_tpu.ops.norm`'s
    _bn_normalise_sharded). The moments carry no gradient."""

    @staticmethod
    def forward(ctx, xf, mesh, eps):
        axes = [d for d in range(xf.dim()) if d != 1]
        cnt = float(xf.numel() // xf.shape[1] * mesh.size)
        mu = mesh.all_reduce_(xf.sum(dim=axes)) / cnt
        c = xf - per_channel(mu, xf)
        var = mesh.all_reduce_((c * c).sum(dim=axes)) / cnt
        inv = torch.rsqrt(var + eps)
        ctx.mesh, ctx.cnt, ctx.axes = mesh, cnt, axes
        ctx.save_for_backward(c, inv)
        ctx.mark_non_differentiable(mu, var)
        return c * per_channel(inv, xf), mu, var

    @staticmethod
    def backward(ctx, gy, _gmu, _gvar):
        c, inv = ctx.saved_tensors
        mesh, cnt, axes = ctx.mesh, ctx.cnt, ctx.axes
        sums = mesh.all_reduce_(torch.stack([gy.sum(dim=axes), (gy * c).sum(dim=axes)])) / cnt
        s1, s2 = per_channel(sums[0], gy), per_channel(sums[1], gy)
        inv = per_channel(inv, gy)
        return inv * (gy - s1 - c * (inv * inv) * s2), None, None


class BNStats(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    scale_factor: torch.Tensor


def batch_norm_train(x: torch.Tensor, stats: BNStats, *, eps: float = 1e-5,
                     momentum: float = 0.999) -> Tuple[torch.Tensor, BNStats]:
    """Training-mode BatchNorm with Caffe's moving-average bookkeeping
    (batch_norm_layer.cpp), over dim 1 of x (any rank >= 2).

    x is normalised with the batch's own moments (biased variance), and
    autograd differentiates through them. The new stored statistics are
    ``mean*momentum + batch_mean``, ``var*momentum + m/(m-1)*batch_var``
    (m = elements per channel) and ``scale_factor*momentum + 1``, computed
    without gradient: the statistics are not learned. Returns (y, stats)
    instead of mutating the blobs. Inside `sharded_bn_stats(axis)` the
    moments (and m) are the global batch's (`_ShardedBatchNorm`)."""
    xf = x.float()
    if _AXIS is not None:
        y, batch_mean, batch_var = _ShardedBatchNorm.apply(xf, _AXIS, eps)
        m = x.numel() // x.shape[1] * _AXIS.size
        with torch.no_grad():
            new = BNStats(mean=momentum * stats.mean + batch_mean,
                          var=momentum * stats.var + (m / max(m - 1, 1)) * batch_var,
                          scale_factor=momentum * stats.scale_factor + 1.0)
        return y.to(x.dtype), new
    axes = [d for d in range(x.dim()) if d != 1]
    batch_mean = xf.mean(dim=axes)
    centered = xf - per_channel(batch_mean, xf)
    batch_var = (centered * centered).mean(dim=axes)
    m = x.numel() // x.shape[1]
    with torch.no_grad():
        new = BNStats(mean=momentum * stats.mean + batch_mean,
                      var=momentum * stats.var + (m / max(m - 1, 1)) * batch_var,
                      scale_factor=momentum * stats.scale_factor + 1.0)
    y = centered * per_channel(torch.rsqrt(batch_var + eps), xf)
    return y.to(x.dtype), new


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
