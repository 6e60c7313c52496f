"""Pooling with Caffe-exact (ceil-mode) geometry, NCHW.

Counterpart of `deepcut_tpu.ops.pool.max_pool2d`. Caffe's output size is
``ceil((H + 2*pad - k) / stride) + 1``, shrunk by one when ``pad > 0`` and
the last window would start beyond ``H + pad`` (the DeeperCut stem pool
maps 344 -> 172, not 171). `F.max_pool2d(ceil_mode=True)` applies the same
rule except that it also shrinks when ``pad == 0``, which can only matter
for stride > kernel, and it takes no pad above half the kernel. Where it
gives Caffe's windows (the DeeperCut stem, every CaffeNet pool) it runs on
the input as it is; at any other geometry the input is padded with -inf to
the extent the windows read and pooled in floor mode.

The backward is Caffe's (pooling_layer.cpp): each output's whole gradient
goes to the FIRST maximum of its window in row-major scan order, and
overlapping windows add. `F.max_pool2d` keeps that argmax (its forward
replaces the running max only on a strictly greater value, on the CPU and
on CUDA, NCHW and channels_last alike), so its autograd backward is the
reference's. Post-ReLU zeros tie often in the stem pool, so the rule shows
in the trajectory; tests/test_torch_training.py holds it against the JAX
package with planted ties, and chip_smoke.py against a plain first-max
scatter on the card.

The graph engine's pooling (`max_pool2d`, `avg_pool2d`, `stochastic_pool2d`
with its two forms) takes any Caffe geometry, square or (h, w); global
pooling reduces H and W.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from deepcut_tpu_torch.ops.shard_rng import draw_batched


def pool_output_size(size: int, kernel: int, stride: int, pad: int) -> int:
    out = -(-(size + 2 * pad - kernel) // stride) + 1  # ceil division
    if pad > 0 and (out - 1) * stride >= size + pad:
        out -= 1
    return out


def _pair(v):
    return (int(v[0]), int(v[-1])) if isinstance(v, (tuple, list)) else (int(v), int(v))


def _caffe_padded(x: torch.Tensor, kernel, stride, pad, value: float):
    """x padded to the Caffe ceil-mode extent every window reads (``pad``
    before, up to one stride past it after), and the output size."""
    (kh, kw), (sh, sw), (ph, pw) = _pair(kernel), _pair(stride), _pair(pad)
    h, w = x.shape[2], x.shape[3]
    oh, ow = pool_output_size(h, kh, sh, ph), pool_output_size(w, kw, sw, pw)
    after_h = max((oh - 1) * sh + kh - h - ph, 0)
    after_w = max((ow - 1) * sw + kw - w - pw, 0)
    if ph or pw or after_h or after_w:
        x = F.pad(x, (pw, after_w, ph, after_h), value=value)
    return x, (kh, kw), (sh, sw), (ph, pw), (oh, ow)


def _torch_ceil_agrees(size: int, kernel: int, stride: int, pad: int) -> bool:
    """F.max_pool2d's ceil mode takes this pad and gives Caffe's size."""
    last = -(-(size + 2 * pad - kernel) // stride) * stride  # the last window's start + pad
    return 2 * pad <= kernel and (pad > 0 or last < size)


def max_pool2d(x: torch.Tensor, *, kernel, stride=1, pad=0) -> torch.Tensor:
    """MAX pooling at Caffe's ceil-mode geometry, any kernel / stride / pad
    (an int or an (h, w) pair). x: (N, C, H, W). Padding never wins."""
    (kh, kw), (sh, sw), (ph, pw) = _pair(kernel), _pair(stride), _pair(pad)
    if (_torch_ceil_agrees(x.shape[2], kh, sh, ph)
            and _torch_ceil_agrees(x.shape[3], kw, sw, pw)):
        return F.max_pool2d(x, (kh, kw), (sh, sw), (ph, pw), ceil_mode=True)
    xp, k, s, _, (oh, ow) = _caffe_padded(x, kernel, stride, pad, float("-inf"))
    return F.max_pool2d(xp, k, s)[:, :, :oh, :ow]


def _window_sums(xf: torch.Tensor, k, s) -> torch.Tensor:
    return F.avg_pool2d(xf, k, s, divisor_override=1)


def avg_pool2d(x: torch.Tensor, *, kernel, stride=1, pad=0) -> torch.Tensor:
    """AVE pooling, Caffe semantics (pooling_layer.cpp): the sum of the real
    pixels over the window clipped to the padded extent [-pad, H + pad),
    so padded zeros inside that extent count in the divisor and a ceil-mode
    overhang past it does not (neither of `F.avg_pool2d`'s
    ``count_include_pad`` modes). Summed in f32."""
    h, w = x.shape[2], x.shape[3]
    xp, k, s, (ph, pw), (oh, ow) = _caffe_padded(x.float(), kernel, stride, pad, 0.0)
    sums = _window_sums(xp, k, s)[:, :, :oh, :ow]
    hstart = torch.arange(oh, device=x.device) * s[0] - ph
    wstart = torch.arange(ow, device=x.device) * s[1] - pw
    hlen = torch.clamp(hstart + k[0], max=h + ph) - hstart
    wlen = torch.clamp(wstart + k[1], max=w + pw) - wstart
    divisor = (hlen[:, None] * wlen[None, :]).float()
    return (sums / divisor).to(x.dtype)


def stochastic_pool2d_test(x: torch.Tensor, *, kernel, stride=1) -> torch.Tensor:
    """STOCHASTIC pooling at TEST (pooling_layer.cu): the activation-weighted
    average sum(a^2) / sum(a) of each window, 0 where the sum is not
    positive; no padding, ceil-mode windows (zeros past the edge)."""
    xp, k, s, _, (oh, ow) = _caffe_padded(x.float(), kernel, stride, 0, 0.0)
    sums = _window_sums(xp, k, s)[:, :, :oh, :ow]
    sq = _window_sums(xp * xp, k, s)[:, :, :oh, :ow]
    out = torch.where(sums > 0, sq / torch.where(sums == 0, torch.ones_like(sums), sums),
                      torch.zeros_like(sums))
    return out.to(x.dtype)


def stochastic_pool2d_train(x: torch.Tensor, gen: torch.Generator, *, kernel,
                            stride=1) -> torch.Tensor:
    """STOCHASTIC pooling at TRAIN (pooling_layer.cu): each window picks one
    of its elements with probability proportional to its (non-negative)
    value, by inverse-CDF sampling: u ~ U[0, 1) from `gen` (on x's device)
    per output, and the first element in row-major window order whose
    running sum reaches u * the window's sum. The output is that element,
    so the gradient goes to it alone. Ceil-mode windows over zeros past the
    edge, as the TEST form; a window summing to 0 picks its first element."""
    xp, (kh, kw), (sh, sw), _, (oh, ow) = _caffe_padded(x.float(), kernel, stride, 0, 0.0)
    views = [xp[:, :, dy:dy + (oh - 1) * sh + 1:sh, dx:dx + (ow - 1) * sw + 1:sw]
             for dy in range(kh) for dx in range(kw)]
    sums = torch.zeros_like(views[0])
    for v in views:            # the running sums' own order: the last one reaches u * sums
        sums = sums + v
    thresh = draw_batched(lambda shape: torch.rand(shape, generator=gen, device=x.device),
                          sums.shape) * sums
    out = torch.zeros_like(sums)
    cum = torch.zeros_like(sums)
    picked = torch.zeros(sums.shape, dtype=torch.bool, device=x.device)
    for v in views:
        cum = cum + v
        take = ~picked & (cum >= thresh)
        out = torch.where(take, v, out)
        picked = picked | take
    return out.to(x.dtype)


def stochastic_pool2d(x: torch.Tensor, gen: Optional[torch.Generator] = None, *, kernel,
                      stride=1, train: bool = False) -> torch.Tensor:
    """STOCHASTIC pooling in one entry, the JAX package's signature with a
    generator (on x's device) for its key: `stochastic_pool2d_train` when
    `train` and a generator are given, else `stochastic_pool2d_test`."""
    if train and gen is not None:
        return stochastic_pool2d_train(x, gen, kernel=kernel, stride=stride)
    return stochastic_pool2d_test(x, kernel=kernel, stride=stride)


def global_avg_pool2d(x: torch.Tensor) -> torch.Tensor:
    """Global average pooling (Caffe global_pooling: true): (N, C, 1, 1)."""
    return x.mean(dim=(2, 3), keepdim=True)


def global_max_pool2d(x: torch.Tensor) -> torch.Tensor:
    return x.amax(dim=(2, 3), keepdim=True)
