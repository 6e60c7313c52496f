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

The graph engine's pooling (`max_pool2d`, `avg_pool2d`,
`stochastic_pool2d_test`) takes any Caffe geometry, square or (h, w).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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

