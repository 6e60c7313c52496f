"""Convolution / transposed convolution with Caffe-exact geometry, NCHW.

Counterpart of `deepcut_tpu.ops.conv`. The geometry is Caffe's:
- conv output size ``(H + 2*pad - (dilation*(k-1)+1)) // stride + 1``;
- deconv output size ``stride*(H-1) + dilation*(k-1)+1 - 2*pad``,
which is exactly what `F.conv2d` / `F.conv_transpose2d` compute with
symmetric padding, so both are handed to cuDNN unchanged.

Weight layouts are PyTorch's: conv OIHW ``(Cout, Cin/g, kh, kw)``, deconv
``(Cin, Cout/g, kh, kw)`` (Caffe's own deconv blob order).
`deepcut_tpu_torch.models.convert` maps the JAX package's HWIO and
``(kh, kw, Cin, Cout)`` layouts onto these. `F.conv_transpose2d` is already
the transpose of a conv, so the deconv weight is NOT spatially flipped (the
JAX package flips because it lowers deconv as a conv with ``lhs_dilation``).

``compute_dtype`` casts input and weight (bf16 under mixed-precision
training; cuDNN accumulates in f32); the result is returned in the input's
dtype.

`conv2d_rounded` / `deconv2d_rounded` are the folded bf16 serving path.
They round as the JAX package's serving conv does, once: operands hold bf16
values in f32 tensors, the convolution runs in f32 with TF32 allowed for
that call alone (TF32 keeps 10 mantissa bits and bf16 7, so every product
is exact and the sum is f32, as XLA's bf16 conv with
``preferred_element_type=f32``), and `ops.conv_epilogue` adds the f32 bias,
rounds to bf16 once and applies the optional residual and ReLU. On the CPU
the convolution is a plain f32 `F.conv2d`. On the card the trunk's 3x3
convs (stride 1, padding = dilation, widths multiples of 64) take the
hand-written `ops.conv3x3` kernel in place of cuDNN; the graph engine,
which calls `exact_conv` itself, keeps cuDNN.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deepcut_tpu_torch.core.fillers import bilinear
from deepcut_tpu_torch.ops import conv3x3
from deepcut_tpu_torch.ops.conv_epilogue import conv_epilogue


def conv_output_size(size: int, kernel: int, stride: int, pad: int, dilation: int = 1) -> int:
    """Caffe conv spatial output size (floor semantics)."""
    k_eff = dilation * (kernel - 1) + 1
    return (size + 2 * pad - k_eff) // stride + 1


def deconv_output_size(size: int, kernel: int, stride: int, pad: int, dilation: int = 1) -> int:
    """Caffe deconv spatial output size."""
    k_eff = dilation * (kernel - 1) + 1
    return stride * (size - 1) + k_eff - 2 * pad


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        if len(v) == 1:
            return (int(v[0]), int(v[0]))
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _cast(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], compute_dtype):
    dt = x.dtype if compute_dtype is None else compute_dtype
    # F.conv2d takes the bias in the input's dtype; the stored bias stays f32
    # (cast_params) and is cast per call.
    return x.to(dt), w.to(dt), None if b is None else b.to(dt)


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    stride=1,
    pad=0,
    dilation=1,
    groups: int = 1,
    compute_dtype: Optional[torch.dtype] = torch.bfloat16,
) -> torch.Tensor:
    """2-D convolution, Caffe geometry.

    Args:
      x: (N, Cin, H, W)
      w: (Cout, Cin // groups, kh, kw)
      b: (Cout,) or None
    """
    xc, wc, bc = _cast(x, w, b, compute_dtype)
    y = F.conv2d(xc, wc, bc, stride=_pair(stride), padding=_pair(pad),
                 dilation=_pair(dilation), groups=groups)
    return y.to(x.dtype)


def deconv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    stride=1,
    pad=0,
    dilation=1,
    groups: int = 1,
    compute_dtype: Optional[torch.dtype] = torch.bfloat16,
) -> torch.Tensor:
    """Transposed 2-D convolution (Caffe "Deconvolution" forward).

    Args:
      x: (N, Cin, H, W)
      w: (Cin, Cout // groups, kh, kw) — no spatial flip (module docstring)
      b: (Cout,) or None
    """
    xc, wc, bc = _cast(x, w, b, compute_dtype)
    y = F.conv_transpose2d(xc, wc, bc, stride=_pair(stride), padding=_pair(pad),
                           dilation=_pair(dilation), groups=groups)
    return y.to(x.dtype)


def exact_conv(x: torch.Tensor, w: torch.Tensor, *, stride=1, pad=0, dilation=1,
               groups: int = 1, transposed: bool = False) -> torch.Tensor:
    """Bias-free f32 convolution (or transposed convolution) of operands
    that hold bf16 values: exact products, f32 sums. On the card cuDNN with
    TF32 allowed for this call alone, through the aten ops that take the
    flag per call (the global flag belongs to the caller, and
    `torch.backends.cudnn.flags()` would reset `benchmark` and
    `deterministic`); on the CPU `F.conv2d` in f32. A bf16 weight is
    widened here; the serving module stores its weights widened once."""
    if x.dtype != torch.float32:
        raise TypeError(f"exact_conv: x must be f32 holding bf16 values, got {x.dtype}")
    return _f32_conv(x, w.float(), stride, pad, dilation, groups, transposed, allow_tf32=True)


def _f32_conv(x, w, stride, pad, dilation, groups, transposed, *, allow_tf32: bool):
    """f32 convolution with TF32 allowed or not for this call alone (cuDNN's
    aten ops take the flag per call); on the CPU `F.conv2d`."""
    stride, pad, dilation = _pair(stride), _pair(pad), _pair(dilation)
    if x.device.type == "cuda":
        cudnn = torch.backends.cudnn
        if transposed:
            return torch.ops.aten.cudnn_convolution_transpose(
                x, w, pad, (0, 0), stride, dilation, groups, cudnn.benchmark,
                cudnn.deterministic, allow_tf32)
        return torch.ops.aten.cudnn_convolution(
            x, w, pad, stride, dilation, groups, cudnn.benchmark, cudnn.deterministic,
            allow_tf32)
    fn = F.conv_transpose2d if transposed else F.conv2d
    return fn(x, w, None, stride=stride, padding=pad, dilation=dilation, groups=groups)


def full_f32_conv(x: torch.Tensor, w: torch.Tensor, *, stride=1, pad=0, dilation=1,
                  groups: int = 1, transposed: bool = False) -> torch.Tensor:
    """Bias-free f32 convolution (or transposed convolution) with TF32 off
    for this call, whatever the caller's global flag."""
    return _f32_conv(x.float(), w.float(), stride, pad, dilation, groups, transposed,
                     allow_tf32=False)


def conv2d_f32(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
               stride=1, pad=0, dilation=1) -> torch.Tensor:
    """f32 convolution + f32 bias in full f32: TF32 is off for this call
    whatever the caller's global flag (int8 calibration, whose scales must
    not depend on it)."""
    y = _f32_conv(x.float(), w.float(), stride, pad, dilation, 1, False, allow_tf32=False)
    return y if b is None else y + b.reshape(1, -1, 1, 1)


def conv2d_rounded(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
                   stride=1, pad=0, dilation=1, groups: int = 1,
                   residual: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """The serving conv: `exact_conv` then `conv_epilogue` (bias, one bf16
    rounding, optional residual add rounded again, optional ReLU). x and
    residual hold bf16 values in f32; so does the result. On the card a
    convolution that `conv3x3.engages` takes (the trunk's 3x3 convs) runs
    on that kernel, over x in channels_last, in place of cuDNN."""
    if conv3x3.engages(x, w, stride, pad, dilation, groups):
        x = x.contiguous(memory_format=torch.channels_last)
        y = conv3x3.conv3x3(x, conv3x3.packed(w), _pair(dilation)[0])
    else:
        y = exact_conv(x, w, stride=stride, pad=pad, dilation=dilation, groups=groups)
    return conv_epilogue(y, b, residual, relu)


def deconv2d_rounded(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
                     stride=1, pad=0, dilation=1, groups: int = 1) -> torch.Tensor:
    """The serving deconv (weight layout as `deconv2d`), rounded as
    `conv2d_rounded`."""
    y = exact_conv(x, w, stride=stride, pad=pad, dilation=dilation, groups=groups,
                   transposed=True)
    return conv_epilogue(y, b)


def bilinear_filler(kh: int, kw: int, cin: int, cout: int,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Bilinear upsampling kernel (reference: include/caffe/filler.hpp:219-290)
    as a deconv weight in this module's layout, ``(cin, cout, kh, kw)``:
    channel i -> i with the interpolation stencil, for i < min(cin, cout)
    (`core.fillers.bilinear`). The JAX package's ``(kh, kw, cin, cout)``
    is its transpose."""
    return bilinear((cin, cout, kh, kw)).to(dtype)
