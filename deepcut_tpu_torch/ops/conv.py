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

``compute_dtype`` casts input and weight (bf16 on the serving path; cuDNN
accumulates in f32); the result is returned in the input's dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


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
