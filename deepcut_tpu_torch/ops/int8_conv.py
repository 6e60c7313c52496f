"""int8 convolutions of the quantized serving forward: im2col, product, epilogue.

The JAX package computes each int8 conv with XLA's ``conv_general_dilated``
over int8 operands into an int32 accumulator, then dequantizes
(``acc * (s_x * w_scale) + b``), rounds to the compute dtype, adds the
residual, applies ReLU and requantizes for the next conv, all fused by XLA
(`deepcut_tpu.models.quantize`, ``_conv_i8`` / ``_deconv_i8`` / ``quant``).
PyTorch's CUDA build has no int8 convolution, so the port lowers each one
to a matrix product:

- operand A: `int8_im2col` gathers the (N*oh*ow, kh*kw*C) int8 patch matrix
  from an NHWC (channels_last) int8 tensor, zero outside the image, for a
  square or rectangular kernel with stride, padding, dilation and an input
  (lhs) dilation; the int8 deconv is
  a conv over the input dilated by 2 with the flipped kernel, exactly
  ``_deconv_i8``'s lowering. A 1x1 stride-1 conv takes the int8 tensor as
  it is (rows of C channels);
- the product: ``torch._int_mm(A, W)``, int8 x int8 -> int32, exact, with
  the weights packed once as (Cout, kh*kw*Cin), both rounded up to 8
  (`pack_conv_weight`, `pack_deconv_weight`);
- `int8_epilogue`: dequantize with ONE rounding (an FMA, as XLA:CPU
  contracts ``acc * scale + b``), round to bf16 where the JAX package casts
  to its compute dtype, add a residual (f32, or int8 times its scale as an
  FMA), ReLU as ``where(x > 0, x, 0)``, and write the f32 result and / or
  its int8 requantization for the next conv;
- `quantize_i8`: ``clamp(round(x * (1/s)), -127, 127)`` for a tensor that
  no epilogue produced (the stem's output, the heads' skip tap, res5c for
  the int8 deconv); the reciprocal is computed once in f32, as the JAX
  package does.

The three kernels are `csrc/int8_conv.cu` (design notes there), built with
nvcc for ``sm_90a`` at their first launch (`native.build`). They replace no
TPU kernel: XLA fuses this work on the TPU. A CPU tensor takes each
kernel's plain version; a CUDA tensor launches the kernel or raises.
`conv_i8_plain` / `deconv_i8_plain` are the exact references for the whole
route (an f64 convolution of the int8 values is exact: every sum is below
9 * 2048 * 127**2 < 2**53); nothing on the card's path calls them. They do
not use PyTorch's int8 ``F.conv2d``, which runs on the CPU but wraps around
in int8 instead of accumulating in int32.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from deepcut_tpu_torch.native import PKG, NativeLib, build
from deepcut_tpu_torch.ops.conv_epilogue import view_geometry

LIB = NativeLib(PKG / "csrc" / "int8_conv.cu")

# kernel launches since the last reset (CPU calls do not count)
im2col_launches = 0
epilogue_launches = 0
quantize_launches = 0
# while a dict (`record_geometries`): per kernel, each distinct launch
# geometry (shapes, strides, modes) -> the first call's scales, so that a
# caller can replay every geometry a path gave the kernels against their
# plain versions
geometries: Optional[Dict[str, Dict[tuple, tuple]]] = None
_lock = threading.Lock()
_lib = None

# torch._int_mm on the card takes more than 16 rows and multiples of 8 for
# the inner and output widths (read on the card); shorter A matrices get
# zero rows, and the widths zero columns
MIN_ROWS = 17


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(LIB)[0]))
            ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
            lib.int8_im2col_launch.argtypes = [ptr, ptr] + [i32] * 15 + [i32, ptr]
            lib.int8_epilogue_launch.argtypes = ([ptr, i32, ptr, ptr, ptr, i32, f32, i64, i64, i64,
                                                  ptr, ptr, f32] + [i32] * 7 + [i32, ptr])
            lib.quantize_i8_launch.argtypes = [ptr, ptr, i64, f32, i32, i32, ptr]
            for fn in (lib.int8_im2col_launch, lib.int8_epilogue_launch, lib.quantize_i8_launch):
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _count(name: str, geometry: tuple, values: tuple = ()) -> None:
    with _lock:
        globals()[name] += 1
        if geometries is not None:
            geometries.setdefault(name, {}).setdefault(geometry, values)


def record_geometries(on: bool = True) -> None:
    """Start (afresh) or stop recording each distinct launch geometry (see
    `geometries`)."""
    global geometries
    with _lock:
        geometries = {} if on else None


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _device_check(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises on any other."""
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"{what}: no kernel for device {t.device}")
    return False


# -- exact arithmetic helpers -------------------------------------------------
def recip_f32(s) -> float:
    """1/s computed once in f32 (``1.0 / s`` on an f32 scale in the JAX
    package), as a Python float holding that f32 value."""
    return float(np.float32(1.0) / np.float32(float(s)))


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` over f32 operands with ONE rounding to f32, as a fused
    multiply-add (XLA:CPU contracts the JAX package's dequantization into
    one; the kernel calls ``__fmaf_rn``). The f32 product is exact in f64;
    the f64 sum rounds once, and its exact error (Knuth's two-sum) settles
    the only case where rounding that sum again to f32 could differ from
    one rounding: an f64 sum that lies exactly halfway between two f32
    values."""
    a64 = a.double()
    b64 = b.double() if isinstance(b, torch.Tensor) else float(b)
    c64 = c.double()
    p = a64 * b64
    t = p + c64
    bb = t - p
    err = (p - (t - bb)) + (c64 - bb)
    r = t.float()
    r64 = r.double()
    hi = torch.nextafter(r, torch.full_like(r, float("inf")))
    lo = torch.nextafter(r, torch.full_like(r, float("-inf")))
    r = torch.where((t == (r64 + hi.double()) / 2) & (err > 0), hi, r)
    return torch.where((t == (r64 + lo.double()) / 2) & (err < 0), lo, r)


def _round_bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).float()


# -- plain versions -----------------------------------------------------------
def quantize_i8_plain(x: torch.Tensor, s) -> torch.Tensor:
    """``clamp(round(x * (1/s)), -127, 127)`` as int8, the reciprocal in
    f32; ``torch.round`` rounds half to even like ``jnp.round``."""
    return torch.clamp(torch.round(x.float() * recip_f32(s)), -127, 127).to(torch.int8)


def _dilate_pad(x: torch.Tensor, pad: int, lhs_dilation: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, H', W', C) with the input dilated by
    ``lhs_dilation`` (zeros between pixels) and zero-padded by ``pad``."""
    n, c, h, w = x.shape
    hd, wd = (h - 1) * lhs_dilation + 1, (w - 1) * lhs_dilation + 1
    out = torch.zeros((n, hd + 2 * pad, wd + 2 * pad, c), dtype=x.dtype, device=x.device)
    out[:, pad:pad + hd:lhs_dilation, pad:pad + wd:lhs_dilation] = x.permute(0, 2, 3, 1)
    return out


Kernel = Union[int, Tuple[int, int]]


def kernel_hw(k: Kernel) -> Tuple[int, int]:
    """A square kernel's size or a (kh, kw) pair -> (kh, kw)."""
    return (int(k), int(k)) if isinstance(k, int) else (int(k[0]), int(k[1]))


def conv_out_hw(h: int, w: int, k: Kernel, *, stride=1, pad=0, dilation=1, lhs_dilation=1):
    kh, kw = kernel_hw(k)
    return (((h - 1) * lhs_dilation + 1 + 2 * pad - dilation * (kh - 1) - 1) // stride + 1,
            ((w - 1) * lhs_dilation + 1 + 2 * pad - dilation * (kw - 1) - 1) // stride + 1)


def int8_im2col_plain(x: torch.Tensor, k: Kernel, *, stride=1, pad=0, dilation=1,
                      lhs_dilation=1, min_rows: int = 0, width: int = 0) -> torch.Tensor:
    """(N, C, H, W) int8 -> (max(N*oh*ow, min_rows), max(kh*kw*C, width))
    int8 patch rows, K ordered (kh, kw, C) like the packed weights, zero
    outside the image and in the padding rows and columns."""
    n, c, h, w = x.shape
    kh, kw = kernel_hw(k)
    oh, ow = conv_out_hw(h, w, k, stride=stride, pad=pad, dilation=dilation,
                         lhs_dilation=lhs_dilation)
    xp = _dilate_pad(x, pad, lhs_dilation)
    taps = [xp[:, i * dilation:i * dilation + (oh - 1) * stride + 1:stride,
               j * dilation:j * dilation + (ow - 1) * stride + 1:stride]
            for i in range(kh) for j in range(kw)]
    a = torch.stack(taps, dim=3).reshape(n * oh * ow, kh * kw * c)
    return F.pad(a, (0, max(width - a.shape[1], 0), 0, max(min_rows - a.shape[0], 0)))


def conv_i8_plain(x_q: torch.Tensor, w_q: torch.Tensor, *, stride=1, pad=0, dilation=1,
                  lhs_dilation=1) -> torch.Tensor:
    """Exact int32 accumulator of an int8 conv (OIHW int8 weights), NCHW:
    an f64 convolution of the int8 values (exact, see the module
    docstring), with the input dilated by ``lhs_dilation`` first."""
    x = x_q.double()
    if lhs_dilation > 1:
        x = _dilate_pad(x, pad, lhs_dilation).permute(0, 3, 1, 2)
        pad = 0
    y = F.conv2d(x, w_q.double(), stride=stride, padding=pad, dilation=dilation)
    return y.to(torch.int32)


def deconv_i8_plain(x_q: torch.Tensor, w_q: torch.Tensor, *, stride=2) -> torch.Tensor:
    """Exact int32 accumulator of the int8 transposed conv with a
    ``(Cin, Cout, kh, kw)`` int8 weight (no flip, as `ops.conv.deconv2d`),
    NCHW; equals ``_deconv_i8`` of the JAX package."""
    y = F.conv_transpose2d(x_q.double(), w_q.double(), stride=stride)
    return y.to(torch.int32)


def int8_epilogue_plain(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        residual: Optional[torch.Tensor] = None, *,
                        residual_scale: Optional[float] = None, relu: bool = False,
                        bf16: bool = True, f32_out: bool = True,
                        requant_s: Optional[float] = None
                        ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The epilogue over an (N, C, H, W) int32 accumulator, in the JAX
    package's order (quantize.py:127-128, :157, :175-181, :214, :229-230):

    - ``v = fma(f32(acc), scale[c], bias[c])``, one rounding;
    - ``bf16``: round v to bf16 (the conv's ``astype(cdt)``);
    - an f32 residual: ``v + r`` (rounded to bf16 again with ``bf16``: the
      bf16 + bf16 add); an int8 residual: ``fma(f32(r), residual_scale, v)``
      (the f32 ``y_q * s_y + z`` of the int8-resident stream);
    - ``relu``: ``where(v > 0, v, 0)``;
    - returns (v if ``f32_out``, its `quantize_i8_plain` at ``requant_s``)."""
    v = fma_f32(acc.float(), scale.reshape(1, -1, 1, 1), bias.reshape(1, -1, 1, 1))
    if bf16:
        v = _round_bf16(v)
    if residual is not None:
        if residual.dtype == torch.int8:
            v = fma_f32(residual.float(), float(np.float32(residual_scale)), v)
        else:
            v = v + residual
            if bf16:
                v = _round_bf16(v)
    if relu:
        v = torch.where(v > 0, v, torch.zeros((), dtype=v.dtype, device=v.device))
    return (v if f32_out else None,
            quantize_i8_plain(v, requant_s) if requant_s is not None else None)


# -- weight packing -----------------------------------------------------------
def pack_conv_weight(w_q: torch.Tensor) -> torch.Tensor:
    """OIHW int8 -> (Cout, K) int8, both rounded up to multiples of 8 with
    zeros (the card's int8 GEMM takes no other widths), K ordered
    (kh, kw, Cin) like `int8_im2col`'s rows."""
    cout = w_q.shape[0]
    rows = w_q.permute(0, 2, 3, 1).reshape(cout, -1)
    return F.pad(rows, (0, -rows.shape[1] % 8, 0, -cout % 8)).contiguous()


def pack_deconv_weight(w_q: torch.Tensor) -> torch.Tensor:
    """``(Cin, Cout, kh, kw)`` transposed-conv weight -> the packed weight
    of the equivalent conv over the zero-dilated input: transposed and
    spatially flipped (``_deconv_i8``'s ``jnp.flip``)."""
    return pack_conv_weight(w_q.permute(1, 0, 2, 3).flip(2, 3))


# -- the kernels' wrappers ------------------------------------------------------
def quantize_i8(x: torch.Tensor, s) -> torch.Tensor:
    """f32 tensor -> int8 of the same shape and memory layout at scale s."""
    if not _device_check(x, "quantize_i8"):
        return quantize_i8_plain(x, s)
    if x.dtype != torch.float32 or not (
            x.is_contiguous() or x.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"quantize_i8: x must be dense f32, got {x.dtype} strides {x.stride()}")
    y = torch.empty_like(x, dtype=torch.int8)
    n = x.numel()
    vec4 = n % 4 == 0 and x.data_ptr() % 16 == 0 and y.data_ptr() % 4 == 0
    _raise_on(_library().quantize_i8_launch(x.data_ptr(), y.data_ptr(), n, recip_f32(s),
                                            int(vec4), x.device.index, _stream(x)), "quantize_i8")
    _count("quantize_launches", view_geometry(x), (float(s),))
    return y


def int8_im2col(x: torch.Tensor, k: Kernel, *, stride=1, pad=0, dilation=1, lhs_dilation=1,
                min_rows: int = 0, width: int = 0) -> torch.Tensor:
    """(N, C, H, W) int8, channels_last on the card, and a kernel of k x k
    or (kh, kw) -> (max(N*oh*ow, min_rows), max(kh*kw*C, width)) int8 patch
    rows; the rows past N*oh*ow and the columns past kh*kw*C are zero (the
    GEMM's padding)."""
    if not _device_check(x, "int8_im2col"):
        return int8_im2col_plain(x, k, stride=stride, pad=pad, dilation=dilation,
                                 lhs_dilation=lhs_dilation, min_rows=min_rows, width=width)
    if x.dtype != torch.int8 or x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"int8_im2col: x must be 4-D int8 channels_last, got {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}")
    n, c, h, w = x.shape
    kh, kw = kernel_hw(k)
    oh, ow = conv_out_hw(h, w, k, stride=stride, pad=pad, dilation=dilation,
                         lhs_dilation=lhs_dilation)
    rows = n * oh * ow
    kk = kh * kw * c
    if oh < 1 or ow < 1 or rows >= 2**31 or rows * kk >= 2**40:
        raise ValueError(f"int8_im2col: unsupported output {n}x{oh}x{ow}x{kk}")
    shape = (max(rows, min_rows), max(kk, width))
    if shape[1] > kk:  # zero columns: only for channel counts no trunk conv has
        out = torch.zeros(shape, dtype=torch.int8, device=x.device)
    else:
        out = torch.empty(shape, dtype=torch.int8, device=x.device)
        if shape[0] > rows:
            out[rows:].zero_()
    vec = next(v for v in (16, 4, 1) if c % v == 0 and shape[1] % v == 0
               and x.data_ptr() % v == 0 and out.data_ptr() % v == 0)
    _raise_on(_library().int8_im2col_launch(
        x.data_ptr(), out.data_ptr(), n, h, w, c, kh, kw, stride, pad, dilation, lhs_dilation,
        oh, ow, rows, shape[1], vec, x.device.index, _stream(x)), "int8_im2col")
    _count("im2col_launches", (view_geometry(x), (kh, kw), stride, pad, dilation, lhs_dilation,
                               min_rows, width))
    return out


def conv_i8(x_q: torch.Tensor, packed: torch.Tensor, cout: int, k: Kernel, *, stride=1, pad=0,
            dilation=1, lhs_dilation=1) -> torch.Tensor:
    """int8 (N, Cin, H, W) * packed int8 weight -> the int32 accumulator
    (N, cout, oh, ow), channels_last (a view of the product's padded
    (N*oh*ow, Cpad) rows). A (`int8_im2col`, or the input itself for a 1x1
    stride-1 conv), then ``torch._int_mm(A, packed.t())``: on the card
    cuBLASLt's int8 GEMM, on the CPU an exact int32 product."""
    n, _, h, w = x_q.shape
    oh, ow = conv_out_hw(h, w, k, stride=stride, pad=pad, dilation=dilation,
                         lhs_dilation=lhs_dilation)
    rows = n * oh * ow
    if (kernel_hw(k) == (1, 1) and stride == 1 and pad == 0 and lhs_dilation == 1
            and rows >= MIN_ROWS
            and packed.shape[1] == x_q.shape[1]):
        a = x_q.permute(0, 2, 3, 1).reshape(rows, -1)
    else:
        a = int8_im2col(x_q, k, stride=stride, pad=pad, dilation=dilation,
                        lhs_dilation=lhs_dilation, min_rows=MIN_ROWS, width=packed.shape[1])
    acc = torch._int_mm(a, packed.t())
    return acc[:rows].view(n, oh, ow, -1).permute(0, 3, 1, 2)[:, :cout]


def _epilogue_check(acc, scale, bias, residual, residual_scale, requant_s, f32_out):
    if acc.dim() != 4 or acc.dtype != torch.int32 or acc.stride(1) != 1:
        raise ValueError(f"int8_epilogue: acc must be 4-D int32 with channel stride 1, got "
                         f"{acc.dtype} {tuple(acc.shape)} strides {acc.stride()}")
    n, c, h, w = acc.shape
    ldc = acc.stride(3)
    if acc.stride(2) != w * ldc or acc.stride(0) != h * w * ldc or ldc < c:
        raise ValueError(f"int8_epilogue: acc pixels must be rows of one stride, got {acc.stride()}")
    if n * h * w < 1 or n * h * w >= 2**31 or n * h * w * ldc >= 2**40:
        raise ValueError(f"int8_epilogue: unsupported shape {tuple(acc.shape)}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,) or not t.is_contiguous() \
                or t.device != acc.device:
            raise ValueError(f"int8_epilogue: {name} must be a contiguous f32 ({c},) on {acc.device}")
    if residual is not None:
        if residual.dtype not in (torch.float32, torch.int8) or residual.shape != acc.shape \
                or residual.stride(1) != 1 or residual.device != acc.device:
            raise ValueError(f"int8_epilogue: residual must be f32 or int8 {tuple(acc.shape)} on "
                             f"{acc.device} with channel stride 1, got {residual.dtype} "
                             f"{tuple(residual.shape)} strides {residual.stride()}")
        if (residual.dtype == torch.int8) != (residual_scale is not None):
            raise ValueError("int8_epilogue: an int8 residual takes a residual_scale, "
                             "an f32 one none")
    if not f32_out and requant_s is None:
        raise ValueError("int8_epilogue: no output asked for")


def int8_epilogue(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  residual: Optional[torch.Tensor] = None, *,
                  residual_scale: Optional[float] = None, relu: bool = False,
                  bf16: bool = True, f32_out: bool = True, requant_s: Optional[float] = None
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """`int8_epilogue_plain`'s function. On the card the outputs are new
    channels_last tensors: (N, C, H, W) f32 if ``f32_out`` and int8 if
    ``requant_s`` is given; the residual may be a strided view (a crop)
    with channel stride 1."""
    if not _device_check(acc, "int8_epilogue"):
        return int8_epilogue_plain(acc, scale, bias, residual, residual_scale=residual_scale,
                                   relu=relu, bf16=bf16, f32_out=f32_out, requant_s=requant_s)
    _epilogue_check(acc, scale, bias, residual, residual_scale, requant_s, f32_out)
    n, c, h, w = acc.shape
    ldc = acc.stride(3)
    cl = torch.channels_last
    out = torch.empty((n, c, h, w), dtype=torch.float32, device=acc.device,
                      memory_format=cl) if f32_out else None
    out_q = torch.empty((n, c, h, w), dtype=torch.int8, device=acc.device,
                        memory_format=cl) if requant_s is not None else None
    kind = 0 if residual is None else (2 if residual.dtype == torch.int8 else 1)
    rn, _, rh, rw = residual.stride() if residual is not None else (0, 0, 0, 0)
    res_align = 4 if kind == 2 else 16
    vec4 = (c % 4 == 0 and ldc % 4 == 0 and acc.data_ptr() % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in (scale, bias, out) if t is not None)
            and (out_q is None or out_q.data_ptr() % 4 == 0)
            and (residual is None or (residual.data_ptr() % res_align == 0
                                      and rn % 4 == 0 and rh % 4 == 0 and rw % 4 == 0)))
    _raise_on(_library().int8_epilogue_launch(
        acc.data_ptr(), ldc, scale.data_ptr(), bias.data_ptr(),
        residual.data_ptr() if residual is not None else None, kind,
        float(residual_scale) if kind == 2 else 0.0, rn, rh, rw,
        out.data_ptr() if out is not None else None,
        out_q.data_ptr() if out_q is not None else None,
        recip_f32(requant_s) if requant_s is not None else 0.0,
        n * h * w, c, h, w, int(bf16), int(relu), int(vec4), acc.device.index, _stream(acc)),
        "int8_epilogue")
    _count("epilogue_launches",
           (view_geometry(acc), view_geometry(residual), relu, bf16, f32_out, requant_s is not None),
           (residual_scale, requant_s))
    return out, out_q


def reset_counts() -> None:
    global im2col_launches, epilogue_launches, quantize_launches
    with _lock:
        im2col_launches = epilogue_launches = quantize_launches = 0
