"""Bias, one bf16 rounding, residual and ReLU after a serving convolution.

`conv_epilogue` finishes each convolution of the folded bf16 forward the
way the JAX package does (`deepcut_tpu.ops.conv.conv2d`: f32 accumulate,
+ f32 bias, one rounding to bf16; then `relu`, or `relu(shortcut + z)` as a
bf16 add): the convolution hands it an f32 sum of products of bf16 values,
and it returns bf16 values held in f32, which the next convolution takes
as they are. The kernel is `csrc/conv_epilogue.cu` (design notes there),
built with nvcc for ``sm_90a`` at its first launch (`native.build`); it
replaces no TPU kernel, since XLA fuses this epilogue on the TPU.

A CPU tensor takes the plain version, `conv_epilogue_plain`; a CUDA tensor
launches the kernel, which writes the result over ``y``, or raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from deepcut_tpu_torch.native import PKG, NativeLib, build

LIB = NativeLib(PKG / "csrc" / "conv_epilogue.cu")

launches = 0  # kernel launches since the last reset (CPU calls do not count)
# while a dict (`record_geometries`): each distinct launch geometry (shapes,
# strides, modes), so that a caller can replay every geometry a path gave
# the kernel against its plain version
geometries: Optional[Dict[tuple, tuple]] = None
_lock = threading.Lock()
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(LIB)[0]))
            fn = lib.conv_epilogue_launch
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def view_geometry(t: Optional[torch.Tensor]):
    """A tensor view's (dtype, shape, strides, storage offset) or None."""
    if t is None:
        return None
    return (str(t.dtype), tuple(t.shape), tuple(t.stride()), t.storage_offset())


def record_geometries(on: bool = True) -> None:
    """Start (afresh) or stop recording launch geometries (`geometries`)."""
    global geometries
    with _lock:
        geometries = {} if on else None


def conv_epilogue_plain(y: torch.Tensor, bias: Optional[torch.Tensor],
                        residual: Optional[torch.Tensor] = None,
                        relu: bool = False) -> torch.Tensor:
    """The plain version: ``bf16(y + bias)``, then ``bf16(. + residual)``
    (a bf16 add: the exact sum rounded once), then ReLU as the JAX
    package's ``where(x > 0, x, 0)``; as f32."""
    z = y if bias is None else y + bias.reshape(1, -1, 1, 1)
    z = z.to(torch.bfloat16)
    if residual is not None:
        z = z + residual.to(torch.bfloat16)
    if relu:
        z = torch.where(z > 0, z, torch.zeros((), dtype=z.dtype, device=z.device))
    return z.float()


def _check(y: torch.Tensor, bias: Optional[torch.Tensor],
           residual: Optional[torch.Tensor]) -> None:
    if y.dim() != 4 or y.dtype != torch.float32:
        raise ValueError(f"conv_epilogue: y must be 4-D f32, got {tuple(y.shape)} {y.dtype}")
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv_epilogue: y must be channels_last-contiguous")
    n, c, h, w = y.shape
    if n * h * w < 1 or n * h * w >= 2**30:
        raise ValueError(f"conv_epilogue: unsupported shape {tuple(y.shape)}")
    if bias is not None and (bias.dtype != torch.float32 or tuple(bias.shape) != (c,)
                             or not bias.is_contiguous() or bias.device != y.device):
        raise ValueError(f"conv_epilogue: bias must be a contiguous f32 ({c},) on {y.device}")
    if residual is not None and (residual.dtype != torch.float32
                                 or residual.shape != y.shape or residual.stride(1) != 1
                                 or residual.device != y.device):
        raise ValueError(f"conv_epilogue: residual must be f32 {tuple(y.shape)} on {y.device} "
                         f"with channel stride 1, got {tuple(residual.shape)} "
                         f"{residual.dtype} strides {residual.stride()}")


def conv_epilogue(y: torch.Tensor, bias: Optional[torch.Tensor],
                  residual: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """(N, C, H, W) f32 conv output (channels_last on the card) + (C,) f32
    bias [+ residual holding bf16 values] -> bf16 values in f32. On the
    card the result is written over ``y`` and ``y`` is returned."""
    global launches
    if y.device.type == "cpu":
        return conv_epilogue_plain(y, bias, residual, relu)
    if y.device.type != "cuda":
        raise ValueError(f"conv_epilogue: no kernel for device {y.device}")
    _check(y, bias, residual)
    n, c, h, w = y.shape
    ptrs = [y, bias, residual]
    rn, _, rh, rw = residual.stride() if residual is not None else (0, 0, 0, 0)
    vec4 = (c % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in ptrs if t is not None)
            and rn % 4 == 0 and rh % 4 == 0 and rw % 4 == 0)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    err = _library().conv_epilogue_launch(
        y.data_ptr(), bias.data_ptr() if bias is not None else None,
        residual.data_ptr() if residual is not None else None,
        n * h * w, c, h, w, rn, rh, rw, int(relu), int(vec4), y.device.index, stream)
    if err != 0:
        raise RuntimeError(f"conv_epilogue kernel launch failed: cudaError {err}")
    with _lock:
        launches += 1
        if geometries is not None:
            geometries.setdefault((view_geometry(y), bias is not None, view_geometry(residual),
                                   relu), ())
    return y
