"""The serving trunk's 3x3 convolutions on a hand-written Hopper kernel.

`conv2d_rounded` (`ops.conv`) sends a convolution here when `engages`
holds: a CUDA input, a 3x3 kernel, stride 1, groups 1, symmetric padding
equal to the dilation (at most `MAX_DILATION`), Cin and Cout multiples of
64, and nothing that requires grad. In the folded ResNet-152 these are the
50 ``branch2b`` convs of res2 to res5; every other conv keeps cuDNN
(`ops.conv.exact_conv`). The contract is `exact_conv`'s: x (N, Cin, H, W)
f32 channels_last holding bf16 values, the result a bias-free f32
(N, Cout, H, W) channels_last sum of exact products, which
`conv_epilogue` finishes; only the order of the f32 sums differs.

The kernel is `csrc/conv3x3.cu` (design notes there): an implicit GEMM on
``wgmma`` with TMA copies, built with nvcc for ``sm_90a`` at its first
launch (`native.build`). It replaces no TPU kernel: XLA's convolution
computes these on the TPU. Its weights are `pack`'d once, bf16
(Cout, 3, 3, Cin) with each 16-channel group in `PERM`'s order, and kept
beside the weight tensor (`packed`); `DeeperCut` packs its own when it is
built or moved (`warm`). A CPU tensor takes the plain version,
`conv3x3_plain`; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from deepcut_tpu_torch import native
from deepcut_tpu_torch.native import PKG, NativeLib

P, I32 = ctypes.c_void_p, ctypes.c_int
LIB = NativeLib(PKG / "csrc" / "conv3x3.cu", entries={
    "conv3x3_launch": [P] * 3 + [I32] * 6 + [I32, P]})
KERNEL = native.Kernel("conv3x3", LIB)
# `launches`: the kernel's live launch count (`native.counters`), those a
# CUDA graph replays included
__getattr__ = native.counters(__name__, launches=KERNEL)

MAX_DILATION = 8
_PACKED = WeakIdKeyDictionary()   # weight -> (data_ptr, version, `pack`'d weight)
# The packed weights' channel order within each group of 16: logical K
# position j holds input channel PERM[j], so that the kernel's thread t
# reads channels 4t..4t+3, its A fragment's columns 2t, 2t+1, 2t+8, 2t+9.
PERM = (0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15)


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[-1]))
    return (int(v), int(v))


def fits(cin: int, w_shape, stride=1, pad=0, dilation=1, groups: int = 1) -> bool:
    """The geometry half of the rule: a (Cout, Cin, 3, 3) weight over Cin
    input channels, stride 1, groups 1, padding = dilation on both axes
    (at most `MAX_DILATION`), Cin and Cout multiples of 64."""
    cout, wcin, kh, kw = w_shape
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(pad), _pair(dilation)
    return ((kh, kw) == (3, 3) and (sh, sw) == (1, 1) and groups == 1 and wcin == cin
            and ph == pw == dh == dw and 1 <= dh <= MAX_DILATION
            and cin % 64 == 0 and cout % 64 == 0)


def engages(x: torch.Tensor, w: torch.Tensor, stride=1, pad=0, dilation=1,
            groups: int = 1) -> bool:
    """`conv2d_rounded`'s rule: `fits`, on a CUDA input, with nothing that
    requires grad (the kernel has no backward)."""
    return (x.dim() == 4 and fits(x.shape[1], tuple(w.shape), stride, pad, dilation, groups)
            and x.device.type == "cuda" and not (x.requires_grad or w.requires_grad))


def _perm_index(cin: int, device) -> torch.Tensor:
    """Input channel at each logical K position of a tap: `PERM` per group."""
    groups = torch.arange(0, cin, 16, device=device).reshape(-1, 1)
    return (groups + torch.tensor(PERM, device=device)).reshape(-1)


def pack(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) weights holding bf16 values -> the kernel's bf16
    (Cout, 3, 3, Cin), contiguous, channels in `PERM`'s order per group of
    16. Exact: the values are bf16 already."""
    if w.dim() != 4 or tuple(w.shape[2:]) != (3, 3) or w.shape[1] % 16:
        raise ValueError(f"conv3x3.pack: want (Cout, Cin, 3, 3) with Cin % 16 == 0, "
                         f"got {tuple(w.shape)}")
    idx = _perm_index(w.shape[1], w.device)
    return w.detach().permute(0, 2, 3, 1)[..., idx].to(torch.bfloat16).contiguous()


def packed(w: torch.Tensor) -> torch.Tensor:
    """`pack(w)`, made once per weight tensor and kept beside it while it
    lives and holds the same data (its storage and version counter); a
    serving module warms this when it is built or moved (`warm`), so a
    call, and a CUDA graph's capture, finds it made."""
    version = None if w.is_inference() else w._version
    held = _PACKED.get(w)
    if held is not None and held[:2] == (w.data_ptr(), version):
        return held[2]
    if w.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("conv3x3: weights packed inside a CUDA graph's capture; "
                           "run the forward once eagerly first")
    wk = pack(w)
    _PACKED[w] = (w.data_ptr(), version, wk)
    return wk


def warm(weights) -> None:
    """`packed` for each of `weights` on the card that the kernel could take
    (a (Cout, Cin, 3, 3) weight with Cin and Cout multiples of 64)."""
    for w in weights:
        if w.is_cuda and w.dim() == 4 and fits(w.shape[1], tuple(w.shape), 1, 1, 1):
            packed(w)


def unpack(wk: torch.Tensor) -> torch.Tensor:
    """`pack`'s inverse: (Cout, Cin, 3, 3) f32."""
    idx = torch.argsort(_perm_index(wk.shape[3], wk.device))
    return wk[..., idx].permute(0, 3, 1, 2).float().contiguous()


def conv3x3_plain(x: torch.Tensor, wk: torch.Tensor, dilation: int) -> torch.Tensor:
    """The plain version: f32 `F.conv2d` with the unpacked weights,
    padding = dilation."""
    return F.conv2d(x, unpack(wk), None, padding=dilation, dilation=dilation)


def _check(x: torch.Tensor, wk: torch.Tensor, dilation: int) -> None:
    if x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f"conv3x3: x must be 4-D f32, got {tuple(x.shape)} {x.dtype}")
    n, cin, h, w = x.shape
    if (wk.dtype != torch.bfloat16 or wk.dim() != 4 or tuple(wk.shape[1:]) != (3, 3, cin)
            or not wk.is_contiguous()):
        raise ValueError(f"conv3x3: wk must be contiguous bf16 (Cout, 3, 3, {cin}) from "
                         f"`pack`, got {tuple(wk.shape)} {wk.dtype}")
    if not fits(cin, (wk.shape[0], cin, 3, 3), pad=dilation, dilation=dilation):
        raise ValueError(f"conv3x3: no kernel for Cin {cin}, Cout {wk.shape[0]}, "
                         f"dilation {dilation}")
    if x.requires_grad or wk.requires_grad:
        raise ValueError("conv3x3: the kernel has no backward; x and wk must not require grad")
    if wk.device != x.device:
        raise ValueError(f"conv3x3: x on {x.device}, wk on {wk.device}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv3x3: x must be channels_last-contiguous")


def conv3x3(x: torch.Tensor, wk: torch.Tensor, dilation: int) -> torch.Tensor:
    """(N, Cin, H, W) f32 holding bf16 values, channels_last, and `pack`'d
    weights -> the bias-free f32 (N, Cout, H, W) convolution, stride 1,
    padding = dilation; channels_last on the card."""
    _check(x, wk, dilation)
    if not native.on_card(x, "conv3x3"):
        return conv3x3_plain(x, wk, dilation)
    n, cin, h, w = x.shape
    cout = wk.shape[0]
    if not 1 <= n * h * w < 2**31 - 2**20:
        raise ValueError(f"conv3x3: unsupported shape {tuple(x.shape)}")
    if x.data_ptr() % 16 or wk.data_ptr() % 16:
        raise ValueError("conv3x3: x and wk must be 16-byte aligned")
    y = torch.empty((n, cout, h, w), dtype=torch.float32, device=x.device,
                    memory_format=torch.channels_last)
    KERNEL(x.device, x.data_ptr(), wk.data_ptr(), y.data_ptr(), n, h, w, cin, cout, dilation,
           geometry=lambda: ((native.view_geometry(x), tuple(wk.shape), dilation), ()))
    return y
