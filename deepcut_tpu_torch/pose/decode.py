"""Keypoint decode, plain PyTorch: argmax + location-refinement offsets.

Counterpart of `deepcut_tpu.pose.decode`, over the conv's NCHW layout:
``(N, J, h, w)`` part probabilities and ``(N, 2J, h, w)`` locref. This is the
plain version of the hand-written CUDA kernel (`ops/cuda_decode.py`, source
`csrc/decode_pose.cu`): the CPU path runs it, and on the card the kernel is
held against it.

Semantics (exact): per image n and joint j, the argmax over the h*w cells of
``prob[n, j]`` (row-major, ties and NaN to the first position, cells at
``row >= vh[n]`` or ``col >= vw[n]`` counted as -inf);
position = cell*8 + 4 + offset*sqrt(53), with locref channels paired as
(2j = x-offset, 2j+1 = y-offset); the pose rows are
``[x, y, confidence, offset_y, offset_x]`` (the reference's reversed offset
pair) with x, y and the offsets divided by the pyramid scale. The arithmetic
runs in f32 in the JAX package's order, so results are bit-equal to it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

STRIDE = 8.0
LOCREF_SCALE = 7.2801098892805181  # sqrt(53)


def decode_pose_batch(
    prob: torch.Tensor,
    loc: torch.Tensor,
    *,
    scale: float = 1.0,
    valid_hw: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """(N, J, h, w) prob + (N, 2J, h, w) locref -> (N, 5, J) f32 pose.

    valid_hw: optional per-image (vh, vw), each (N,) integer — cells at
    row >= vh or col >= vw are excluded from the argmax (bucket padding).
    """
    n, J, h, w = prob.shape
    dev = prob.device
    f32 = torch.float32
    sm = prob.to(f32)
    if valid_hw is not None:
        vh, vw = (v.to(dev).reshape(n, 1, 1, 1) for v in valid_hw)
        rows = torch.arange(h, device=dev).reshape(1, 1, h, 1)
        cols = torch.arange(w, device=dev).reshape(1, 1, 1, w)
        sm = torch.where((rows < vh) & (cols < vw), sm,
                         torch.tensor(float("-inf"), dtype=f32, device=dev))
    flat = sm.reshape(n, J, h * w)
    # torch.argmax keeps jnp.argmax's rules: first maximal position, first NaN
    idx = torch.argmax(flat, dim=2)                              # (N, J)
    conf = torch.gather(flat, 2, idx[..., None])[..., 0]
    row = torch.div(idx, w, rounding_mode="floor").to(f32)
    col = (idx % w).to(f32)
    off = loc.to(f32).reshape(n, J, 2, h * w)
    off_x = torch.gather(off[:, :, 0], 2, idx[..., None])[..., 0]
    off_y = torch.gather(off[:, :, 1], 2, idx[..., None])[..., 0]
    # f32 tensors, not Python scalars, so every product and quotient rounds
    # once in f32 as in the JAX package and the kernel
    stride = torch.tensor(STRIDE, dtype=f32, device=dev)
    half = torch.tensor(0.5 * STRIDE, dtype=f32, device=dev)
    mul = torch.tensor(LOCREF_SCALE, dtype=f32, device=dev)
    s = torch.tensor(scale, dtype=f32, device=dev)
    x = (col * stride + half + off_x * mul) / s
    y = (row * stride + half + off_y * mul) / s
    return torch.stack([x, y, conf, off_y * mul / s, off_x * mul / s], dim=1)


def decode_pose(
    prob: torch.Tensor,
    loc: torch.Tensor,
    *,
    scale: float = 1.0,
    valid_hw: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """One image: (J, h, w) prob + (2J, h, w) locref -> (5, J)."""
    vhw = None
    if valid_hw is not None:
        vhw = tuple(torch.tensor([int(v)]) for v in valid_hw)
    return decode_pose_batch(prob[None], loc[None], scale=scale, valid_hw=vhw)[0]
