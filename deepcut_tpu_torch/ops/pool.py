"""Max pooling with Caffe-exact (ceil-mode) geometry, NCHW.

Counterpart of `deepcut_tpu.ops.pool.max_pool2d`. Caffe's output size is
``ceil((H + 2*pad - k) / stride) + 1``, shrunk by one when ``pad > 0`` and
the last window would start beyond ``H + pad`` (the DeeperCut stem pool
maps 344 -> 172, not 171). `F.max_pool2d(ceil_mode=True)` applies the same
rule except that it also shrinks when ``pad == 0``, which can only matter
for stride > kernel; the result is checked against `pool_output_size` and a
geometry the two disagree on raises.

The backward is Caffe's (pooling_layer.cpp): each output's whole gradient
goes to the FIRST maximum of its window in row-major scan order, and
overlapping windows add. `F.max_pool2d` keeps that argmax (its forward
replaces the running max only on a strictly greater value, on the CPU and
on CUDA, NCHW and channels_last alike), so its autograd backward is the
reference's. Post-ReLU zeros tie often in the stem pool, so the rule shows
in the trajectory; tests/test_torch_training.py holds it against the JAX
package with planted ties, and chip_smoke.py against a plain first-max
scatter on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pool_output_size(size: int, kernel: int, stride: int, pad: int) -> int:
    out = -(-(size + 2 * pad - kernel) // stride) + 1  # ceil division
    if pad > 0 and (out - 1) * stride >= size + pad:
        out -= 1
    return out


def max_pool2d(x: torch.Tensor, *, kernel: int, stride: int = 1, pad: int = 0) -> torch.Tensor:
    """MAX pooling, Caffe ceil-mode. x: (N, C, H, W). Padding never wins."""
    y = F.max_pool2d(x, kernel, stride, pad, ceil_mode=True)
    want = (pool_output_size(x.shape[2], kernel, stride, pad),
            pool_output_size(x.shape[3], kernel, stride, pad))
    if tuple(y.shape[2:]) != want:
        raise ValueError(f"max_pool2d: Caffe geometry {want} differs from "
                         f"ceil-mode {tuple(y.shape[2:])} for input "
                         f"{tuple(x.shape[2:])}, k={kernel} s={stride} p={pad}")
    return y
