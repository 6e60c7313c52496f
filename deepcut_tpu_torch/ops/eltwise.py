"""Eltwise / blob-shape ops (counterparts of `deepcut_tpu.ops.eltwise`), NCHW.

Axes are Caffe's own: the port keeps Caffe's NCHW order, so a prototxt's
``axis`` needs no translation (the JAX package maps it onto NHWC).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from deepcut_tpu_torch.ops.activations import const


def crop_like(x: torch.Tensor, ref_shape: Sequence[int], *, axis: int = 2,
              offsets: Sequence[int] = ()) -> torch.Tensor:
    """Crop `x` to `ref_shape` on every dim from `axis` onward (Caffe's Crop,
    crop_layer.cpp): at `offsets` per dim, one offset for all dims, or the
    top-left corner by default (DeeperCut's head alignment). NCHW
    numbering: the default ``axis=2`` crops H and W."""
    axis = axis + x.dim() if axis < 0 else axis
    idx = []
    for i in range(x.dim()):
        if i < axis:
            idx.append(slice(None))
            continue
        j = i - axis
        off = offsets[j] if j < len(offsets) else (offsets[0] if len(offsets) == 1 else 0)
        idx.append(slice(off, off + int(ref_shape[i])))
    return x[tuple(idx)]


def eltwise_sum(inputs: Sequence[torch.Tensor],
                coeffs: Optional[Sequence[float]] = None) -> torch.Tensor:
    if coeffs is None:
        out = inputs[0]
        for t in inputs[1:]:
            out = out + t
        return out
    if len(coeffs) != len(inputs):
        raise ValueError(f"Eltwise SUM: {len(coeffs)} coeffs for {len(inputs)} bottoms "
                         "(must match or be omitted)")
    out = None
    for t, c in zip(inputs, coeffs):
        term = t if c == 1.0 else t * const(c, t)
        out = term if out is None else out + term
    return out


def eltwise_prod(inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    out = inputs[0]
    for t in inputs[1:]:
        out = out * t
    return out


def eltwise_max(inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    out = inputs[0]
    for t in inputs[1:]:
        out = torch.maximum(out, t)
    return out


def concat(inputs: Sequence[torch.Tensor], *, axis: int) -> torch.Tensor:
    return torch.cat(list(inputs), dim=axis)


def slice_op(x: torch.Tensor, *, axis: int, slice_points: Sequence[int], num_outputs: int):
    """Caffe Slice layer: split along axis at slice_points (or evenly)."""
    size = x.shape[axis]
    if slice_points:
        points = [0] + list(slice_points) + [size]
    else:
        if size % num_outputs:
            raise ValueError(f"Slice: axis size {size} not divisible by {num_outputs} tops"
                             " (set slice_point for uneven splits)")
        step = size // num_outputs
        points = [i * step for i in range(num_outputs)] + [size]
    return [x.narrow(axis, a, b - a) for a, b in zip(points[:-1], points[1:])]


def tile_op(x: torch.Tensor, *, axis: int, tiles: int) -> torch.Tensor:
    reps = [1] * x.dim()
    reps[axis] = tiles
    return x.repeat(reps)


def flatten_op(x: torch.Tensor, *, axis: int = 1, end_axis: int = -1) -> torch.Tensor:
    nd = x.dim()
    axis = axis + nd if axis < 0 else axis
    end_axis = end_axis + nd if end_axis < 0 else end_axis
    return x.reshape(list(x.shape[:axis]) + [-1] + list(x.shape[end_axis + 1:]))


def split_op(x: torch.Tensor, num: int):
    """Caffe Split layer: identity fan-out (autograd sums the tops' gradients)."""
    return [x] * num


def batch_reindex(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """BatchReindex layer: gather along the batch dimension."""
    return x.index_select(0, indices.reshape(-1).to(torch.int64))


def reduction_op(x: torch.Tensor, *, op: str = "SUM", axis: int = 0,
                 coeff: float = 1.0) -> torch.Tensor:
    """Reduction layer: reduce trailing axes from `axis` onward to a vector."""
    nd = x.dim()
    axis = axis + nd if axis < 0 else axis
    axes = tuple(range(axis, nd))
    xf = x.float()
    if op == "SUM":
        y = xf.sum(dim=axes)
    elif op == "ASUM":
        y = xf.abs().sum(dim=axes)
    elif op == "SUMSQ":
        y = (xf * xf).sum(dim=axes)
    elif op == "MEAN":
        y = xf.mean(dim=axes)
    else:
        raise ValueError(f"unknown reduction {op}")
    return (y * coeff).to(x.dtype)
