"""Crop (counterpart of `deepcut_tpu.ops.eltwise.crop_like`)."""

from __future__ import annotations

from typing import Sequence

import torch


def crop_like(x: torch.Tensor, ref_shape: Sequence[int], *, axis: int = 2) -> torch.Tensor:
    """Crop `x` to `ref_shape` on every dim from `axis` onward, keeping the
    top-left corner (DeeperCut's head alignment). NCHW numbering: the
    default ``axis=2`` crops H and W."""
    return x[tuple(slice(None) if i < axis else slice(0, int(ref_shape[i]))
                   for i in range(x.ndim))]
