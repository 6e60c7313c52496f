"""Dense ops: InnerProduct, Embed, Softmax, ArgMax (counterparts of
`deepcut_tpu.ops.linear`), on Caffe's NCHW axes.

`inner_product` takes the weight as the layer stores it, ``(N_out, K)`` (or
``(K, N_out)`` with ``transpose``), and its operand values as they are:
the graph engine rounds them to bf16 beforehand when the net computes in
bf16 (`core.graph.Net`), so that the f32 matmul sums exact products, as
``jnp.dot(..., preferred_element_type=f32)`` of bf16 operands does.
"""

from __future__ import annotations

from typing import Optional

import torch


def inner_product(x: torch.Tensor, w: torch.Tensor, *, axis: int = 1,
                  transpose: bool = False) -> torch.Tensor:
    """flatten(x, from `axis`) @ W^T as an f32 (M, N_out) matrix, without
    bias; the caller reshapes to ``x.shape[:axis] + (N_out,)``."""
    k = 1
    for d in x.shape[axis:]:
        k *= d
    xf = x.reshape(-1, k).float()
    return xf @ (w.float() if transpose else w.float().t())


def embed(ids: torch.Tensor, table: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Embed layer: table rows at `ids` (embed_layer.cpp). table: (V, D)."""
    y = table[ids.to(torch.int64)]
    if b is not None:
        y = y + b
    return y


def softmax_op(x: torch.Tensor, *, axis: int) -> torch.Tensor:
    return torch.softmax(x.float(), dim=axis).to(x.dtype)


def argmax_op(x: torch.Tensor, *, axis: Optional[int] = None, top_k: int = 1,
              out_max_val: bool = False) -> torch.Tensor:
    """ArgMax layer (argmax_layer.cpp). With axis: the top_k along it, the
    axis kept at size top_k; without: over the flattened trailing dims per
    batch item, (N, 1, top_k) indices or (N, 2, top_k) indices and values.
    Ties rank the lower index first (a stable sort, as jnp.argsort)."""
    if axis is None:
        flat = x.reshape(x.shape[0], -1)
        order = torch.argsort(-flat, dim=1, stable=True)[:, :top_k]
        idx = order.float()
        if out_max_val:
            return torch.stack([idx, torch.gather(flat, 1, order).to(idx.dtype)], dim=1)
        return idx[:, None, :]
    xm = x.movedim(axis, -1)
    order = torch.argsort(-xm, dim=-1, stable=True)[..., :top_k]
    if out_max_val:
        return torch.gather(xm, -1, order).movedim(-1, axis)
    return order.float().movedim(-1, axis)
