"""Batch-sharded stochastic draws for data-parallel training.

Counterpart of `deepcut_tpu.ops.shard_rng`. Caffe's stochastic layers
(Dropout, STOCHASTIC pooling) and a random DummyData draw one random tensor
per step whose leading dim is the batch. Under data parallelism each rank
holds only its rows of the global batch, and a draw of the local shape
from the step's generator would give a different mask sequence than the
single-device step. Inside `sharded_rng_batch(mesh)`, `draw_batched` draws
the GLOBAL batch from the same generator (seeded by the net's seed, the
iteration, the micro-batch and the layer, as on one device) and keeps the
rank's rows: the masks equal the single-device masks bit for bit, so the
trajectories stay equal. The cost: each rank draws the whole batch's
random tensor (the activations stay local).

The contexts of this module, `ops.losses` and `ops.norm` take an axis of
the mesh (`parallel.mesh.Axis`: ``all_reduce_``, ``size``, ``index``); a
whole `parallel.mesh.Mesh` stands for its 'data' axis (`as_axis`). Under a
spatial axis the draws key by the DATA index: the ranks of one data row
hold the same batch rows and draw the same masks.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

_CTX: Optional[Tuple[int, int]] = None   # (index along 'data', data size)


def as_axis(axis):
    """An axis as given, a mesh as its 'data' axis, None as None."""
    return getattr(axis, "data_axis", axis)


class sharded_rng_batch:
    """Context: the batch dim of stochastic draws is sharded over an axis
    (its ``index`` and ``size``; a mesh: its 'data' axis)."""

    def __init__(self, axis):
        axis = as_axis(axis)
        self.value = None if axis is None else (int(axis.index), int(axis.size))

    def __enter__(self):
        global _CTX
        self._prev, _CTX = _CTX, self.value
        return self

    def __exit__(self, *exc):
        global _CTX
        _CTX = self._prev


def draw_batched(sample: Callable[[Tuple[int, ...]], torch.Tensor],
                 shape: Tuple[int, ...]) -> torch.Tensor:
    """``sample(shape)``, with the leading (batch) dim drawn at the global
    size and sliced to this rank's rows inside a `sharded_rng_batch`
    context; a plain ``sample(shape)`` otherwise."""
    shape = tuple(int(d) for d in shape)
    if _CTX is None:
        return sample(shape)
    rank, data = _CTX
    n = shape[0]
    return sample((n * data,) + shape[1:])[rank * n:(rank + 1) * n]


def local_rows(t: torch.Tensor) -> torch.Tensor:
    """A tensor made at the global batch (a DummyData top, whose declared
    shape is the whole batch's) -> this rank's rows inside a
    `sharded_rng_batch` context; unchanged otherwise."""
    if _CTX is None:
        return t
    rank, data = _CTX
    if t.shape[0] % data:
        raise ValueError(f"a top of {t.shape[0]} rows does not split over {data} "
                         "data-parallel ranks")
    n = t.shape[0] // data
    return t[rank * n:(rank + 1) * n]
