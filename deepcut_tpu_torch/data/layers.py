"""Data-layer sources: host-side batch producers bound to graph data layers.

The port's copy of the part of `deepcut_tpu.data.layers` that the engine's
training needs: the `DataLayerSource` interface and `MemoryDataSource`
(the MemoryData layer, fed by `Net.set_input_arrays`). Each source is a
``next_batch() -> [numpy arrays, NCHW]`` producer that `core.graph.Net`
pulls from when a forward or a train step is not handed the tops. The
stores and the other sources (Data, ImageData, HDF5Data, WindowData) are
the data slice of the port, not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class DataLayerSource:
    tops: List[str]

    def next_batch(self) -> List[np.ndarray]:  # pragma: no cover - interface
        raise NotImplementedError

    def top_shapes(self) -> Optional[List[Tuple[int, ...]]]:
        """The tops' shapes as the layer declares them, or None: the net
        then pulls a batch to learn them."""
        return None


class MemoryDataSource(DataLayerSource):
    """`MemoryData` layer: arrays supplied via Net.set_input_arrays, served
    `batch_size` items at a time in order, wrapping at the end. Its declared
    shapes let a net materialise its params before the arrays are set (the
    JAX package pulls a batch instead)."""

    def __init__(self, spec, phase: str):
        mp = spec.param("memory_data_param")
        self.tops = list(spec.tops)
        self.batch_size = mp.get_int("batch_size", 1)
        self.chw = tuple(mp.get_int(k, 0) for k in ("channels", "height", "width"))
        self.data: Optional[np.ndarray] = None
        self.labels: Optional[np.ndarray] = None
        self.pos = 0

    def top_shapes(self) -> Optional[List[Tuple[int, ...]]]:
        """(batch, channels, height, width) and (batch,), as
        memory_data_param declares them (memory_data_layer.cpp
        DataLayerSetUp): a net learns its params' shapes before the arrays
        are set."""
        if not all(self.chw):
            return None
        return [(self.batch_size,) + self.chw, (self.batch_size,)][:len(self.tops)]

    def set_arrays(self, data: np.ndarray, labels: np.ndarray) -> None:
        self.data = np.asarray(data, np.float32)
        self.labels = np.asarray(labels, np.float32)
        self.pos = 0

    def next_batch(self) -> List[np.ndarray]:
        if self.data is None:
            raise RuntimeError("MemoryData: call set_input_arrays first")
        n = self.data.shape[0]
        idx = [(self.pos + i) % n for i in range(self.batch_size)]
        self.pos = (self.pos + self.batch_size) % n
        return [self.data[idx], self.labels[idx]]
