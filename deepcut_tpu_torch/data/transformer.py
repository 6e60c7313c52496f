"""DataTransformer: Caffe's per-sample preprocessing
(src/caffe/data_transformer.cpp): mean (file or per-channel values), scale,
random/center crop by phase, random mirror. Operates on CHW float arrays.

The port's own copy of `deepcut_tpu.data.transformer` (jax-free; held against the
original by tests/test_torch_data_layers.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from deepcut_tpu_torch.proto.text_format import PbNode


class DataTransformer:
    def __init__(self, param: Optional[PbNode] = None, phase: str = "TRAIN",
                 rng: Optional[np.random.RandomState] = None):
        param = param or PbNode()
        self.scale = param.get_float("scale", 1.0)
        self.crop_size = param.get_int("crop_size", 0)
        self.mirror = param.get_bool("mirror", False)
        self.mean_values = [float(v) for v in param.get_list("mean_value")]
        self.mean_file = param.get_str("mean_file", "")
        self.phase = phase
        self.rng = rng or np.random.RandomState(0)
        self._mean_blob: Optional[np.ndarray] = None
        if self.mean_file:
            from deepcut_tpu_torch.io import blobproto_bytes_to_array
            with open(self.mean_file, "rb") as f:
                arr = blobproto_bytes_to_array(f.read())
            self._mean_blob = arr.reshape(arr.shape[-3], arr.shape[-2], arr.shape[-1])

    def __call__(self, data: np.ndarray) -> np.ndarray:
        """CHW float in, CHW float out (cropped/mirrored/normalised)."""
        out = np.asarray(data, np.float32)
        c, h, w = out.shape
        if self._mean_blob is not None:
            out = out - self._mean_blob
        elif self.mean_values:
            mv = self.mean_values
            if len(mv) == 1:
                mv = mv * c
            out = out - np.asarray(mv, np.float32)[:, None, None]
        if self.crop_size:
            cs = self.crop_size
            if self.phase == "TRAIN":
                h_off = int(self.rng.randint(0, h - cs + 1))
                w_off = int(self.rng.randint(0, w - cs + 1))
            else:
                h_off = (h - cs) // 2
                w_off = (w - cs) // 2
            out = out[:, h_off:h_off + cs, w_off:w_off + cs]
        if self.mirror and self.rng.randint(0, 2):
            # no phase gate: data_transformer.cpp:51 mirrors in ANY phase;
            # only the crop offset is phase-dependent
            out = out[:, :, ::-1]
        if self.scale != 1.0:
            out = out * self.scale
        return np.ascontiguousarray(out)
