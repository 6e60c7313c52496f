"""Datum protobuf codec (caffe.proto `Datum`: channels=1, height=2, width=3,
data=4, label=5, float_data=6, encoded=7) and image conversion helpers
(reference: src/caffe/util/io.cpp CVMatToDatum / DatumToCVMat).

The port's own copy of `deepcut_tpu.data.datum` (jax-free; held against the
original by tests/test_torch_data_layers.py).
"""

from __future__ import annotations

import io as _io
from typing import Optional, Tuple

import numpy as np

from deepcut_tpu_torch.proto import wire


class Datum:
    def __init__(self, channels=0, height=0, width=0, data=b"",
                 label: Optional[int] = None, float_data=(), encoded=False):
        self.channels = channels
        self.height = height
        self.width = width
        self.data = data
        self.label = label
        self.float_data = list(float_data)
        self.encoded = encoded

    def encode(self) -> bytes:
        enc = wire.Encoder()
        enc.varint(1, self.channels).varint(2, self.height).varint(3, self.width)
        if self.data:
            enc.bytes_(4, self.data)
        if self.label is not None:
            enc.varint(5, self.label)
        if self.float_data:
            enc.packed_floats(6, np.asarray(self.float_data, np.float32))
        if self.encoded:
            enc.varint(7, 1)
        return enc.tobytes()

    @staticmethod
    def decode(buf: bytes) -> "Datum":
        fields = wire.decode(buf)
        d = Datum()
        if 1 in fields:
            d.channels = fields[1][0][1]
        if 2 in fields:
            d.height = fields[2][0][1]
        if 3 in fields:
            d.width = fields[3][0][1]
        if 4 in fields:
            d.data = fields[4][0][1]
        if 5 in fields:
            d.label = fields[5][0][1]
        if 6 in fields:
            d.float_data = wire.read_floats(fields[6]).tolist()
        if 7 in fields:
            d.encoded = bool(fields[7][0][1])
        return d

    # -- array conversion (CHW uint8, BGR — the Caffe convention) ---------
    def to_array(self, color: bool = True) -> np.ndarray:
        """Decode to float32 CHW (BGR for color images)."""
        if self.encoded:
            from PIL import Image

            with Image.open(_io.BytesIO(self.data)) as im:
                arr = np.asarray(im.convert("RGB" if color else "L"), np.uint8)
            if arr.ndim == 2:
                arr = arr[:, :, None]
            else:
                arr = arr[:, :, ::-1]  # RGB -> BGR
            return arr.transpose(2, 0, 1).astype(np.float32)
        if self.data:
            arr = np.frombuffer(self.data, np.uint8).astype(np.float32)
            return arr.reshape(self.channels, self.height, self.width)
        return np.asarray(self.float_data, np.float32).reshape(
            self.channels, self.height, self.width)

    @staticmethod
    def from_array(arr: np.ndarray, label: Optional[int] = None) -> "Datum":
        """uint8 CHW -> raw Datum; float CHW -> float_data Datum."""
        arr = np.asarray(arr)
        c, h, w = arr.shape
        if arr.dtype == np.uint8:
            return Datum(c, h, w, data=arr.tobytes(), label=label)
        return Datum(c, h, w, float_data=arr.reshape(-1).astype(np.float32),
                     label=label)

    @staticmethod
    def from_image_file(path: str, label: Optional[int] = None,
                        encoded: bool = True) -> "Datum":
        if encoded:
            with open(path, "rb") as f:
                payload = f.read()
            from PIL import Image
            with Image.open(_io.BytesIO(payload)) as im:
                w, h = im.size
            return Datum(3, h, w, data=payload, label=label, encoded=True)
        from deepcut_tpu_torch.data.pipeline import load_image_bgr
        img = load_image_bgr(path)
        return Datum.from_array(img.transpose(2, 0, 1).astype(np.uint8), label)
