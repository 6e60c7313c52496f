"""Image / blob IO utilities (reference: python/caffe/io.py).

The port's own copy of `deepcut_tpu.io` (jax-free; held against the
original by tests/test_torch_frontends.py).

`Transformer` reproduces the pycaffe preprocessing contract (transpose,
channel swap, raw scale, mean subtract, input scale) so reference recipes
port unchanged; array<->BlobProto round-trips interoperate with Caffe tools.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def load_image(path: str, color: bool = True) -> np.ndarray:
    """float [0,1] RGB HxWx3 (or HxWx1 grayscale), like caffe.io.load_image."""
    from PIL import Image

    with Image.open(path) as im:
        if color:
            arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
        else:
            arr = np.asarray(im.convert("L"), np.float32)[:, :, None] / 255.0
    return arr


def resize_image(im: np.ndarray, new_dims: Tuple[int, int], interp_order: int = 1) -> np.ndarray:
    """Resize HxWxC to new_dims (height, width).

    Resampled in FLOAT (PIL mode-'F' per channel) like the reference's
    skimage path (io.py:305-335) — no intermediate uint8 quantisation.
    interp_order: 0 nearest, 1 bilinear, >=2 bicubic (skimage order>=2
    maps to PIL's cubic)."""
    from PIL import Image

    h, w = int(new_dims[0]), int(new_dims[1])
    if im.shape[-1] == 1:
        chans = [im[:, :, 0]]
    else:
        chans = [im[:, :, c] for c in range(im.shape[-1])]
    method = (Image.NEAREST if interp_order == 0 else
              Image.BILINEAR if interp_order == 1 else Image.BICUBIC)
    out = []
    for ch in chans:
        img = Image.fromarray(np.asarray(ch, np.float32), mode="F")
        out.append(np.asarray(img.resize((w, h), method), np.float32))
    return np.stack(out, axis=-1)


def oversample(images: Sequence[np.ndarray], crop_dims: Tuple[int, int]) -> np.ndarray:
    """10-crop oversampling: 4 corners + centre, each also mirrored.

    Per image the output order matches caffe.io.oversample (re-derived
    semantics, python/caffe/io.py:340+): the five canonical crops
    [top-left, top-right, bottom-left, bottom-right, centre] followed by
    the horizontal mirrors of those same five.
    """
    ch, cw = int(crop_dims[0]), int(crop_dims[1])
    im_h, im_w = images[0].shape[:2]
    # top-left anchor of each canonical crop; centre truncates like the
    # reference's float->int cast (floor for the in-bounds case)
    anchors = [(y, x) for y in (0, im_h - ch) for x in (0, im_w - cw)]
    anchors.append((int(im_h / 2.0 - ch / 2.0), int(im_w / 2.0 - cw / 2.0)))
    per_image = []
    for im in images:
        five = np.stack([im[y:y + ch, x:x + cw] for y, x in anchors])
        per_image.append(five)
        per_image.append(five[:, :, ::-1])  # mirrors, same crop order
    return np.concatenate(per_image).astype(np.float32, copy=False)


class Transformer:
    """Preprocessing pipeline identical to caffe.io.Transformer."""

    def __init__(self, inputs: Dict[str, Tuple[int, ...]]):
        self.inputs = inputs
        self.transpose: Dict[str, Tuple[int, ...]] = {}
        self.channel_swap: Dict[str, Tuple[int, ...]] = {}
        self.raw_scale: Dict[str, float] = {}
        self.mean: Dict[str, np.ndarray] = {}
        self.input_scale: Dict[str, float] = {}

    def set_transpose(self, in_, order):
        self.transpose[in_] = tuple(order)

    def set_channel_swap(self, in_, order):
        self.channel_swap[in_] = tuple(order)

    def set_raw_scale(self, in_, scale):
        self.raw_scale[in_] = scale

    def set_mean(self, in_, mean):
        mean = np.asarray(mean, np.float32)
        if mean.ndim == 1 and mean.size > 1:
            mean = mean[:, None, None]
        self.mean[in_] = mean

    def set_input_scale(self, in_, scale):
        self.input_scale[in_] = scale

    def preprocess(self, in_, data: np.ndarray) -> np.ndarray:
        out = np.asarray(data, np.float32)
        # reference io.py preprocess: mismatched inputs are resized to the
        # net's input dims BEFORE the transpose (HxWxC at this point)
        in_dims = tuple(self.inputs[in_][2:]) if in_ in self.inputs else None
        if (in_dims and out.ndim == 3 and out.shape[:2] != in_dims):
            out = resize_image(out, in_dims)
        if in_ in self.transpose:
            out = out.transpose(self.transpose[in_])
        if in_ in self.channel_swap:
            out = out[np.array(self.channel_swap[in_]), :, :]
        if in_ in self.raw_scale:
            out = out * self.raw_scale[in_]
        if in_ in self.mean:
            out = out - self.mean[in_]
        if in_ in self.input_scale:
            out = out * self.input_scale[in_]
        return out

    def deprocess(self, in_, data: np.ndarray) -> np.ndarray:
        out = np.asarray(data, np.float32).squeeze()
        if in_ in self.input_scale:
            out = out / self.input_scale[in_]
        if in_ in self.mean:
            out = out + self.mean[in_]
        if in_ in self.raw_scale:
            out = out / self.raw_scale[in_]
        if in_ in self.channel_swap:
            inv = np.argsort(self.channel_swap[in_])
            out = out[inv, :, :]
        if in_ in self.transpose:
            out = out.transpose(np.argsort(self.transpose[in_]))
        return out


def array_to_blobproto_bytes(arr: np.ndarray) -> bytes:
    """Serialise an ndarray as a BlobProto message (reference io.py)."""
    from deepcut_tpu_torch.proto import wire

    enc = wire.Encoder()
    shape = wire.Encoder()
    shape.packed_int64s(1, arr.shape)
    enc.message(7, shape)
    enc.packed_floats(5, np.asarray(arr, np.float32).reshape(-1))
    return enc.tobytes()


def blobproto_bytes_to_array(buf: bytes) -> np.ndarray:
    from deepcut_tpu_torch.proto.caffemodel import _decode_blob

    blob = _decode_blob(buf)
    return blob.data
