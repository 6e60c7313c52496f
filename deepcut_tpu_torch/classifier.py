"""Image classifier wrapper (reference: python/caffe/classifier.py).

Center-crop or 10-crop oversampled classification over a deploy net: the
port's copy of `deepcut_tpu.classifier` over `compat.Net` (the card unless
``device="cpu"``; f32 unless ``compute_dtype=torch.bfloat16``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

import deepcut_tpu_torch.compat as caffe
from deepcut_tpu_torch import io as dio


class Classifier(caffe.Net):
    def __init__(self, model_file: str, pretrained_file: Optional[str] = None,
                 image_dims: Optional[Tuple[int, int]] = None,
                 mean: Optional[np.ndarray] = None,
                 input_scale: Optional[float] = None,
                 raw_scale: Optional[float] = None,
                 channel_swap: Optional[Sequence[int]] = None,
                 device: str = "cuda", compute_dtype=None):
        super().__init__(model_file, pretrained_file, caffe.TEST, device=device,
                         compute_dtype=compute_dtype)
        in_ = self.inputs[0]
        self.transformer = dio.Transformer({in_: self.blobs[in_].shape})
        self.transformer.set_transpose(in_, (2, 0, 1))
        if mean is not None:
            self.transformer.set_mean(in_, mean)
        if input_scale is not None:
            self.transformer.set_input_scale(in_, input_scale)
        if raw_scale is not None:
            self.transformer.set_raw_scale(in_, raw_scale)
        if channel_swap is not None:
            self.transformer.set_channel_swap(in_, channel_swap)
        self.crop_dims = np.array(self.blobs[in_].shape[2:])
        if image_dims is None:
            image_dims = tuple(self.crop_dims)
        self.image_dims = image_dims

    def predict(self, inputs: Sequence[np.ndarray], oversample: bool = True) -> np.ndarray:
        in_ = self.inputs[0]
        resized = [dio.resize_image(im, self.image_dims) for im in inputs]
        if oversample:
            crops = dio.oversample(resized, tuple(self.crop_dims))
        else:
            center = np.array([(d - c) / 2.0 for d, c in
                               zip(self.image_dims, self.crop_dims)], int)
            crops = np.stack([im[center[0]:center[0] + self.crop_dims[0],
                                 center[1]:center[1] + self.crop_dims[1], :]
                              for im in resized])
        data = np.stack([self.transformer.preprocess(in_, c) for c in crops])
        out = self.forward_all(**{in_: data})[self.outputs[0]]
        predictions = out.reshape(out.shape[0], -1)
        if oversample:
            predictions = predictions.reshape(len(inputs), 10, -1).mean(axis=1)
        return predictions
