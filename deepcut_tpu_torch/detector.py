"""R-CNN-style windowed detector (reference: python/caffe/detector.py).

Crops windows (optionally with context padding), warps to the net input
size, and classifies each window batch-wise: the port's copy of
`deepcut_tpu.detector` over `compat.Net` (the card unless ``device="cpu"``;
f32 unless ``compute_dtype=torch.bfloat16``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import deepcut_tpu_torch.compat as caffe
from deepcut_tpu_torch import io as dio


class Detector(caffe.Net):
    def __init__(self, model_file: str, pretrained_file: Optional[str] = None,
                 mean: Optional[np.ndarray] = None,
                 input_scale: Optional[float] = None,
                 raw_scale: Optional[float] = None,
                 channel_swap: Optional[Sequence[int]] = None,
                 context_pad: int = 0, device: str = "cuda", compute_dtype=None):
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
        self.context_pad = context_pad
        # input-space mean canvas for context padding (reference
        # detector.py _configure_crop: the transformer mean deprocessed back
        # to the image domain — inverse channel swap, inverse raw_scale)
        dims = self.blobs[in_].shape[2:]
        channels = self.blobs[in_].shape[1]
        self.crop_dims = (int(dims[0]), int(dims[1]), int(channels))
        if mean is None:
            cm = np.zeros((1, 1, channels), np.float32)
        else:
            m = np.asarray(mean, np.float32)
            if m.ndim == 3:
                # full spatial mean (C,H,W) -> HWC canvas, like the
                # reference's _configure_crop transpose (detector.py:196-218)
                cm = m.transpose(1, 2, 0).copy()
            else:
                cm = m.reshape(1, 1, -1).copy()
            if channel_swap is not None:
                inv = [list(channel_swap).index(i) for i in range(channels)]
                cm = cm[:, :, inv]
            if raw_scale is not None:
                cm = cm / raw_scale
        self.crop_mean = cm

    def detect_windows(self, images_windows: Sequence[Tuple[str, np.ndarray]]) -> List[Dict]:
        window_inputs = []
        for image_fname, windows in images_windows:
            image = dio.load_image(image_fname)
            for window in windows:
                window_inputs.append(self.crop(image, window))
        in_ = self.inputs[0]
        dims = self.blobs[in_].shape[2:]
        data = np.stack([
            self.transformer.preprocess(in_, dio.resize_image(wi, dims))
            for wi in window_inputs])
        out = self.forward_all(**{in_: data})[self.outputs[0]]
        predictions = out.reshape(len(window_inputs), -1)
        detections = []
        ix = 0
        for image_fname, windows in images_windows:
            for window in windows:
                detections.append({
                    "window": window,
                    "prediction": predictions[ix],
                    "filename": image_fname,
                })
                ix += 1
        return detections

    @staticmethod
    def _context_axis(lo: float, hi: float, im_dim: int, out_size: int,
                      enlarge: float) -> Tuple[int, int, int, int]:
        """One axis of the context-crop geometry.

        The window span [lo, hi] (inclusive endpoints, Caffe window-file
        convention) is enlarged about its midpoint by `enlarge`, then mapped
        onto a canvas axis of `out_size` pixels.  Returns
        (src_lo, src_hi, dst_off, dst_len): the in-image source slice and
        where its resized content lands on the canvas — parts of the
        enlarged span outside the image become canvas (mean) pixels rather
        than stretched content.  Semantics re-derived from reference
        detector.py:125-178 (window_inputs context embedding).
        """
        half = (hi - lo + 1) / 2.0
        mid = lo + half
        lo_e = float(np.round(mid - enlarge * half))
        hi_e = float(np.round(mid + enlarge * half))
        to_canvas = out_size / (hi_e - lo_e + 1)  # enlarged-span -> canvas px
        dst_off = int(round(max(0.0, -lo_e) * to_canvas))
        src_lo = min(max(lo_e, 0.0), float(im_dim))
        src_hi = min(max(hi_e, 0.0), float(im_dim))
        if src_hi <= src_lo:
            raise ValueError("context window lies outside the image")
        dst_len = min(int(round((src_hi - src_lo + 1) * to_canvas)),
                      out_size - dst_off)
        return int(src_lo), int(src_hi), dst_off, dst_len

    def crop(self, im: np.ndarray, window) -> np.ndarray:
        """Crop a window (ymin, xmin, ymax, xmax).

        Plain crops are EXCLUSIVE slices.  With context_pad, the box is
        enlarged about its centre so the window occupies the central
        (crop_size - 2*context_pad) pixels of the net input, the in-image
        content is resized, and embedded at its true offset into a
        mean-filled crop_dims canvas (reference detector.py:125-178
        semantics, re-derived as a per-axis geometry helper).
        """
        y0, x0, y1, x1 = (float(v) for v in np.asarray(window, np.float64))
        if not self.context_pad:
            return im[int(y0):int(y1), int(x0):int(x1)]

        crop_size = self.crop_dims[1]  # reference assumes square net input
        enlarge = crop_size / float(crop_size - 2 * self.context_pad)
        im_h, im_w = im.shape[:2]
        sy0, sy1, py, ph = self._context_axis(y0, y1, im_h, crop_size, enlarge)
        sx0, sx1, px, pw = self._context_axis(x0, x1, im_w, crop_size, enlarge)
        patch = dio.resize_image(
            np.asarray(im[sy0:sy1, sx0:sx1], np.float32), (ph, pw))
        out = np.ones(self.crop_dims, np.float32) * self.crop_mean
        out[py:py + ph, px:px + pw] = patch
        return out
