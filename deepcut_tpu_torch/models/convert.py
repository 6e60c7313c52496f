"""Weights carried across from the JAX package's layout.

The JAX package (and `deepcut_tpu.proto.caffemodel.load_deepercut_params`,
which this port reuses to read ``.caffemodel`` files) keeps conv weights
HWIO ``(kh, kw, Cin, Cout)`` and deconv weights in its native
``(kh, kw, Cin, Cout)`` order. PyTorch wants OIHW for `F.conv2d` and
``(Cin, Cout, kh, kw)`` for `F.conv_transpose2d`. The deconv weight is only
transposed, never flipped: `F.conv_transpose2d` is already the transpose of
a conv, while the JAX package flips because it lowers deconv as a conv over
a zero-dilated input. Caffe layer names are kept as keys.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from deepcut_tpu_torch.models.resnet import Params

DECONV_PREFIX = "res5c_up_"  # the Deconvolution layers, as load_deepercut_params names them


def params_from_numpy(params: Mapping[str, Mapping[str, np.ndarray]]) -> Params:
    """JAX-layout param dict (numpy or anything `np.asarray` takes) -> the
    port's f32 torch dict on the CPU."""
    out: Params = {}
    for name, entry in params.items():
        conv: Dict[str, torch.Tensor] = {}
        for k, v in entry.items():
            a = np.asarray(v, np.float32)
            if k == "w" and a.ndim == 4:
                a = a.transpose(2, 3, 0, 1) if name.startswith(DECONV_PREFIX) else a.transpose(3, 2, 0, 1)
            conv[k] = torch.tensor(a)  # a copy: the source may be read-only
        out[name] = conv
    return out
