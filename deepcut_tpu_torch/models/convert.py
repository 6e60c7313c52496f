"""Weights carried across from the JAX package's layout.

The JAX package (and `proto.caffemodel.load_deepercut_params`, the
port's copy of its ``.caffemodel`` reader) keeps conv weights
HWIO ``(kh, kw, Cin, Cout)`` and deconv weights in its native
``(kh, kw, Cin, Cout)`` order. PyTorch wants OIHW for `F.conv2d` and
``(Cin, Cout, kh, kw)`` for `F.conv_transpose2d`. The deconv weight is only
transposed, never flipped: `F.conv_transpose2d` is already the transpose of
a conv, while the JAX package flips because it lowers deconv as a conv over
a zero-dilated input. Caffe layer names are kept as keys.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

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


def qparams_from_numpy(qparams: Mapping[str, Mapping[str, np.ndarray]],
                       act_scales: Mapping[str, np.ndarray]
                       ) -> Tuple[Params, Dict[str, torch.Tensor]]:
    """The JAX package's int8 quantization (``prepare_int8``'s
    ``(qparams, act_scales)``) -> the port's: int8 ``w_q`` HWIO -> OIHW, the
    int8 deconv's ``(kh, kw, Cin, Cout)`` -> ``(Cin, Cout, kh, kw)`` (no
    flip, as `params_from_numpy`); float weights as `params_from_numpy`;
    ``w_scale``, ``b`` and the activation scales f32, on the CPU."""
    out: Params = {}
    for name, entry in qparams.items():
        floats = params_from_numpy({name: {k: v for k, v in entry.items() if k != "w_q"}})[name]
        if "w_q" in entry:
            a = np.asarray(entry["w_q"], np.int8)
            a = a.transpose(2, 3, 0, 1) if name.startswith(DECONV_PREFIX) else a.transpose(3, 2, 0, 1)
            floats["w_q"] = torch.tensor(np.ascontiguousarray(a))
        out[name] = floats
    return out, {k: torch.tensor(np.float32(v)) for k, v in act_scales.items()}


def params_to_numpy(params: Mapping[str, Mapping[str, torch.Tensor]]) -> Dict[str, Dict[str, np.ndarray]]:
    """The exact inverse of `params_from_numpy`: the port's torch dict (any
    device, any memory format) -> contiguous f32 numpy in the JAX package's
    layouts. Snapshots, ``.caffemodel`` export and checkpoints read by the
    JAX package go through it."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, entry in params.items():
        conv: Dict[str, np.ndarray] = {}
        for k, v in entry.items():
            a = v.detach().to("cpu", torch.float32).numpy()
            if k == "w" and a.ndim == 4:
                a = a.transpose(2, 3, 0, 1) if name.startswith(DECONV_PREFIX) else a.transpose(2, 3, 1, 0)
            conv[k] = np.array(a, order="C")  # a copy: the source trains on
        out[name] = conv
    return out


def load_caffemodel(path: str) -> Params:
    """A DeeperCut ``.caffemodel`` -> the port's f32 param dict on the CPU."""
    from deepcut_tpu_torch.proto.caffemodel import load_deepercut_params

    return params_from_numpy(load_deepercut_params(path))


def save_caffemodel(path: str, params: Mapping[str, Mapping[str, torch.Tensor]]) -> None:
    """The port's param dict -> a ``.caffemodel`` the reference reads."""
    from deepcut_tpu_torch.proto.caffemodel import save_caffemodel as save

    save(path, params_to_numpy(params))
