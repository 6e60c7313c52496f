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


# -- the graph engine's params, by layer type ---------------------------------
def _graph_layout(layer_type: str, key: str, a: np.ndarray, to_torch: bool) -> np.ndarray:
    """One blob between the JAX package's graph layouts and the port's:
    conv weights HWIO <-> OIHW, deconv weights ``(kh, kw, Cin, Cout/g)`` <->
    ``(Cin, Cout/g, kh, kw)`` (transposed, never flipped), the 4-D bias of a
    two-bottom Scale / Bias NHWC <-> NCHW; InnerProduct's ``(N_out, K)`` (or
    ``(K, N_out)``) and every other blob as they are."""
    if a.ndim != 4:
        return a
    if key in ("w", "w_q") and layer_type == "Convolution":
        return a.transpose(3, 2, 0, 1) if to_torch else a.transpose(2, 3, 1, 0)
    if key in ("w", "w_q") and layer_type == "Deconvolution":
        return a.transpose(2, 3, 0, 1)  # its own inverse
    if key == "beta" and layer_type in ("Scale", "Bias"):
        return a.transpose(0, 3, 1, 2) if to_torch else a.transpose(0, 2, 3, 1)
    return a


def graph_params_from_numpy(params: Mapping[str, Mapping[str, np.ndarray]],
                            layer_types: Mapping[str, str]) -> Params:
    """A JAX `deepcut_tpu.core.graph.Net.params` dict (numpy, or anything
    `np.asarray` takes) -> the port's `core.graph.Net` layouts as CPU
    tensors, chosen by each layer's type in `layer_types` (``Net.layer_types()``)
    and not by its name. Floats become f32 (a bf16 blob's values are kept),
    int8 ``w_q`` stays int8, ``act_scale`` a 0-dim f32."""
    out: Params = {}
    for name, entry in params.items():
        t = layer_types.get(name, "")
        conv: Dict[str, torch.Tensor] = {}
        for k, v in entry.items():
            a = np.asarray(v)
            a = a.astype(np.int8 if k == "w_q" else np.float32)
            conv[k] = torch.tensor(np.ascontiguousarray(_graph_layout(t, k, a, True)))
        out[name] = conv
    return out


def graph_params_to_numpy(params: Mapping[str, Mapping[str, torch.Tensor]],
                          layer_types: Mapping[str, str]) -> Dict[str, Dict[str, np.ndarray]]:
    """The exact inverse of `graph_params_from_numpy`: the port's graph
    params (any device) -> contiguous numpy in the JAX package's layouts,
    f32 (a bf16 blob's values widened) and int8 ``w_q``."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, entry in params.items():
        t = layer_types.get(name, "")
        conv: Dict[str, np.ndarray] = {}
        for k, v in entry.items():
            v = v.detach().cpu()
            a = v.numpy() if v.dtype == torch.int8 else v.float().numpy()
            conv[k] = np.array(_graph_layout(t, k, a, False), order="C")
        out[name] = conv
    return out


def graph_state_to_numpy(state: Mapping[str, object], layer_types: Mapping[str, str]
                         ) -> Dict[str, object]:
    """A graph solver's state (``iter`` and its per-blob trees: SGD's
    ``history``, AdaDelta's ``history`` and ``update_sq``, Adam's ``m`` and
    ``v``) -> numpy in the JAX package's layouts, each tree as
    `graph_params_to_numpy`, ``iter`` an int32 scalar."""
    return {k: (np.asarray(int(v), np.int32) if k == "iter" else graph_params_to_numpy(v, layer_types))
            for k, v in state.items()}


def graph_state_from_numpy(state: Mapping[str, object], layer_types: Mapping[str, str]
                           ) -> Dict[str, object]:
    """The inverse of `graph_state_to_numpy`: the JAX package's state trees
    (numpy, or anything `np.asarray` takes) -> the port's layouts as CPU
    tensors, ``iter`` an int."""
    return {k: (int(np.asarray(v)) if k == "iter" else graph_params_from_numpy(v, layer_types))
            for k, v in state.items()}
