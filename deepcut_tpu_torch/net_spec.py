"""Programmatic network authoring (the reference's python/caffe/net_spec.py).

The port's own copy of `deepcut_tpu.net_spec` (jax-free; held against the
original by tests/test_torch_frontends.py); `NetSpec.to_net` builds the
port's `core.graph.Net`.

    from deepcut_tpu_torch.net_spec import NetSpec, layers as L

    n = NetSpec()
    n.data = L.Input(input_param=dict(shape=dict(dim=[1, 3, 64, 64])))
    n.conv1 = L.Convolution(n.data, num_output=8, kernel_size=3, pad=1)
    n.relu1 = L.ReLU(n.conv1, in_place=True)
    prototxt = n.to_proto_text()
    net = n.to_net(device="cpu")  # directly executable port Net

Layer functions accept bottoms as positional args and params as kwargs;
kwargs that belong to the layer's `<type>_param` message are nested
automatically (like the reference's assign_proto logic), `ntop` controls
multiple tops.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from deepcut_tpu_torch.proto.text_format import PbNode, dump

# LayerParameter-level fields; everything else goes into <type>_param.
_LAYER_FIELDS = {
    "name", "type", "bottom", "top", "loss_weight", "param", "include",
    "exclude", "phase", "propagate_down",
}

# Caffe type -> param message name irregularities (the camel-case rule
# below would mangle these: ReLU -> re_lu_param etc.).
_PARAM_NAMES = {
    "Convolution": "convolution_param",
    "Deconvolution": "convolution_param",
    "Data": "data_param",
    "SoftmaxWithLoss": "softmax_param",
    "SoftmaxWithLossVec": "softmax_with_loss_vec_param",
    "ReLU": "relu_param",
    "PReLU": "prelu_param",
    "TanH": "tanh_param",
    "ArgMax": "argmax_param",
}


def _param_name(layer_type: str) -> str:
    if layer_type in _PARAM_NAMES:
        return _PARAM_NAMES[layer_type]
    # CamelCase -> snake_case + _param (ReLU -> relu_param, PReLU -> prelu_param)
    out = []
    for i, ch in enumerate(layer_type):
        if ch.isupper() and i > 0 and (not layer_type[i - 1].isupper()):
            out.append("_")
        out.append(ch.lower())
    return "".join(out) + "_param"


def _assign(node: PbNode, key: str, value: Any) -> None:
    if isinstance(value, dict):
        sub = PbNode()
        for k, v in value.items():
            _assign(sub, k, v)
        node.add(key, sub)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _assign(node, key, v)
    else:
        node.add(key, value)


class Top:
    """A named output of a layer call (becomes a bottom for later layers)."""

    def __init__(self, fn: "LayerCall", index: int):
        self.fn = fn
        self.index = index


class LayerCall:
    def __init__(self, type_name: str, bottoms: Tuple, kwargs: Dict[str, Any]):
        self.type_name = type_name
        self.bottoms = bottoms
        self.in_place = kwargs.pop("in_place", False)
        self.ntop = kwargs.pop("ntop", 1)
        self.kwargs = kwargs
        self.tops = tuple(Top(self, i) for i in range(self.ntop))

    def to_node(self, names: Dict[Top, str], autonames: Dict) -> PbNode:
        node = PbNode()
        bottom_names = [names[b] for b in self.bottoms]
        if self.in_place:
            top_names = bottom_names[: self.ntop]
        else:
            top_names = [names[t] for t in self.tops]
        node.add("name", names[self.tops[0]]
                 if self.tops and not self.in_place else autonames[self])
        node.add("type", self.type_name)
        for b in bottom_names:
            node.add("bottom", b)
        for t in top_names:
            node.add("top", t)
        pname = _param_name(self.type_name)
        pnode = PbNode()
        for k, v in self.kwargs.items():
            if k in _LAYER_FIELDS or k.endswith("_param"):
                _assign(node, k, v)
            else:
                _assign(pnode, k, v)
        if pnode.fields:
            node.add(pname, pnode)
        return node


class _Layers:
    def __getattr__(self, type_name: str):
        def fn(*bottoms, **kwargs):
            call = LayerCall(type_name, bottoms, kwargs)
            if call.ntop == 0:
                # the reference returns the Function itself for ntop=0
                # (net_spec.py Silence pattern: n.silence = L.Silence(x,
                # ntop=0) — test_net_spec.py:47)
                return call
            return call.tops[0] if call.ntop == 1 else call.tops
        fn.__name__ = type_name
        return fn


layers = _Layers()
L = layers


class NetSpec:
    def __init__(self):
        object.__setattr__(self, "tops", OrderedDict())

    def __setattr__(self, name: str, top: Top) -> None:
        self.tops[name] = top

    def __getattr__(self, name: str) -> Top:
        try:
            return self.tops[name]
        except KeyError:
            raise AttributeError(name)

    def to_proto(self) -> PbNode:
        # name every reachable Top; in-place layers keep their bottom's name
        names: Dict[Top, str] = {}
        calls: List[LayerCall] = []
        autonames: Dict[LayerCall, str] = {}
        seen = set()

        named_calls: Dict[int, str] = {}

        def visit_call(call: "LayerCall"):
            if id(call) in seen:
                return
            seen.add(id(call))
            for b in call.bottoms:
                visit_call(b.fn)
            calls.append(call)

        for name, top in self.tops.items():
            if isinstance(top, LayerCall):  # ntop=0 layer (e.g. Silence)
                visit_call(top)
                named_calls[id(top)] = name
                continue
            visit_call(top.fn)
            names[top] = name
            for sib in top.fn.tops:
                if sib is not top and sib not in names:
                    names[sib] = f"{name}_{sib.index}"
        # autoname tops never assigned to the NetSpec (the reference's
        # Counter-based autonames, python/caffe/net_spec.py) so intermediate
        # layers used only as bottoms still serialise
        counters: Dict[str, int] = {}
        for call in calls:
            for t in call.tops:
                if t not in names:
                    base = call.type_name.lower()
                    counters[base] = counters.get(base, 0) + 1
                    names[t] = f"{base}{counters[base]}"
        # resolve in-place chains: a Top assigned in-place aliases its bottom
        for call in calls:
            autonames[call] = named_calls.get(id(call)) or next(
                (nm for t, nm in names.items() if t in call.tops), call.type_name.lower())
            if call.in_place:
                src = call.bottoms[0]
                for t in call.tops:
                    names[t] = names[src]
        net = PbNode()
        for call in calls:
            net.add("layer", call.to_node(names, autonames))
        return net

    def to_proto_text(self) -> str:
        return dump(self.to_proto())

    def to_net(self, **kwargs):
        from deepcut_tpu_torch.core.graph import Net
        return Net(self.to_proto(), **kwargs)
