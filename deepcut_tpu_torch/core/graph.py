"""Graph engine: a parsed prototxt interpreted into a plan of layer functions.

Counterpart of `deepcut_tpu.core.graph`, the serving side. The prototxt is
interpreted ONCE into an execution plan (one function per layer, built by
`core.layers`), with the reference's phase / stage / level filtering
(net.cpp:286-380) and legacy V0 / V1 nets upgraded first. Shape inference
runs the plan once on the ``meta`` device, and the fillers materialise the
parameters from an explicit `torch.Generator`. Tensors are NCHW throughout,
Caffe's own axes; on the card the serving stream is channels_last in memory.

Two ways to run a net, as in the JAX package:

- `Net.forward` / `forward_all` (through `compat.Net`): the pycaffe
  contract, numpy NCHW in and EVERY blob out as f32 numpy;
- the serving chain ``fold_bn() -> prune(outputs) -> fuse_siblings() ->
  [quantize_int8(...)] -> cast_weights() -> make_forward(outputs)``, whose
  function keeps a bf16 stream from the inputs to the outputs (cast back
  to f32) and returns only the requested blobs. Each convolution,
  deconvolution and InnerProduct of the stream ends in the hand-written
  `ops.conv_epilogue` kernel; each int8 convolution of `quantize_int8` is
  `quantize_i8`, `int8_im2col` (or the int8 input itself), `torch._int_mm`
  and `int8_epilogue` (`ops.int8_conv`).

Backward, training steps and data layers belong to the engine's training
slice of the port and raise `NotImplementedError`.
"""

from __future__ import annotations

import copy
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deepcut_tpu_torch.core import fillers
from deepcut_tpu_torch.core import layers as L
from deepcut_tpu_torch.ops.norm import scaled_stats
from deepcut_tpu_torch.proto import text_format
from deepcut_tpu_torch.proto.text_format import PbNode

BF16 = torch.bfloat16
TRAINING_SLICE = ("belongs to the engine's training slice of the port (backward, training "
                  "steps, losses and data layers), which is not ported yet")
# the data layers of `deepcut_tpu.data.layers` (DATA_SOURCES) and the HDF5 sink
DATA_LAYER_TYPES = ("Data", "ImageData", "MemoryData", "HDF5Data", "WindowData", "PoseData",
                    "HDF5Output")

# V1 LayerType enum names -> V2 type strings (upgrade_proto.cpp UpgradeV1LayerType)
_V1_TYPE_NAMES = {
    "ABSVAL": "AbsVal", "ACCURACY": "Accuracy", "ARGMAX": "ArgMax",
    "BNLL": "BNLL", "CONCAT": "Concat", "CONTRASTIVE_LOSS": "ContrastiveLoss",
    "CONVOLUTION": "Convolution", "DECONVOLUTION": "Deconvolution",
    "DATA": "Data", "DROPOUT": "Dropout", "DUMMY_DATA": "DummyData",
    "EUCLIDEAN_LOSS": "EuclideanLoss", "ELTWISE": "Eltwise", "EXP": "Exp",
    "FLATTEN": "Flatten", "HDF5_DATA": "HDF5Data", "HDF5_OUTPUT": "HDF5Output",
    "HINGE_LOSS": "HingeLoss", "IM2COL": "Im2col", "IMAGE_DATA": "ImageData",
    "INFOGAIN_LOSS": "InfogainLoss", "INNER_PRODUCT": "InnerProduct",
    "LRN": "LRN", "MEMORY_DATA": "MemoryData",
    "MULTINOMIAL_LOGISTIC_LOSS": "MultinomialLogisticLoss", "MVN": "MVN",
    "POOLING": "Pooling", "POWER": "Power", "RELU": "ReLU",
    "SIGMOID": "Sigmoid", "SIGMOID_CROSS_ENTROPY_LOSS": "SigmoidCrossEntropyLoss",
    "SILENCE": "Silence", "SOFTMAX": "Softmax", "SOFTMAX_LOSS": "SoftmaxWithLoss",
    "SPLIT": "Split", "SLICE": "Slice", "TANH": "TanH",
    "WINDOW_DATA": "WindowData", "THRESHOLD": "Threshold",
}


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The entry points run on the card unless the caller asks for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available: pass device='cpu' to run on the CPU")
    return dev


class LayerSpec:
    """Static description of one layer: type, wiring, config node."""

    __slots__ = ("name", "type", "bottoms", "tops", "node", "param_specs")

    def __init__(self, node: PbNode):
        self.node = node
        self.name = node.get_str("name", "")
        self.type = _V1_TYPE_NAMES.get(node.get_str("type", ""), node.get_str("type", ""))
        self.bottoms = [str(b) for b in node.get_list("bottom")]
        self.tops = [str(t) for t in node.get_list("top")]
        # ParamSpec entries: the shared name (net.cpp:469-562)
        self.param_specs = [{"name": p.get_str("name", "")} for p in node.get_list("param")
                            if isinstance(p, PbNode)]

    def param(self, key: str) -> PbNode:
        return self.node.get(key, PbNode())


def _rule_matches(rule: PbNode, phase: str, stages: Sequence[str], level: int) -> bool:
    if rule.has("phase") and rule.get_str("phase") != phase:
        return False
    if rule.has("min_level") and level < rule.get_int("min_level"):
        return False
    if rule.has("max_level") and level > rule.get_int("max_level"):
        return False
    if any(st not in stages for st in rule.get_list("stage")):
        return False
    return not any(st in stages for st in rule.get_list("not_stage"))


def filter_layers(specs: List[LayerSpec], phase: str, stages: Sequence[str] = (),
                  level: int = 0) -> List[LayerSpec]:
    """NetStateRule filtering (reference: Net::FilterNet, net.cpp:286-314)."""
    out = []
    for spec in specs:
        includes = spec.node.get_list("include")
        keep = not includes  # no include rule -> in, unless excluded
        for rule in spec.node.get_list("exclude"):
            if _rule_matches(rule, phase, stages, level):
                keep = False
        for rule in includes:
            if _rule_matches(rule, phase, stages, level):
                keep = True
        if keep:
            out.append(spec)
    return out


def _slice_couts(y: torch.Tensor, couts: Sequence[int]) -> List[torch.Tensor]:
    """A fused sibling group's concatenated output split back per top, along
    the channel axis (the one definition, for fuse_siblings and
    quantize_int8)."""
    return list(torch.split(y, list(couts), dim=1))


def _cout_dim(layer_type: str) -> int:
    """Cout's dim of a weight: 0 of a conv's OIHW, 1 of a deconv's (Cin, Cout/g, kh, kw)."""
    return 1 if layer_type == "Deconvolution" else 0


def _to_tensor(v, device: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to(device)
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def _to_numpy(v: torch.Tensor) -> np.ndarray:
    v = v.detach().cpu()
    return (v.float() if v.dtype == BF16 else v).numpy()


class Net:
    """Prototxt-defined network on one device (pycaffe-like usage):

        net = Net("deploy.prototxt", weights="x.caffemodel")   # TEST phase, the card
        outs = net.forward(data=np_nchw_image)   # dict of every blob, NCHW numpy
        prob = net.blobs["prob"]                  # last forward's blobs

    compute_dtype: bf16 (the default, as the JAX package) rounds each
    convolution's and InnerProduct's operands to bf16 in `forward` and
    streams bf16 through `make_forward`; None computes in f32 (TF32 off).
    seed: the fillers' generator. device: "cuda" (the default) or "cpu".
    """

    def __init__(self, model_def: Union[str, PbNode],
                 weights: Union[str, Dict[str, Dict[str, Any]], None] = None,
                 phase: str = "TEST", *, stages: Sequence[str] = (), level: Optional[int] = None,
                 compute_dtype: Optional[torch.dtype] = BF16, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        from deepcut_tpu_torch.proto.upgrade import upgrade_net

        self.device = resolve_device(device)
        proto = text_format.parse_file(model_def) if isinstance(model_def, str) else model_def
        self.proto = upgrade_net(proto)
        self.name = self.proto.get_str("name", "")
        self.phase = phase
        self.compute_dtype = compute_dtype

        all_specs = [LayerSpec(n) for n in self.proto.get_list("layer")]
        if not all_specs:  # legacy "layers" field
            all_specs = [LayerSpec(n) for n in self.proto.get_list("layers")]
        own_state = self.proto.get("state")
        if own_state is not None:  # the net's own NetState under the caller's
            stages = tuple(stages) + tuple(
                str(s) for s in own_state.get_list("stage") if s not in stages)
            if level is None and own_state.has("level"):
                level = own_state.get_int("level")
        self.layer_specs = filter_layers(all_specs, phase, stages, 0 if level is None else level)

        # net-level inputs (deploy style): input / input_shape / input_dim, Input layers
        self.input_names: List[str] = [str(s) for s in self.proto.get_list("input")]
        self.input_shapes: Dict[str, Tuple[int, ...]] = {}
        dims = [int(d) for d in self.proto.get_list("input_dim")]
        shapes = self.proto.get_list("input_shape")
        for i, nm in enumerate(self.input_names):
            if shapes:
                self.input_shapes[nm] = tuple(int(d) for d in shapes[i].get_list("dim"))
            elif dims:
                self.input_shapes[nm] = tuple(dims[4 * i: 4 * i + 4])
        for spec in self.layer_specs:
            if spec.type == "Input":
                in_shapes = spec.param("input_param").get_list("shape")
                for i, top in enumerate(spec.tops):
                    self.input_names.append(top)
                    if in_shapes:
                        self.input_shapes[top] = tuple(
                            int(d) for d in in_shapes[min(i, len(in_shapes) - 1)].get_list("dim"))

        self._plan: List[Tuple[Callable, LayerSpec]] = []
        self._silenced: set = set()
        for spec in self.layer_specs:
            if spec.type == "Silence":  # consumes its bottoms, emits nothing
                self._silenced.update(spec.bottoms)
                continue
            if spec.type == "Input":
                continue
            if spec.type in DATA_LAYER_TYPES:
                raise L.not_ported(spec, "the engine's training slice (data layers)")
            self._plan.append((L.build(spec, phase, compute_dtype), spec))

        self.params: Dict[str, Dict[str, torch.Tensor]] = {}
        self._aliases: Dict[str, Dict[str, Tuple[str, str]]] = {}
        self._param_keys: Dict[str, List[str]] = {}
        self._generator = torch.Generator().manual_seed(int(seed))
        self._params_ready = False
        self._pending_weights: List[Any] = [] if weights is None else [weights]
        self._prepared: Optional[Tuple[Any, Any, Dict]] = None
        if self.input_shapes:
            self._ensure_params(dict(self.input_shapes))
        self.blobs: "OrderedDict[str, np.ndarray]" = OrderedDict()

    # -- weights ----------------------------------------------------------
    def layer_types(self) -> Dict[str, str]:
        return {s.name: s.type for s in self.layer_specs}

    def load_weights(self, weights) -> None:
        """Copy weights in by layer name over the current params, shapes
        checked (Net::CopyTrainedLayersFrom, net.cpp:805-846): a
        ``.caffemodel`` path (blobs in Caffe's order and layouts, which
        are the port's), or a ``{layer: {key: array}}`` dict in the port's
        layouts, whose entries replace the layers' entries."""
        if not self._params_ready:
            self._pending_weights.append(weights)
            return
        if isinstance(weights, str):
            from deepcut_tpu_torch.proto.caffemodel import load_caffemodel

            entries = {}
            for name, blobs in load_caffemodel(weights).items():
                if name not in self._param_keys:
                    continue
                keys = self._param_keys[name]
                if len(blobs) != len(keys):
                    raise ValueError(f"load_weights: layer '{name}' has {len(blobs)} blobs in "
                                     f"the file, the net {len(keys)} ({keys})")
                own = self.params[name]
                entries[name] = {k: b.data.reshape(own[k].shape) if (
                    k in own and b.data.size == own[k].numel()) else b.data
                    for k, b in zip(keys, blobs) if k in own}
        else:
            entries = weights
        for name, entry in entries.items():
            if name not in self.params:
                continue
            cur = self.params[name]
            new = {k: _to_tensor(v, self.device) for k, v in entry.items()}
            for k, v in new.items():
                if k in cur and tuple(v.shape) != tuple(cur[k].shape):
                    raise ValueError(
                        f"load_weights: layer '{name}' blob '{k}' shape {tuple(v.shape)} != "
                        f"net's {tuple(cur[k].shape)} (rename the layer to re-initialise it, "
                        "the reference finetune idiom)")
            self.params[name] = new

    def _ensure_params(self, input_shapes: Dict[str, Tuple[int, ...]]) -> None:
        """Materialise the parameters: the plan runs once on the meta device
        (shapes only), recording each layer's (key, shape, filler); the
        fillers then draw them in plan order, and pending weights are
        copied over by name (Layer::SetUp + the Filler calls, net.cpp:40-284)."""
        if self._params_ready:
            return
        self._params_ready = True
        collected: "OrderedDict[str, List]" = OrderedDict()
        blobs = {nm: torch.empty(sh, device="meta") for nm, sh in input_shapes.items()}
        with torch.no_grad():
            for fn, spec in self._plan:
                bottoms = [blobs[b] for b in spec.bottoms]
                pspec = L.param_spec(spec, [tuple(b.shape) for b in bottoms])
                if pspec:
                    collected[spec.name] = pspec
                entry = {k: torch.zeros(s, device="meta") for k, s, _ in pspec}
                outs = fn(entry, bottoms)
                for top, val in zip(spec.tops, outs if isinstance(outs, (list, tuple)) else [outs]):
                    blobs[top] = val

        # named-param sharing (Net::AppendParam): the first layer declaring
        # `param { name: "x" }` owns the array, later declarations alias it
        specs_by_name = {s.name: s for _, s in self._plan}
        owners: Dict[str, Tuple[str, str]] = {}
        for name, pspec in collected.items():
            decls = specs_by_name[name].param_specs
            entry = {}
            self._param_keys[name] = [k for k, _, _ in pspec]
            for i, (key, shape, filler) in enumerate(pspec):
                shared = decls[i]["name"] if i < len(decls) else ""
                if shared and shared in owners:
                    self._aliases.setdefault(name, {})[key] = owners[shared]
                    continue
                deconv = specs_by_name[name].type == "Deconvolution" and key == "w"
                entry[key] = fillers.fill(filler, self._generator, shape, deconv=deconv).to(self.device)
                if shared:
                    owners[shared] = (name, key)
            self.params[name] = entry
        pending, self._pending_weights = self._pending_weights, []
        for w in pending:
            self.load_weights(w)

    # -- serving transforms ------------------------------------------------
    def _shared_owners(self) -> set:
        return {ol for amap in self._aliases.values() for (ol, _k) in amap.values()}

    def fold_bn(self) -> int:
        """Fold inference BatchNorm (+ Scale) layers into the preceding
        Convolution / Deconvolution: conv -> in-place BatchNorm -> optional
        in-place Scale becomes y = conv(x, w*g) + ((b - mean)*g + beta),
        g = gamma * rsqrt(var/sf + eps), a scale factor of 0 giving 0
        (the JAX package's formula, graph.py:452-470). The BN / Scale
        entries are removed. Returns the number of folded BN layers."""
        if not self.params:
            raise RuntimeError("fold_bn: materialise params first (run forward "
                               "once or declare input shapes)")
        plan, new_plan, folded, i = self._plan, [], 0, 0
        shared_owners = self._shared_owners()
        while i < len(plan):
            fn, spec = plan[i]
            top = spec.tops[0] if spec.tops else None
            bn_spec = sc_spec = None
            if (spec.type in ("Convolution", "Deconvolution") and top is not None
                    and spec.name not in shared_owners and i + 1 < len(plan)):
                s2 = plan[i + 1][1]
                if (s2.type == "BatchNorm" and s2.bottoms == [top] and s2.tops == [top]
                        and self.params.get(s2.name) and "w" in self.params.get(spec.name, {})):
                    bn_spec = s2
                    if i + 2 < len(plan):
                        s3 = plan[i + 2][1]
                        if (s3.type == "Scale" and s3.bottoms == [top] and s3.tops == [top]
                                and "gamma" in self.params.get(s3.name, {})):
                            sc_spec = s3
            if bn_spec is None:
                new_plan.append((fn, spec))
                i += 1
                continue
            bn = self.params[bn_spec.name]
            eps = bn_spec.param("batch_norm_param").get_float("eps", 1e-5)
            mean, var = scaled_stats(bn["mean"], bn["var"], bn.get("scale_factor"))
            if sc_spec is not None:
                sc = self.params[sc_spec.name]
                gamma, beta = sc["gamma"], sc.get("beta", torch.zeros_like(sc["gamma"]))
            else:
                gamma, beta = 1.0, 0.0
            g = gamma * torch.rsqrt(var + eps)
            conv_p = self.params[spec.name]
            b0 = conv_p.get("b", torch.zeros_like(g))
            shape = [1, 1, 1, 1]
            shape[_cout_dim(spec.type)] = -1
            self.params[spec.name] = {"w": conv_p["w"] * g.reshape(shape),
                                      "b": (b0 - mean) * g + beta}
            del self.params[bn_spec.name]
            if sc_spec is not None:
                del self.params[sc_spec.name]
            new_plan.append((fn, spec))
            folded += 1
            i += 2 + (sc_spec is not None)
        self._plan = new_plan
        return folded

    def cast_weights(self, dtype: torch.dtype = BF16) -> None:
        """Pre-cast matrix / conv weights (ndim >= 2, floating) to `dtype`;
        1-D blobs (biases, statistics) stay f32. Serving transform."""
        if self.compute_dtype is None and dtype is not None and dtype != torch.float32:
            raise ValueError(
                "cast_weights: this net was built with compute_dtype=None (f32 layer math); "
                "construct the serving net with compute_dtype=torch.bfloat16 (the default) "
                "before casting weights")
        self.params = {name: {k: (v.to(dtype) if v.dim() >= 2 and v.is_floating_point() else v)
                              for k, v in entry.items()}
                       for name, entry in self.params.items()}

    def prune(self, outputs: Sequence[str]) -> int:
        """Serving transform: drop every layer that does not (transitively)
        feed one of `outputs`, and its params (but the owners of shared
        params a kept layer aliases). Returns the number of layers removed."""
        needed = set(outputs)
        missing = needed - {t for _, s in self._plan for t in s.tops} - set(self.input_shapes)
        if missing:
            raise KeyError(f"prune: unknown output blob(s) {sorted(missing)}")
        kept: List[Tuple[Callable, LayerSpec]] = []
        for fn, spec in reversed(self._plan):  # every producer of a needed blob
            if any(t in needed for t in spec.tops):
                needed.update(spec.bottoms)
                kept.append((fn, spec))
        removed = len(self._plan) - len(kept)
        kept.reverse()
        self._plan = kept
        kept_names = {spec.name for _, spec in kept}
        alias_owners = {owner for lname, amap in self._aliases.items() if lname in kept_names
                        for owner, _k in amap.values()}
        self.params = {n: e for n, e in self.params.items()
                       if n in kept_names or n in alias_owners}
        return removed

    def fuse_siblings(self) -> int:
        """Serving transform: merge sibling Convolution / Deconvolution
        layers (same single bottom, identical kernel / stride / pad /
        dilation, groups 1, own unshared weights) into ONE layer over
        concatenated output channels, sliced per original top afterwards.
        Returns the number of fused groups."""
        if not self.params:
            raise RuntimeError("fuse_siblings: materialise params first (run "
                               "forward once or declare input shapes)")
        plan = self._plan
        shared_owners, aliased = self._shared_owners(), set(self._aliases)
        groups: "OrderedDict[tuple, List[int]]" = OrderedDict()
        for i, (fn, spec) in enumerate(plan):
            if (spec.type not in ("Convolution", "Deconvolution") or len(spec.bottoms) != 1
                    or len(spec.tops) != 1 or spec.tops[0] == spec.bottoms[0]
                    or spec.name in shared_owners or spec.name in aliased
                    or "w" not in self.params.get(spec.name, {})):
                continue
            g = L.conv_geometry(spec.param("convolution_param"))
            if g["groups"] != 1:
                continue
            key = (spec.type, spec.bottoms[0], g["kernel"], g["stride"], g["pad"], g["dilation"])
            groups.setdefault(key, []).append(i)

        fused, drop, replace = 0, set(), {}
        for key, idxs in groups.items():
            if len(idxs) < 2:
                continue
            bottom, lo, hi = key[1], idxs[0], idxs[-1]
            # the fused layer reads the bottom at `lo`: illegal if a layer in
            # between rewrites it in place
            if any(bottom in plan[k][1].tops for k in range(lo + 1, hi) if k not in idxs):
                continue
            members = [plan[k] for k in idxs]
            dim = _cout_dim(key[0])
            ws = [self.params[s.name]["w"] for _, s in members]
            couts = [int(w.shape[dim]) for w in ws]
            entry = {"w": torch.cat(ws, dim=dim)}
            if any("b" in self.params[s.name] for _, s in members):
                entry["b"] = torch.cat([self.params[s.name].get(
                    "b", torch.zeros(c, device=self.device)) for (_, s), c in zip(members, couts)])
            base_fn = members[0][0]

            def make_fused(base_fn, couts):
                def ffn(p, bottoms):
                    return _slice_couts(base_fn(p, bottoms), couts)
                ffn.fused_couts = list(couts)
                return ffn

            fspec = copy.copy(members[0][1])
            fspec.tops = [s.tops[0] for _, s in members]
            self.params[members[0][1].name] = entry
            for _, s in members[1:]:
                self.params.pop(s.name, None)
            replace[lo] = (make_fused(base_fn, couts), fspec)
            drop.update(idxs[1:])
            fused += 1
        if fused:
            self._plan = [replace.get(i, item) for i, item in enumerate(plan) if i not in drop]
        return fused

    def quantize_int8(self, *, min_in_channels: int = 8, percentile: float = 100.0,
                      **calibration_inputs) -> int:
        """Post-training int8 quantization of the Convolution layers, as the
        JAX package's (graph.py:646-760): one pass over a calibration batch
        (NCHW numpy, like `forward`) records each eligible conv input's
        absmax (or a subsampled `percentile` of |x|, read in NHWC order) -> a
        static activation scale max(amax/127, 1e-8); weights get
        per-output-channel symmetric int8 (`models.quantize.act_scale`,
        `quantize_conv_weight`). Grouped and shared convs, convs whose
        stride, pad or dilation differ between H and W, and convs with
        fewer than `min_in_channels` input channels stay float; a
        rectangular kernel is quantized. Each int8
        conv computes ``q = clamp(round(x * (1/s)), +-127)``, the exact
        int32 accumulator, and ``acc * (s * w_scale) + b`` with one rounding,
        cast to the stream's dtype. Returns the number of quantized layers."""
        from deepcut_tpu_torch.models.quantize import act_scale, quantize_conv_weight
        from deepcut_tpu_torch.ops import int8_conv as ic

        inputs = {nm: _to_tensor(v, self.device) for nm, v in calibration_inputs.items()}
        self._ensure_params({nm: tuple(v.shape) for nm, v in inputs.items()})
        shared_owners = self._shared_owners()
        prepared = self._prepare(self.params)
        blobs, act_scales, geoms = dict(inputs), {}, {}
        with torch.inference_mode():
            for fn, spec in self._plan:
                bottoms = [blobs[b] for b in spec.bottoms]
                geom = (L.conv_geometry(spec.param("convolution_param"))
                        if spec.type == "Convolution" else None)
                if (geom is not None and spec.name not in shared_owners
                        and "w" in self.params.get(spec.name, {}) and geom["groups"] == 1
                        and bottoms[0].shape[1] >= min_in_channels
                        and geom["stride"][0] == geom["stride"][1]
                        and geom["pad"][0] == geom["pad"][1]
                        and geom["dilation"][0] == geom["dilation"][1]):
                    act_scales[spec.name] = act_scale(bottoms[0], percentile)
                    geoms[spec.name] = geom
                outs = fn(self._entry(prepared, spec.name), bottoms)
                for top, val in zip(spec.tops, outs if isinstance(outs, (list, tuple)) else [outs]):
                    blobs[top] = val

        new_plan = []
        for fn, spec in self._plan:
            if spec.name not in act_scales:
                new_plan.append((fn, spec))
                continue
            p = self.params[spec.name]
            w_q, s_w = quantize_conv_weight(p["w"])
            self.params[spec.name] = {
                "w_q": w_q, "w_scale": s_w,
                "b": p["b"].float() if "b" in p else torch.zeros_like(s_w),
                "act_scale": act_scales[spec.name].to(self.device),
            }
            g, couts = geoms[spec.name], getattr(fn, "fused_couts", None)

            def qfn(p, bottoms, g=g, couts=couts):
                x = bottoms[0]
                xf = x.float()
                if xf.is_cuda:
                    xf = xf.contiguous(memory_format=torch.channels_last)
                xq = ic.quantize_i8(xf, p["s_x"])
                acc = ic.conv_i8(xq, p["packed"], p["w_q"].shape[0], g["kernel"],
                                 stride=g["stride"][0], pad=g["pad"][0],
                                 dilation=g["dilation"][0])
                y, _ = ic.int8_epilogue(acc, p["scale"], p["b"], bf16=x.dtype == BF16)
                y = y.to(x.dtype)
                return y if couts is None else _slice_couts(y, couts)
            qfn.quantized = True
            new_plan.append((qfn, spec))
        self._plan = new_plan
        return len(act_scales)

    # -- execution --------------------------------------------------------
    def _prepare(self, params) -> Dict[str, Dict[str, torch.Tensor]]:
        """The params as the layer functions take them, built once per set of
        tensors: the operand weights of Convolution / Deconvolution /
        InnerProduct as f32 holding bf16 values when the net computes in
        bf16 (f32 otherwise), channels_last on the card; for an int8 conv
        its packed (Cout, K) weight, its dequantization scale
        ``act_scale * w_scale`` (f32) and its act_scale as a Python float."""
        from deepcut_tpu_torch.ops.int8_conv import pack_conv_weight

        leaves = [v for e in params.values() for v in e.values()]
        # a tensor's version counter moves with each in-place edit (net
        # surgery on `params`), which keeps its id; an inference tensor
        # keeps none and can be edited only inside inference mode
        key = tuple((n, k, id(v), -1 if v.is_inference() else v._version)
                    for n, e in params.items() for k, v in e.items())
        if self._prepared is not None and self._prepared[0] == key:
            return self._prepared[2]
        types = self.layer_types()
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, entry in params.items():
            e = dict(entry)
            w = entry.get("w")
            if (w is not None and w.is_floating_point()
                    and types.get(name) in ("Convolution", "Deconvolution", "InnerProduct")):
                rounded = self.compute_dtype is not None or w.dtype == BF16
                w = w.to(BF16).float() if rounded else w.float()
                if w.dim() == 4 and w.is_cuda:
                    w = w.contiguous(memory_format=torch.channels_last)
                e["w"] = w
            if "w_q" in entry:
                e["packed"] = pack_conv_weight(entry["w_q"])
                e["scale"] = (entry["act_scale"] * entry["w_scale"]).float().contiguous()
                e["s_x"] = float(entry["act_scale"])
            out[name] = e
        self._prepared = (key, leaves, out)  # holds the tensors: their ids stay theirs
        return out

    def _entry(self, params, name: str):
        """Layer's param entry with shared-name aliases resolved."""
        entry = params.get(name)
        aliases = self._aliases.get(name)
        if not aliases:
            return entry
        merged = dict(entry or {})
        for key, (ol, ok) in aliases.items():
            merged[key] = params[ol][ok]
        return merged

    def _execute(self, params, inputs: Dict[str, torch.Tensor], *,
                 plan: Optional[List[Tuple[Callable, LayerSpec]]] = None,
                 dynamic: bool = False) -> Dict[str, torch.Tensor]:
        """Run the plan (or a slice of it) over a blobs dict, on prepared
        params. dynamic: layers with a `host_dynamic` variant (Filter) run
        it, with true dynamic output shapes."""
        blobs: Dict[str, torch.Tensor] = dict(inputs)
        for fn, spec in (self._plan if plan is None else plan):
            bottoms = [blobs[b] for b in spec.bottoms]
            entry = self._entry(params, spec.name)
            if dynamic and getattr(fn, "host_dynamic", None) is not None:
                outs = fn.host_dynamic(entry, bottoms)
            else:
                outs = fn(entry, bottoms)
            for top, val in zip(spec.tops, outs if isinstance(outs, (list, tuple)) else [outs]):
                blobs[top] = val
        return blobs

    def make_forward(self, outputs: Optional[Sequence[str]] = None):
        """The serving forward: ``fwd(params, {name: NCHW tensor}) ->
        {output: f32 NCHW tensor}`` for `outputs` (default: the net's
        terminal blobs). Floating 4-D inputs are cast to ``compute_dtype``
        at the boundary, so the whole stream rides bf16 (channels_last on
        the card), as the JAX package's make_forward; the outputs are cast
        back to f32. The weights are prepared once per set of param tensors.

        Typical serving setup:
            net = Net(prototxt, weights=...)   # TEST phase
            net.fold_bn(); net.prune(["prob"]); net.fuse_siblings()
            net.cast_weights()
            fwd = net.make_forward(["prob"])
        """
        outs = list(outputs) if outputs else self.output_names()

        def fwd(params, inputs):
            prepared = self._prepare(params)
            with torch.inference_mode():
                blobs = self._execute(prepared, self.stage_inputs(inputs))
                return {k: blobs[k].float() if blobs[k].is_floating_point() else blobs[k]
                        for k in outs}
        return fwd

    def stage_inputs(self, inputs) -> Dict[str, torch.Tensor]:
        """Inputs as `make_forward` takes them into its stream: on the net's
        device, floating 4-D ones in ``compute_dtype``, channels_last on
        the card."""
        staged = {}
        for k, v in inputs.items():
            v = _to_tensor(v, self.device)
            if self.compute_dtype is not None and v.dim() == 4 and v.is_floating_point():
                v = v.to(self.compute_dtype)
            if v.is_cuda and v.dim() == 4:
                v = v.contiguous(memory_format=torch.channels_last)
            staged[k] = v
        return staged

    def plan_slice(self, start: Optional[str], end: Optional[str]):
        """Plan segment from layer `start` through layer `end` inclusive
        (Net::ForwardFromTo semantics, net.cpp:564-581)."""
        names = [spec.name for _, spec in self._plan]
        i0 = names.index(start) if start is not None else 0
        i1 = names.index(end) + 1 if end is not None else len(names)
        if i1 <= i0:
            raise ValueError(f"end layer {end!r} precedes start layer {start!r}")
        return self._plan[i0:i1]

    def forward(self, start: Optional[str] = None, end: Optional[str] = None,
                **inputs) -> Dict[str, np.ndarray]:
        """Run the net: NCHW numpy in, every blob out as NCHW numpy (the
        pycaffe contract). start / end: partial execution by layer name
        (pycaffe.py:62-107); bottoms the slice needs but that are not passed
        are seeded from the previous forward's blobs."""
        plan = None
        if start is not None or end is not None:
            plan = self.plan_slice(start, end)
            produced = set(inputs)
            for _, spec in plan:
                for b in spec.bottoms:
                    if b not in produced and b in self.blobs:
                        inputs.setdefault(b, self.blobs[b])
                produced.update(spec.tops)
        dev_inputs = {nm: _to_tensor(arr, self.device) for nm, arr in inputs.items()}
        self._ensure_params({nm: tuple(v.shape) for nm, v in dev_inputs.items()})
        with torch.inference_mode():
            out = self._execute(self._prepare(self.params), dev_inputs, plan=plan, dynamic=True)
            result: "OrderedDict[str, np.ndarray]" = OrderedDict(
                (nm, _to_numpy(v)) for nm, v in out.items())
        if plan is None:
            self.blobs = result
        else:  # partial run: merge, keeping untouched blobs for later slices
            self.blobs.update(result)
        return result

    def debug_info(self, **inputs) -> Dict[str, float]:
        """Per-blob mean |activation| after a forward, and each param's as
        'param:<layer>/<key>' (Net::ForwardDebugInfo, net.cpp:647-735)."""
        outs = self.forward(**inputs)
        info = {nm: float(np.mean(np.abs(np.asarray(v, np.float32)))) for nm, v in outs.items()}
        for lname, entry in self.params.items():
            for k, v in entry.items():
                info[f"param:{lname}/{k}"] = float(v.detach().float().abs().mean())
        return info

    def deconv_names(self) -> List[str]:
        """Deconvolution layer names (their weights are (Cin, Cout/g, kh, kw))."""
        return [s.name for _, s in self._plan if s.type == "Deconvolution"]

    def output_names(self) -> List[str]:
        """Blobs produced and not consumed by a later layer (net.cpp:267-274;
        a net ending in an in-place layer reports that blob); blobs a
        Silence layer consumes are not outputs."""
        available: List[str] = []
        for _, spec in self._plan:
            for b in spec.bottoms:
                if b in available:
                    available.remove(b)
            for t in spec.tops:
                if t not in available:
                    available.append(t)
        return [a for a in available if a not in self._silenced]

    # -- the training slice -------------------------------------------------
    def make_train_step(self, *args, **kwargs):
        raise NotImplementedError(f"Net.make_train_step {TRAINING_SLICE}")

    def backward(self, *args, **kwargs):
        raise NotImplementedError(f"Net.backward {TRAINING_SLICE}")

    def total_loss(self, *args, **kwargs):
        raise NotImplementedError(f"Net.total_loss {TRAINING_SLICE}")

    def set_input_arrays(self, *args, **kwargs):
        raise NotImplementedError(f"Net.set_input_arrays {TRAINING_SLICE}")
