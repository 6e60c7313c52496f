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

While a torch profiler records, each plan step of a run records a
``graph.<layer>`` span and each `make_forward` call a ``graph.forward``
span around them (`deepcut_tpu_torch.spans`).

Training, as the JAX package's (`deepcut_tpu.core.graph`, graph.py:906-1190):
`total_loss`, `make_train_step` (forward, autograd backward, the Caffe
update rule of `solver.update_rules` with per-blob lr / decay mults,
iter_size accumulation, BatchNorm's moving averages written over the
update, named params whose gradients sum into the owner, propagate_down)
and `backward` (input and intermediate diffs, injected top diffs, partial
start / end). The f32 training stream (``compute_dtype=None``) runs with
TF32 off for cuDNN and matmuls during the step, whatever the caller's
flags. Dropout, STOCHASTIC pooling and random DummyData tops draw from a
`torch.Generator` seeded by (the net's seed, the iteration, the layer's
index), so a step's draws are fixed by the seed and the iteration and
survive a snapshot and restore; they are not the JAX package's draws.

Data layers (`data.layers.DATA_SOURCES`: Data on LMDB or LevelDB,
ImageData, HDF5Data, WindowData, PoseData, MemoryData) become host-side
batch producers that a forward or a train step pulls from for the tops it
is not handed; all but MemoryData (fed by `set_input_arrays`) run behind a
3-deep prefetch thread, stopped by `Net.close`. Their numpy batches move to
the net's device. HDF5Output layers become sinks that collect their
bottoms after each forward (`hdf5_sinks`, written by ``sink.save()``).
"""

from __future__ import annotations

import contextlib
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
from deepcut_tpu_torch.spans import GRAPH_FORWARD, layer_span, span

BF16 = torch.bfloat16

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

    __slots__ = ("name", "type", "bottoms", "tops", "node", "param_specs", "span")

    def __init__(self, node: PbNode):
        self.node = node
        self.name = node.get_str("name", "")
        self.span = layer_span(self.name)  # the profiler span of its plan step
        self.type = _V1_TYPE_NAMES.get(node.get_str("type", ""), node.get_str("type", ""))
        self.bottoms = [str(b) for b in node.get_list("bottom")]
        self.tops = [str(t) for t in node.get_list("top")]
        # ParamSpec entries: the shared name, lr_mult and decay_mult (net.cpp:469-562)
        self.param_specs = [{"name": p.get_str("name", ""), "lr_mult": p.get_float("lr_mult", 1.0),
                             "decay_mult": p.get_float("decay_mult", 1.0)}
                            for p in node.get_list("param") if isinstance(p, PbNode)]

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


def _call(fn, entry, bottoms, gen=None, device=None):
    """One layer function, handed the generator and device it asks for
    (`core.layers`: ``needs_rng``, ``device_source``)."""
    kw = {}
    if getattr(fn, "needs_rng", False):
        kw["gen"] = gen
    if getattr(fn, "device_source", False):
        kw["device"] = device
    return fn(entry, bottoms, **kw)


@contextlib.contextmanager
def _tf32_off(on: bool = True):
    """TF32 off for cuDNN and matmuls inside (f32 training and its
    backward run in full f32, as the reference), the caller's flags back
    after."""
    if not on:
        yield
        return
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, mm.allow_tf32
    cudnn.allow_tf32 = mm.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = saved


def _is_loss(spec) -> bool:
    return spec.type.endswith("Loss") or spec.type == "SoftmaxWithLossVec"


class Net:
    """Prototxt-defined network on one device (pycaffe-like usage):

        net = Net("deploy.prototxt", weights="x.caffemodel")   # TEST phase, the card
        outs = net.forward(data=np_nchw_image)   # dict of every blob, NCHW numpy
        prob = net.blobs["prob"]                  # last forward's blobs

    compute_dtype: bf16 (the default, as the JAX package) rounds each
    convolution's and InnerProduct's operands to bf16 in `forward` and
    streams bf16 through `make_forward`; None computes in f32 (TF32 off).
    seed: the fillers' generator, and the seed of the stochastic layers'
    draws. device: "cuda" (the default) or "cpu".
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

        from deepcut_tpu_torch.data.layers import (
            DATA_SOURCES, PREFETCHED_TYPES, HDF5OutputSink, PrefetchedSource)

        self._plan: List[Tuple[Callable, LayerSpec]] = []
        self._silenced: set = set()
        self.data_sources: Dict[str, Any] = {}
        self.hdf5_sinks: List[HDF5OutputSink] = []
        self._peeked: Dict[str, List[np.ndarray]] = {}
        for spec in self.layer_specs:
            if spec.type == "Silence":  # consumes its bottoms, emits nothing
                self._silenced.update(spec.bottoms)
                continue
            if spec.type == "Input":
                continue
            if spec.type in DATA_SOURCES:
                src = DATA_SOURCES[spec.type](spec, phase)
                if spec.type in PREFETCHED_TYPES:
                    src = PrefetchedSource(src)
                self.data_sources[spec.name] = src
                continue
            if spec.type == "HDF5Output":
                self.hdf5_sinks.append(HDF5OutputSink(spec))
                continue
            self._plan.append((L.build(spec, phase, compute_dtype), spec))

        self.params: Dict[str, Dict[str, torch.Tensor]] = {}
        self._aliases: Dict[str, Dict[str, Tuple[str, str]]] = {}
        self._param_keys: Dict[str, List[str]] = {}
        self._lr_mults: Dict[str, Dict[str, float]] = {}
        self._decay_mults: Dict[str, Dict[str, float]] = {}
        self.seed = int(seed)
        self._generator = torch.Generator().manual_seed(self.seed)
        # stochastic layers draw anew each forward (and each train step)
        self._needs_rng = any(getattr(fn, "needs_rng", False) for fn, _ in self._plan)
        self._forward_calls = 0
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
        _, collected = self._meta_pass(input_shapes)

        # named-param sharing (Net::AppendParam): the first layer declaring
        # `param { name: "x" }` owns the array, later declarations alias it
        specs_by_name = {s.name: s for _, s in self._plan}
        owners: Dict[str, Tuple[str, str]] = {}
        for name, pspec in collected.items():
            decls = specs_by_name[name].param_specs
            entry = {}
            self._param_keys[name] = [k for k, _, _ in pspec]
            for i, (key, shape, filler) in enumerate(pspec):
                decl = decls[i] if i < len(decls) else {}
                shared = decl.get("name", "")
                # BatchNorm's statistics move only by the moving average:
                # lr_mult and decay_mult 0 whatever the prototxt says
                # (batch_norm_layer.cpp:29-37)
                bn = specs_by_name[name].type == "BatchNorm"
                self._lr_mults.setdefault(name, {})[key] = 0.0 if bn else decl.get("lr_mult", 1.0)
                self._decay_mults.setdefault(name, {})[key] = (
                    0.0 if bn else decl.get("decay_mult", 1.0))
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

    def _meta_pass(self, input_shapes: Dict[str, Tuple[int, ...]]):
        """The plan over meta tensors (shapes only): -> ({blob: meta tensor},
        {layer: its param spec [(key, shape, filler)]})."""
        collected: "OrderedDict[str, List]" = OrderedDict()
        blobs = {nm: torch.empty(sh, device="meta") for nm, sh in input_shapes.items()}
        with torch.no_grad():
            for fn, spec in self._plan:
                bottoms = [blobs[b] for b in spec.bottoms]
                pspec = L.param_spec(spec, [tuple(b.shape) for b in bottoms])
                if pspec:
                    collected[spec.name] = pspec
                entry = {k: torch.zeros(s, device="meta") for k, s, _ in pspec}
                outs = _call(fn, entry, bottoms, device="meta")
                for top, val in zip(spec.tops, outs if isinstance(outs, (list, tuple)) else [outs]):
                    blobs[top] = val
        return blobs, collected

    def blob_shapes(self, input_shapes: Optional[Dict[str, Tuple[int, ...]]] = None
                    ) -> Dict[str, Tuple[int, ...]]:
        """Every blob's NCHW shape without running the net (Net::Init's
        Reshape pass): the declared inputs, overridden by `input_shapes`;
        the data layers' tops as declared, else from a batch pulled and
        kept for the next pull. Materialises the params."""
        shapes = dict(self.input_shapes)
        shapes.update(input_shapes or {})
        for name, src in self.data_sources.items():
            declared = src.top_shapes()
            if declared is None:
                if name not in self._peeked:
                    self._peeked[name] = src.next_batch()
                declared = [np.shape(a) for a in self._peeked[name]]
            for top, sh in zip(src.tops, declared):
                shapes.setdefault(top, tuple(int(d) for d in sh))
        self._ensure_params(shapes)
        blobs, _ = self._meta_pass(shapes)
        return {nm: tuple(v.shape) for nm, v in blobs.items()}

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

    def _draws(self, *stream: int) -> torch.Generator:
        """A generator on the net's device seeded by (the net's seed,
        *stream): the stochastic layers' draws of one step or forward."""
        seq = np.random.SeedSequence([self.seed & 0xFFFFFFFF] + [int(v) for v in stream])
        return torch.Generator(device=self.device).manual_seed(
            int(seq.generate_state(1, np.uint64)[0]) >> 1)

    def _execute(self, params, inputs: Dict[str, torch.Tensor], *,
                 plan: Optional[List[Tuple[Callable, LayerSpec]]] = None,
                 dynamic: bool = False,
                 collect_updates: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                 rng: Optional[Tuple[int, ...]] = None,
                 taps: Optional[Dict[str, torch.Tensor]] = None,
                 rng_offset: int = 0) -> Dict[str, torch.Tensor]:
        """Run the plan (or a slice of it) over a blobs dict, on prepared
        params.

        dynamic: layers with a `host_dynamic` variant (Filter) run it, with
        true dynamic output shapes. collect_updates: filled with BatchNorm's
        new moving averages ({layer: {mean, var, scale_factor}}) where it
        normalises with batch statistics. rng: the stream of this step or
        forward; a stochastic layer draws from ``_draws(*rng, index)``
        (index in the whole plan: a slice starts at rng_offset), and runs
        deterministically without one. taps: {blob: zeros} added to the
        blob where it is first produced, so that the gradient with respect
        to a tap is the blob's diff (as Caffe's in-place chains hold it).
        A bottom with ``propagate_down: false`` passes no gradient."""
        from deepcut_tpu_torch.ops.norm import BNStats, batch_norm_train

        blobs: Dict[str, torch.Tensor] = dict(inputs)
        tapped: set = set()
        for idx, (fn, spec) in enumerate(self._plan if plan is None else plan):
            bottoms = [blobs[b] for b in spec.bottoms]
            pdown = [v if isinstance(v, bool) else bool(v) if isinstance(v, (int, float))
                     else str(v).lower() == "true" for v in spec.node.get_list("propagate_down")]
            if pdown and not all(pdown):
                bottoms = [b.detach() if i < len(pdown) and not pdown[i] else b
                           for i, b in enumerate(bottoms)]
            entry = self._entry(params, spec.name)
            with span(spec.span):
                if dynamic and getattr(fn, "host_dynamic", None) is not None:
                    outs = fn.host_dynamic(entry, bottoms)
                elif getattr(fn, "bn_train", False):
                    y, new = batch_norm_train(
                        bottoms[0], BNStats(entry["mean"], entry["var"],
                                            entry["scale_factor"].reshape(())),
                        eps=fn.bn_eps, momentum=fn.bn_momentum)
                    if collect_updates is not None:
                        collect_updates[spec.name] = {"mean": new.mean, "var": new.var,
                                                      "scale_factor": new.scale_factor.reshape(1)}
                    outs = y
                else:
                    gen = (self._draws(*rng, idx + rng_offset)
                           if rng is not None and getattr(fn, "needs_rng", False) else None)
                    outs = _call(fn, entry, bottoms, gen, self.device)
            sticky = getattr(fn, "sticky_tops", ())
            for i_top, (top, val) in enumerate(
                    zip(spec.tops, outs if isinstance(outs, (list, tuple)) else [outs])):
                if i_top in sticky and top in inputs:
                    continue  # a fill-once top handed in as an input keeps its value
                if taps is not None and top in taps and top not in tapped:
                    val = val + taps[top].to(val.dtype)
                    tapped.add(top)
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
            with span(GRAPH_FORWARD):
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
        pycaffe contract). Data-layer tops not passed are pulled from their
        sources, so a bare ``forward()`` advances them. start / end: partial
        execution by layer name (pycaffe.py:62-107); bottoms the slice needs
        but that are not passed are seeded from the previous forward's
        blobs. A TRAIN net's stochastic layers draw anew on each call."""
        plan, offset = None, 0
        if start is not None or end is not None:
            plan = self.plan_slice(start, end)
            if start is not None:
                offset = [s.name for _, s in self._plan].index(start)
            produced = set(inputs)
            for _, spec in plan:
                for b in spec.bottoms:
                    if b not in produced and b in self.blobs:
                        inputs.setdefault(b, self.blobs[b])
                produced.update(spec.tops)
        if start is None:
            self._pull_data_layers(inputs)
        dev_inputs = {nm: _to_tensor(arr, self.device) for nm, arr in inputs.items()}
        self._ensure_params({nm: tuple(v.shape) for nm, v in dev_inputs.items()})
        rng = None
        if self._needs_rng:
            rng = (1, self._forward_calls)
            self._forward_calls += 1
        with torch.inference_mode():
            out = self._execute(self._prepare(self.params), dev_inputs, plan=plan, dynamic=True,
                                rng=rng, rng_offset=offset)
            result: "OrderedDict[str, np.ndarray]" = OrderedDict(
                (nm, _to_numpy(v)) for nm, v in out.items())
        if plan is None:
            self.blobs = result
        else:  # partial run: merge, keeping untouched blobs for later slices
            self.blobs.update(result)
        for sink in self.hdf5_sinks:
            sink.append([result[b] for b in sink.bottoms if b in result])
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

    def sticky_top_names(self) -> set:
        """Tops filled once (constant DummyData): a value handed in as an
        input persists instead of the layer's refill."""
        return {spec.tops[i] for fn, spec in self._plan
                for i in getattr(fn, "sticky_tops", ()) if i < len(spec.tops)}

    # -- training ----------------------------------------------------------
    def blob_loss_weights(self) -> Dict[str, float]:
        """Each top's loss weight (Net::blob_loss_weights): the prototxt's
        ``loss_weight``, else 1 for top 0 of a loss layer and 0 elsewhere
        (LossLayer adds a single weight; extra tops such as a shared prob
        carry 0, layer.hpp:414-428)."""
        out: Dict[str, float] = {}
        for _, spec in self._plan:
            weights = [float(v) for v in spec.node.get_list("loss_weight")]
            for i, top in enumerate(spec.tops):
                out[top] = weights[i] if i < len(weights) else (
                    1.0 if _is_loss(spec) and i == 0 else 0.0)
        return out

    def total_loss(self, blobs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The weighted sum of the loss tops (f32), in plan order."""
        total = None
        for top, w in self.blob_loss_weights().items():
            if w:
                term = blobs[top].float().sum() * w
                total = term if total is None else total + term
        if total is None:
            raise ValueError("net has no loss layers")
        return total

    def host_total_loss(self, blobs: Dict[str, np.ndarray]) -> float:
        """`total_loss` over a forward's host blobs: the iteration loss a
        reference Net::Forward(&loss) hands the solver."""
        total = 0.0
        for top, w in self.blob_loss_weights().items():
            if w and top in blobs:
                total += w * float(np.sum(np.asarray(blobs[top], np.float32)))
        return total

    def _grad_params(self, params, requires_grad: bool = True):
        """The params as leaves (sharing the tensors' memory) that require
        grad, and the tree the layers take: convolution and InnerProduct
        weights rounded to bf16 values, differentiably, when the net
        computes in bf16."""
        leaves = {n: {k: v.detach().requires_grad_(requires_grad and v.is_floating_point())
                      for k, v in e.items()} for n, e in params.items()}
        if self.compute_dtype is None:
            return leaves, leaves
        types = self.layer_types()
        rounded = {n: {k: (v.to(BF16).float() if k == "w" and types.get(n) in (
            "Convolution", "Deconvolution", "InnerProduct") else v) for k, v in e.items()}
            for n, e in leaves.items()}
        return leaves, rounded

    def make_train_step(self, solver_cfg, *, lr_mults: bool = True, mesh=None, log=None):
        """``step(params, state, inputs) -> (params, state, loss)``: forward,
        backward and the Caffe update rule over this graph, IN PLACE on
        `params` and `state` (`solver.update_rules.step`), returned.

        inputs: {name: NCHW tensor or array}; with ``iter_size`` k > 1 each
        carries a leading axis of k micro-batches, whose gradients are summed
        (the rule divides by k) and whose losses are averaged (Solver::Step,
        solver.cpp:218-226). lr_mults: apply the prototxt's per-blob
        lr_mult / decay_mult (BatchNorm's statistics 0 / 0). BatchNorm's new
        moving averages (of the last micro-batch, as the reference's
        per-forward update) are written over what the rule did to them. A
        step's stochastic draws come from (the net's seed, the iteration,
        the micro-batch, the layer). The loss is a 0-dim f32 tensor.

        mesh: a `parallel.mesh.Mesh`. Every rank passes the GLOBAL inputs
        (batch dim behind the iter_size axis) and holds the same params; it
        keeps its rows, runs them under global-batch semantics
        (`parallel.mesh.data_parallel`: the losses' normalisers,
        BatchNorm's moments and moving averages, the stochastic draws) and
        sums the gradients over the ranks in flat buckets before the
        update, so every rank takes the single-device step on the global
        batch and returns the global loss (the JAX package's jit over a
        'data' mesh). A mesh with a 'spatial' axis also shards the image
        rows up to the plan's gather boundary
        (`parallel.graph_spatial.make_graph_spatial_train_step`, which
        reports the split through `log`)."""
        from deepcut_tpu_torch.parallel.mesh import all_reduce_sum, data_parallel, shard_batch
        from deepcut_tpu_torch.solver import update_rules

        def mults(table):
            return {name: {k: table.get(name, {}).get(k, 1.0) for k in entry}
                    for name, entry in self.params.items()} if lr_mults and table else None
        lrm, dcm = mults(self._lr_mults), mults(self._decay_mults)
        iter_size = max(int(getattr(solver_cfg, "iter_size", 1)), 1)
        if mesh is not None and mesh.spatial > 1:
            from deepcut_tpu_torch.parallel.graph_spatial import make_graph_spatial_train_step

            return make_graph_spatial_train_step(self, solver_cfg, mesh, lr_mults=lrm,
                                                 decay_mults=dcm, iter_size=iter_size, log=log)

        def one_grad(params, inputs, stream):
            leaves, used = self._grad_params(params)
            updates: Dict[str, Dict[str, torch.Tensor]] = {}
            with _tf32_off(self.compute_dtype is None), data_parallel(mesh):
                loss = self.total_loss(self._execute(used, inputs, collect_updates=updates,
                                                     rng=stream))
                flat = [v for e in leaves.values() for v in e.values() if v.requires_grad]
                got = iter(torch.autograd.grad(loss, flat, allow_unused=True)
                           if flat and loss.requires_grad else [None] * len(flat))
            grads = {n: {k: (next(got) if v.requires_grad else None) for k, v in e.items()}
                     for n, e in leaves.items()}
            grads = {n: {k: torch.zeros_like(params[n][k]) if g is None else g
                         for k, g in e.items()} for n, e in grads.items()}
            return loss.detach(), grads, updates

        def step(params, state, inputs):
            it = int(state["iter"])
            if mesh is not None:
                inputs = shard_batch(mesh, inputs, axis=0 if iter_size == 1 else 1)
            inputs = {k: _to_tensor(v, self.device) for k, v in inputs.items()}
            if iter_size == 1:
                loss, grads, updates = one_grad(params, inputs, (0, it, 0))
            else:
                loss, grads = None, None
                for m in range(iter_size):
                    l_m, g_m, updates = one_grad(params, {k: v[m] for k, v in inputs.items()},
                                                 (0, it, m))
                    loss = l_m if loss is None else loss + l_m
                    if grads is None:
                        grads = g_m
                    else:
                        for n, e in grads.items():
                            for k in e:
                                e[k] = e[k] + g_m[n][k]
                loss = loss / iter_size
            if mesh is not None:
                all_reduce_sum(mesh, [g for e in grads.values() for g in e.values()])
            update_rules.step(solver_cfg, params, grads, state, lr_mults=lrm, decay_mults=dcm)
            with torch.no_grad():
                for name, upd in updates.items():
                    for k, v in upd.items():
                        params[name][k].copy_(v)
            return params, state, loss
        return step

    def backward(self, diffs: Optional[Sequence[str]] = None,
                 cotangents: Optional[Dict[str, Any]] = None,
                 start: Optional[str] = None, end: Optional[str] = None,
                 **inputs) -> Dict[str, np.ndarray]:
        """Gradients of the total loss with respect to the net's floating
        inputs, as NCHW numpy (pycaffe's net.backward; parameter gradients
        come from `make_train_step`).

        diffs: more blobs whose diffs to return, as the reference hands back
        any blob's diff_: a zero tap is added where each is first produced
        and differentiated with the inputs. A requested diff of a
        non-floating input is zeros, as that blob's diff_ buffer.
        cotangents: injected top diffs {blob: NCHW array}; they replace the
        loss as the objective, which becomes sum <blob, cotangent>
        (pycaffe.py _Net_backward's kwargs).
        start / end: partial backward by layer name (Net::BackwardFromTo,
        net.cpp:634-645), from layer `start` (default: the last) down to
        `end` inclusive (default: the first); bottoms the slice does not
        produce are seeded from the previous forward's blobs, and a `start`
        needs the seeds of its tops in `cotangents`. Stochastic layers run
        deterministically (Dropout the identity), as the JAX package's."""
        plan, offset = None, 0
        if start is not None or end is not None:
            plan = self.plan_slice(end, start)
            if end is not None:
                offset = [spec.name for _, spec in self._plan].index(end)
            if start is not None and cotangents is None:
                raise ValueError(
                    f"backward(start={start!r}) needs seed diffs for the start layer's tops: "
                    "pass cotangents={top: d_objective/d_top} (the reference reads the tops' "
                    "diff_ buffers; stage them via compat Blob.diff)")
            produced = set(inputs)
            for _, spec in plan:
                for b in spec.bottoms:
                    if b not in produced and b in self.blobs:
                        inputs.setdefault(b, self.blobs[b])
                produced.update(spec.tops)
        if end is None:
            self._pull_data_layers(inputs)
        dev = {nm: _to_tensor(arr, self.device) for nm, arr in inputs.items()}
        self._ensure_params({nm: tuple(v.shape) for nm, v in dev.items()})
        diffable = {nm: v.requires_grad_() for nm, v in dev.items() if v.is_floating_point()}
        taps = {}
        tap_names = [d for d in (diffs or []) if d not in dev]
        if tap_names:
            with torch.no_grad():
                shapes = self._execute(self.params, dev, plan=plan, rng_offset=offset)
            missing = [nm for nm in tap_names if nm not in shapes]
            if missing:
                raise KeyError(f"backward(diffs=...): unknown blobs {missing}")
            taps = {nm: torch.zeros(shapes[nm].shape, dtype=shapes[nm].dtype,
                                    device=self.device, requires_grad=True) for nm in tap_names}
        with _tf32_off(self.compute_dtype is None):
            _, used = self._grad_params(self.params, requires_grad=False)
            blobs = self._execute(used, dev, taps=taps or None, plan=plan, rng_offset=offset)
            if cotangents is not None:
                missing = [nm for nm in cotangents if nm not in blobs]
                if missing:
                    raise KeyError(f"backward(cotangents=...): unknown blobs {missing}")
                objective = sum((blobs[nm].float() * _to_tensor(c, self.device).float()).sum()
                                for nm, c in cotangents.items())
            else:
                objective = self.total_loss(blobs)
            wrt = list(diffable.items()) + list(taps.items())
            grads = (torch.autograd.grad(objective, [v for _, v in wrt], allow_unused=True)
                     if wrt and torch.is_tensor(objective) and objective.requires_grad
                     else [None] * len(wrt))
        out = {nm: (_to_numpy(g) if g is not None else np.zeros(tuple(v.shape), np.float32))
               for (nm, v), g in zip(wrt, grads)}
        for nm in diffs or []:
            if nm in dev and nm not in out:
                out[nm] = np.zeros(tuple(dev[nm].shape), np.float32)
        return out

    def set_input_arrays(self, data: np.ndarray, labels: np.ndarray) -> None:
        """Feed the MemoryData layer (pycaffe Net.set_input_arrays)."""
        for src in self.data_sources.values():
            if hasattr(src, "set_arrays"):
                src.set_arrays(data, labels)
                return
        raise RuntimeError("net has no MemoryData layer")

    def close(self) -> None:
        """Stop the data layers' prefetch threads and release their stores
        and worker pools. A later pull starts a new thread."""
        for src in self.data_sources.values():
            src.close()

    def _pull_data_layers(self, inputs: Dict[str, Any]) -> None:
        """Fill `inputs` from the data sources for the tops not supplied
        (a batch peeked to materialise the params is served first)."""
        for name, src in self.data_sources.items():
            if all(t in inputs for t in src.tops):
                continue
            batch = self._peeked.pop(name) if name in self._peeked else src.next_batch()
            for top, arr in zip(src.tops, batch):
                inputs.setdefault(top, arr)

    def materialize_params(self) -> None:
        """Materialise the params of a net fed by data layers, from the
        shapes a source declares (MemoryData's memory_data_param), else from
        one batch pulled and kept for the next forward or step."""
        if self._params_ready:
            return
        shapes: Dict[str, Tuple[int, ...]] = {}
        for name, src in self.data_sources.items():
            declared = src.top_shapes()
            if declared is None:
                self._peeked[name] = src.next_batch()
                declared = [tuple(np.shape(a)) for a in self._peeked[name]]
            shapes.update(zip(src.tops, declared))
        self._ensure_params(shapes)
