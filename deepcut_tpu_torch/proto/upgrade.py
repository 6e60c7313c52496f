"""Legacy prototxt upgrades: V0 `layers { layer { … } }` and V1 `layers`
nets -> modern V2 `layer` form, plus the legacy solver `solver_type` enum.

The port's own copy of `deepcut_tpu.proto.upgrade` (jax-free; held against
the original by tests/test_torch_data.py). Reference:
src/caffe/util/upgrade_proto.cpp — UpgradeV0PaddingLayers (:120),
UpgradeV0LayerParameter (:179), UpgradeV0LayerType (:531),
UpgradeV1LayerParameter / UpgradeV1LayerType, UpgradeSolverType. The
reference upgrades at the protobuf-message level; here the same rules are
applied to the schema-free PbNode tree before the graph engine sees it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from deepcut_tpu_torch.proto.text_format import PbNode

# V0 string types -> V2 type strings (UpgradeV0LayerType composed with the
# V1 enum -> V2 mapping).
V0_TYPE_NAMES = {
    "accuracy": "Accuracy", "bnll": "BNLL", "concat": "Concat",
    "conv": "Convolution", "data": "Data", "dropout": "Dropout",
    "euclidean_loss": "EuclideanLoss", "flatten": "Flatten",
    "hdf5_data": "HDF5Data", "hdf5_output": "HDF5Output", "im2col": "Im2col",
    "images": "ImageData", "infogain_loss": "InfogainLoss",
    "innerproduct": "InnerProduct", "lrn": "LRN",
    "multinomial_logistic_loss": "MultinomialLogisticLoss",
    "pool": "Pooling", "relu": "ReLU", "sigmoid": "Sigmoid",
    "softmax": "Softmax", "softmax_loss": "SoftmaxWithLoss", "split": "Split",
    "tanh": "TanH", "window_data": "WindowData",
}


def is_v0_net(proto: PbNode) -> bool:
    """A net is V0 when any `layers` entry nests a `layer { … }` message
    (NetParameter::layer in the V0 schema; upgrade_proto.cpp:19-35)."""
    return any(isinstance(n, PbNode) and n.has("layer")
               for n in proto.get_list("layers"))


def _sub(parent: PbNode, key: str) -> PbNode:
    node = parent.get(key)
    if not isinstance(node, PbNode):
        node = PbNode()
        parent.add(key, node)
    return node


def _fold_padding_layers(proto: PbNode) -> PbNode:
    """UpgradeV0PaddingLayers (upgrade_proto.cpp:120-177): drop V0 `padding`
    layers, copying their pad into the following conv/pool and re-wiring
    that layer's bottom to the padding layer's input."""
    out = PbNode()
    for key, vals in proto.fields.items():
        if key != "layers":
            out.fields[key] = list(vals)
    last_top: Dict[str, Optional[PbNode]] = {
        str(name): None for name in proto.get_list("input")
    }
    kept: List[PbNode] = []
    for conn in proto.get_list("layers"):
        inner = conn.get("layer", PbNode())
        if inner.get_str("type") != "padding":
            kept.append(conn)
            out.add("layers", conn)
        for j, bname in enumerate(conn.get_list("bottom")):
            src = last_top.get(str(bname))
            if src is None:
                continue
            src_inner = src.get("layer", PbNode())
            if src_inner.get_str("type") == "padding":
                assert inner.get_str("type") in ("conv", "pool"), (
                    f"padding layer feeds non-conv/pool layer "
                    f"{inner.get_str('type')!r}")
                inner.fields["pad"] = [src_inner.get_int("pad", 0)]
                conn.fields["bottom"][j] = src.get_list("bottom")[0]
        for tname in conn.get_list("top"):
            last_top[str(tname)] = conn
    return out


def _upgrade_v0_layer(conn: PbNode) -> PbNode:
    """UpgradeV0LayerParameter (upgrade_proto.cpp:179-529): one V0
    connection (bottom/top + nested layer) -> a V2 `layer` node."""
    v0 = conn.get("layer", PbNode())
    t = v0.get_str("type", "")
    out = PbNode()
    if v0.has("name"):
        out.add("name", v0.get_str("name"))
    for b in conn.get_list("bottom"):
        out.add("bottom", str(b))
    for tp in conn.get_list("top"):
        out.add("top", str(tp))
    if t:
        out.add("type", V0_TYPE_NAMES.get(t, t))

    # blobs_lr / weight_decay -> ParamSpec lr_mult / decay_mult
    lrs = [float(v) for v in v0.get_list("blobs_lr")]
    decays = [float(v) for v in v0.get_list("weight_decay")]
    for i in range(max(len(lrs), len(decays))):
        ps = PbNode()
        if i < len(lrs):
            ps.add("lr_mult", lrs[i])
        if i < len(decays):
            ps.add("decay_mult", decays[i])
        out.add("param", ps)

    conv_ip = "convolution_param" if t == "conv" else "inner_product_param"
    if v0.has("num_output"):
        _sub(out, conv_ip).add("num_output", v0.get_int("num_output"))
    if v0.has("biasterm"):
        _sub(out, conv_ip).add("bias_term", v0.get_bool("biasterm"))
    if v0.has("weight_filler"):
        _sub(out, conv_ip).add("weight_filler", v0.get("weight_filler"))
    if v0.has("bias_filler"):
        _sub(out, conv_ip).add("bias_filler", v0.get("bias_filler"))
    if v0.has("pad"):
        _sub(out, "convolution_param" if t == "conv" else "pooling_param").add(
            "pad", v0.get_int("pad"))
    if v0.has("kernelsize"):
        _sub(out, "convolution_param" if t == "conv" else "pooling_param").add(
            "kernel_size", v0.get_int("kernelsize"))
    if v0.has("group"):
        _sub(out, "convolution_param").add("group", v0.get_int("group"))
    if v0.has("stride"):
        _sub(out, "convolution_param" if t == "conv" else "pooling_param").add(
            "stride", v0.get_int("stride"))
    if v0.has("pool"):
        _sub(out, "pooling_param").add("pool", v0.get_str("pool"))
    if v0.has("dropout_ratio"):
        _sub(out, "dropout_param").add("dropout_ratio", v0.get_float("dropout_ratio"))
    for lrn_key in ("local_size", "alpha", "beta", "k"):
        if v0.has(lrn_key):
            _sub(out, "lrn_param").add(lrn_key, v0.get(lrn_key))

    data_param = {
        "data": "data_param", "hdf5_data": "hdf5_data_param",
        "images": "image_data_param", "window_data": "window_data_param",
    }.get(t)
    if v0.has("source"):
        target = "infogain_loss_param" if t == "infogain_loss" else data_param
        if target:
            _sub(out, target).add("source", v0.get_str("source"))
    if v0.has("batchsize") and data_param:
        _sub(out, data_param).add("batch_size", v0.get_int("batchsize"))
    if v0.has("rand_skip") and data_param:
        _sub(out, data_param).add("rand_skip", v0.get_int("rand_skip"))
    if v0.has("shuffle_images"):
        _sub(out, "image_data_param").add("shuffle", v0.get_bool("shuffle_images"))
    if v0.has("new_height"):
        _sub(out, "image_data_param").add("new_height", v0.get_int("new_height"))
    if v0.has("new_width"):
        _sub(out, "image_data_param").add("new_width", v0.get_int("new_width"))
    # transform params live on TransformationParameter in V2
    if v0.has("scale"):
        _sub(out, "transform_param").add("scale", v0.get_float("scale"))
    if v0.has("meanfile"):
        _sub(out, "transform_param").add("mean_file", v0.get_str("meanfile"))
    if v0.has("cropsize"):
        _sub(out, "transform_param").add("crop_size", v0.get_int("cropsize"))
    if v0.has("mirror"):
        _sub(out, "transform_param").add("mirror", v0.get_bool("mirror"))
    if v0.has("concat_dim"):
        _sub(out, "concat_param").add("concat_dim", v0.get_int("concat_dim"))
    for det_key, wd_key in (("det_fg_threshold", "fg_threshold"),
                            ("det_bg_threshold", "bg_threshold"),
                            ("det_fg_fraction", "fg_fraction"),
                            ("det_context_pad", "context_pad"),
                            ("det_crop_mode", "crop_mode")):
        if v0.has(det_key):
            _sub(out, "window_data_param").add(wd_key, v0.get(det_key))
    if v0.has("hdf5_output_param"):
        out.add("hdf5_output_param", v0.get("hdf5_output_param"))
    return out


def upgrade_v0_net(proto: PbNode) -> PbNode:
    """Full V0 text upgrade: fold padding layers, then convert every
    connection to a V2 `layer` (UpgradeV0Net, upgrade_proto.cpp:73-118)."""
    folded = _fold_padding_layers(proto)
    out = PbNode()
    for key, vals in folded.fields.items():
        if key != "layers":
            out.fields[key] = list(vals)
    for conn in folded.get_list("layers"):
        out.add("layer", _upgrade_v0_layer(conn))
    return out


def upgrade_v1_layers(proto: PbNode) -> PbNode:
    """V1 `layers` (flat, enum types, blobs_lr/weight_decay fields) -> V2
    `layer` (UpgradeV1LayerParameter). Type-name mapping is shared with the
    graph engine's lazy path; this adds the ParamSpec conversion."""
    from deepcut_tpu_torch.core.graph import _V1_TYPE_NAMES

    out = PbNode()
    for key, vals in proto.fields.items():
        if key != "layers":
            out.fields[key] = list(vals)
    for old in proto.get_list("layers"):
        layer = PbNode()
        names = [str(s) for s in old.get_list("param")
                 if not isinstance(s, PbNode)]
        lrs = [float(v) for v in old.get_list("blobs_lr")]
        decays = [float(v) for v in old.get_list("weight_decay")]
        for key, vals in old.fields.items():
            if key in ("param", "blobs_lr", "weight_decay"):
                continue
            if key == "type":
                t = str(vals[0])
                layer.add("type", _V1_TYPE_NAMES.get(t, t))
            else:
                layer.fields[key] = list(vals)
        for i in range(max(len(names), len(lrs), len(decays))):
            ps = PbNode()
            if i < len(names):
                ps.add("name", names[i])
            if i < len(lrs):
                ps.add("lr_mult", lrs[i])
            if i < len(decays):
                ps.add("decay_mult", decays[i])
            layer.add("param", ps)
        out.add("layer", layer)
    return out


def upgrade_net(proto: PbNode) -> PbNode:
    """UpgradeNetAsNeeded (upgrade_proto.cpp:19-67): V0 -> V1 -> V2."""
    if is_v0_net(proto):
        return upgrade_v0_net(proto)
    if proto.get_list("layers") and not proto.get_list("layer"):
        return upgrade_v1_layers(proto)
    return proto


# legacy SolverType enum (caffe.proto SolverParameter::SolverType) -> string
SOLVER_TYPE_NAMES = {
    "SGD": "SGD", "NESTEROV": "Nesterov", "ADAGRAD": "AdaGrad",
    "RMSPROP": "RMSProp", "ADADELTA": "AdaDelta", "ADAM": "Adam",
    0: "SGD", 1: "Nesterov", 2: "AdaGrad", 3: "RMSProp", 4: "AdaDelta",
    5: "Adam",
}


def upgrade_solver(proto: PbNode) -> PbNode:
    """UpgradeSolverType: replace legacy `solver_type: ENUM` with
    `type: "Name"` (upgrade_proto.cpp UpgradeSolverAsNeeded)."""
    if proto.has("solver_type") and not proto.has("type"):
        legacy = proto.get("solver_type")
        proto.add("type", SOLVER_TYPE_NAMES[legacy if isinstance(legacy, int)
                                            else str(legacy)])
        del proto.fields["solver_type"]
    return proto
