"""Caffe layer-type registry for the graph engine (counterpart of
`deepcut_tpu.core.layers`).

For each Caffe layer type this module provides:
- ``build(spec, phase, compute_dtype)`` -> ``fn(params_entry, bottoms)``, the
  layer's forward on NCHW tensors;
- ``param_spec(spec, bottom_shapes)`` -> ordered ``(key, shape, filler)``
  describing the layer's blobs in the port's layouts (conv OIHW, deconv
  ``(Cin, Cout/g, kh, kw)``, InnerProduct ``(N_out, K)``), in Caffe's blob
  order, which `core.graph.Net` uses to materialise and to load them.

Axes are Caffe's own: tensors stay NCHW, so a prototxt's ``axis`` is used as
it is (the JAX package maps it onto NHWC), and Flatten / InnerProduct
flatten in C, H, W order.

Precision follows the blob's dtype, as in the JAX package. An f32 blob
(`Net.forward`, the pycaffe contract) gets f32 layers; a convolution or
InnerProduct then sums the products of its operands' bf16 values
(``compute_dtype=bf16``, the weights prepared as bf16 values by the Net) or
of the f32 operands (``compute_dtype=None``, TF32 off), and adds its f32
bias. A bf16 blob (the stream of `Net.make_forward`) gets each op in bf16;
a convolution, deconvolution or InnerProduct then runs on the bf16 values
held in f32 (cuDNN with TF32 allowed: exact products, f32 sums; a matmul
for InnerProduct) and `ops.conv_epilogue` adds the f32 bias and rounds once
to bf16, as XLA's bf16 convolution with an f32 accumulator and bias does.

The loss layers, Accuracy, Python and DummyData belong to the engine's
training slice and raise `NotImplementedError`, as unknown types do.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from deepcut_tpu_torch.ops import activations as act_ops
from deepcut_tpu_torch.ops import eltwise as elt_ops
from deepcut_tpu_torch.ops import linear as lin_ops
from deepcut_tpu_torch.ops import norm as norm_ops
from deepcut_tpu_torch.ops import pool as pool_ops
from deepcut_tpu_torch.ops.conv import conv_output_size, exact_conv, full_f32_conv
from deepcut_tpu_torch.ops.conv_epilogue import conv_epilogue
from deepcut_tpu_torch.proto.text_format import PbNode

BF16 = torch.bfloat16

# the training slice's layer types: built by the JAX package, not ported yet
TRAINING_SLICE_TYPES = (
    "SoftmaxWithLoss", "SoftmaxWithLossVec", "SmoothL1Loss", "SigmoidCrossEntropyLoss",
    "EuclideanLoss", "HingeLoss", "ContrastiveLoss", "InfogainLoss",
    "MultinomialLogisticLoss", "Accuracy", "Python", "DummyData")


def not_ported(spec, what: str = "the engine's training slice") -> NotImplementedError:
    return NotImplementedError(
        f"layer type {spec.type!r} (layer {spec.name!r}) belongs to {what} of the "
        "port, which is not ported yet")


# -- config extraction ------------------------------------------------------


def conv_geometry(cp: PbNode) -> Dict[str, Any]:
    ks = [int(v) for v in cp.get_list("kernel_size")]
    kh = cp.get_int("kernel_h") or (ks[0] if ks else 0)
    kw = cp.get_int("kernel_w") or (ks[1] if len(ks) > 1 else (ks[0] if ks else 0))
    pads = [int(v) for v in cp.get_list("pad")]
    ph = cp.get_int("pad_h") if cp.has("pad_h") else (pads[0] if pads else 0)
    pw = cp.get_int("pad_w") if cp.has("pad_w") else (pads[1] if len(pads) > 1 else (pads[0] if pads else 0))
    strides = [int(v) for v in cp.get_list("stride")]
    sh = cp.get_int("stride_h") if cp.has("stride_h") else (strides[0] if strides else 1)
    sw = cp.get_int("stride_w") if cp.has("stride_w") else (strides[1] if len(strides) > 1 else (strides[0] if strides else 1))
    dil = [int(v) for v in cp.get_list("dilation")]
    dh = dil[0] if dil else 1
    dw = dil[1] if len(dil) > 1 else dh
    return dict(
        num_output=cp.get_int("num_output", 0),
        kernel=(kh, kw), stride=(sh, sw), pad=(ph, pw), dilation=(dh, dw),
        groups=cp.get_int("group", 1),
        bias=cp.get_bool("bias_term", True),
    )


# -- registry ---------------------------------------------------------------

_BUILDERS: Dict[str, Callable] = {}
_PARAM_SPECS: Dict[str, Callable] = {}


def register(name: str, param_spec: Optional[Callable] = None):
    def deco(fn):
        _BUILDERS[name] = fn
        if param_spec is not None:
            _PARAM_SPECS[name] = param_spec
        return fn
    return deco


def build(spec, phase: str, compute_dtype) -> Optional[Callable]:
    if spec.type in TRAINING_SLICE_TYPES:
        raise not_ported(spec)
    builder = _BUILDERS.get(spec.type)
    if builder is None:
        raise NotImplementedError(
            f"layer type {spec.type!r} (layer {spec.name!r}) is not implemented")
    return builder(spec, phase, compute_dtype)


def param_spec(spec, bottom_shapes: List[Tuple[int, ...]]):
    fn = _PARAM_SPECS.get(spec.type)
    return fn(spec, bottom_shapes) if fn else []


def registered_types() -> List[str]:
    """The layer types `build` implements, sorted."""
    return sorted(_BUILDERS)


def _filler(node: PbNode, key: str) -> PbNode:
    return node.get(key, PbNode())


def _constant(value: float) -> PbNode:
    node = PbNode()
    node.add("type", "constant")
    node.add("value", value)
    return node


def _align(t: torch.Tensor, x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """A second bottom (or a blob shaped like it) broadcast over x from
    `axis` on, as Caffe's Scale / Bias layers read it."""
    if t.dim() == x.dim():
        return t
    return t.reshape((1,) * axis + tuple(t.shape) + (1,) * (x.dim() - axis - t.dim()))


# Convolution ---------------------------------------------------------------


def _to_cl(y: torch.Tensor) -> torch.Tensor:
    """The epilogue kernel reads channels_last rows on the card."""
    if y.is_cuda and not y.is_contiguous(memory_format=torch.channels_last):
        return y.contiguous(memory_format=torch.channels_last)
    return y


def conv_forward(x: torch.Tensor, p, g: Dict[str, Any], compute_dtype, *,
                 transposed: bool = False) -> torch.Tensor:
    """One Convolution / Deconvolution in the blob's precision (module
    docstring). ``p["w"]`` holds the operand values: bf16 values in f32
    when the net computes in bf16 (`Net` prepares them once)."""
    kw = dict(stride=g["stride"], pad=g["pad"], dilation=g["dilation"], groups=g["groups"],
              transposed=transposed)
    b = p.get("b")
    if x.dtype == BF16:
        y = _to_cl(exact_conv(x.float(), p["w"], **kw))
        return conv_epilogue(y, b).to(BF16)
    if compute_dtype is not None:
        y = exact_conv(x.to(BF16).float(), p["w"], **kw)
    else:
        y = full_f32_conv(x, p["w"], **kw)
    return y if b is None else y + b.reshape(1, -1, 1, 1)


def _conv_param_spec(spec, bottom_shapes):
    cp = spec.param("convolution_param")
    g = conv_geometry(cp)
    kh, kw = g["kernel"]
    out = [("w", (g["num_output"], bottom_shapes[0][1] // g["groups"], kh, kw),
            _filler(cp, "weight_filler"))]
    if g["bias"]:
        out.append(("b", (g["num_output"],), _filler(cp, "bias_filler")))
    return out


@register("Convolution", _conv_param_spec)
def _conv(spec, phase, compute_dtype):
    g = conv_geometry(spec.param("convolution_param"))
    return lambda p, b: conv_forward(b[0], p, g, compute_dtype)


def _deconv_param_spec(spec, bottom_shapes):
    cp = spec.param("convolution_param")
    g = conv_geometry(cp)
    kh, kw = g["kernel"]
    out = [("w", (bottom_shapes[0][1], g["num_output"] // g["groups"], kh, kw),
            _filler(cp, "weight_filler"))]
    if g["bias"]:
        out.append(("b", (g["num_output"],), _filler(cp, "bias_filler")))
    return out


@register("Deconvolution", _deconv_param_spec)
def _deconv(spec, phase, compute_dtype):
    g = conv_geometry(spec.param("convolution_param"))
    return lambda p, b: conv_forward(b[0], p, g, compute_dtype, transposed=True)


# Normalisation -------------------------------------------------------------


def _bn_param_spec(spec, bottom_shapes):
    # (mean 0, var 1, scale factor 1): an untrained net normalises by the
    # identity, as the JAX package initialises it
    c = bottom_shapes[0][1]
    return [("mean", (c,), PbNode()), ("var", (c,), _constant(1.0)),
            ("scale_factor", (1,), _constant(1.0))]


@register("BatchNorm", _bn_param_spec)
def _batchnorm(spec, phase, compute_dtype):
    bp = spec.param("batch_norm_param")
    eps = bp.get_float("eps", 1e-5)
    if phase == "TRAIN" and not bp.get_bool("use_global_stats", False):
        raise not_ported(spec, "the engine's training slice (batch statistics)")
    return lambda p, b: norm_ops.batch_norm_inference(
        b[0], p["mean"], p["var"], p.get("scale_factor"), eps=eps)


def _scale_param_spec(spec, bottom_shapes):
    sp = spec.param("scale_param")
    out = []
    if len(bottom_shapes) < 2:
        # with 2 bottoms the scale comes from bottom[1] and no gamma blob
        # exists (scale_layer.cpp:15-43)
        out.append(("gamma", (bottom_shapes[0][1],), sp.get("filler", _constant(1.0))))
        bias_shape = (bottom_shapes[0][1],)
    else:
        bias_shape = tuple(bottom_shapes[1])  # shaped like the scale
    if sp.get_bool("bias_term", False):
        out.append(("beta", bias_shape, _filler(sp, "bias_filler")))
    return out


@register("Scale", _scale_param_spec)
def _scale(spec, phase, compute_dtype):
    axis = spec.param("scale_param").get_int("axis", 1)

    def fn(p, bottoms):
        x = bottoms[0]
        if len(bottoms) == 2:
            y = x * _align(bottoms[1], x, axis)
            if p and "beta" in p:
                y = y + _align(p["beta"].to(y.dtype), y, axis)
            return y
        return norm_ops.scale(x, p["gamma"], p.get("beta"))
    return fn


def _bias_param_spec(spec, bottom_shapes):
    return [("beta", (bottom_shapes[0][1],), _filler(spec.param("bias_param"), "filler"))]


@register("Bias", _bias_param_spec)
def _bias(spec, phase, compute_dtype):
    axis = spec.param("bias_param").get_int("axis", 1)

    def fn(p, bottoms):
        x = bottoms[0]
        if len(bottoms) == 2:
            return x + _align(bottoms[1], x, axis)
        return x + act_ops.per_channel(p["beta"].to(x.dtype), x)
    return fn


@register("LRN")
def _lrn(spec, phase, compute_dtype):
    lp = spec.param("lrn_param")
    cfg = dict(
        local_size=lp.get_int("local_size", 5),
        alpha=lp.get_float("alpha", 1.0),
        beta=lp.get_float("beta", 0.75),
        k=lp.get_float("k", 1.0),
        across_channels=lp.get_str("norm_region", "ACROSS_CHANNELS") == "ACROSS_CHANNELS",
    )
    return lambda p, b: norm_ops.lrn(b[0], **cfg)


@register("MVN")
def _mvn(spec, phase, compute_dtype):
    mp = spec.param("mvn_param")
    cfg = dict(
        normalize_variance=mp.get_bool("normalize_variance", True),
        across_channels=mp.get_bool("across_channels", False),
        eps=mp.get_float("eps", 1e-9),
    )
    return lambda p, b: norm_ops.mvn(b[0], **cfg)


# Activations ---------------------------------------------------------------


@register("ReLU")
def _relu(spec, phase, compute_dtype):
    slope = spec.param("relu_param").get_float("negative_slope", 0.0)
    return lambda p, b: act_ops.caffe_relu(b[0], negative_slope=slope)


@register("Sigmoid")
def _sigmoid(spec, phase, compute_dtype):
    return lambda p, b: torch.sigmoid(b[0])


@register("TanH")
def _tanh(spec, phase, compute_dtype):
    return lambda p, b: torch.tanh(b[0])


@register("ELU")
def _elu(spec, phase, compute_dtype):
    alpha = spec.param("elu_param").get_float("alpha", 1.0)
    return lambda p, b: act_ops.elu(b[0], alpha=alpha)


def _prelu_param_spec(spec, bottom_shapes):
    pp = spec.param("prelu_param")
    shape = (1,) if pp.get_bool("channel_shared", False) else (bottom_shapes[0][1],)
    return [("slopes", shape, pp.get("filler", _constant(0.25)))]


@register("PReLU", _prelu_param_spec)
def _prelu(spec, phase, compute_dtype):
    shared = spec.param("prelu_param").get_bool("channel_shared", False)
    return lambda p, b: act_ops.prelu(b[0], p["slopes"], channel_shared=shared)


@register("BNLL")
def _bnll(spec, phase, compute_dtype):
    return lambda p, b: act_ops.bnll(b[0])


@register("AbsVal")
def _absval(spec, phase, compute_dtype):
    return lambda p, b: torch.abs(b[0])


@register("Power")
def _power(spec, phase, compute_dtype):
    pp = spec.param("power_param")
    cfg = dict(power=pp.get_float("power", 1.0), scale=pp.get_float("scale", 1.0),
               shift=pp.get_float("shift", 0.0))
    return lambda p, b: act_ops.power_op(b[0], **cfg)


@register("Exp")
def _exp(spec, phase, compute_dtype):
    ep = spec.param("exp_param")
    cfg = dict(base=ep.get_float("base", -1.0), scale=ep.get_float("scale", 1.0),
               shift=ep.get_float("shift", 0.0))
    return lambda p, b: act_ops.exp_op(b[0], **cfg)


@register("Log")
def _log(spec, phase, compute_dtype):
    lp = spec.param("log_param")
    cfg = dict(base=lp.get_float("base", -1.0), scale=lp.get_float("scale", 1.0),
               shift=lp.get_float("shift", 0.0))
    return lambda p, b: act_ops.log_op(b[0], **cfg)


@register("Threshold")
def _threshold(spec, phase, compute_dtype):
    t = spec.param("threshold_param").get_float("threshold", 0.0)
    return lambda p, b: act_ops.threshold(b[0], t=t)


@register("Dropout")
def _dropout(spec, phase, compute_dtype):
    # TEST: the identity (Caffe scales the kept units at train time)
    if phase != "TEST" and spec.param("dropout_param").get_float("dropout_ratio", 0.5) > 0:
        raise not_ported(spec, "the engine's training slice (dropout masks)")
    return lambda p, b: b[0]


# Pooling -------------------------------------------------------------------


@register("Pooling")
def _pooling(spec, phase, compute_dtype):
    pp = spec.param("pooling_param")
    method = pp.get_str("pool", "MAX")
    if pp.get_bool("global_pooling", False):
        if method == "MAX":
            return lambda p, b: b[0].amax(dim=(2, 3), keepdim=True)
        return lambda p, b: b[0].mean(dim=(2, 3), keepdim=True)
    ks = pp.get_int("kernel_size", 0)
    kernel = (pp.get_int("kernel_h") or ks, pp.get_int("kernel_w") or ks)
    stride = (pp.get_int("stride_h") or pp.get_int("stride", 1),
              pp.get_int("stride_w") or pp.get_int("stride", 1))
    pad = (pp.get_int("pad_h") if pp.has("pad_h") else pp.get_int("pad", 0),
           pp.get_int("pad_w") if pp.has("pad_w") else pp.get_int("pad", 0))
    if method == "MAX":
        return lambda p, b: pool_ops.max_pool2d(b[0], kernel=kernel, stride=stride, pad=pad)
    if method == "STOCHASTIC":
        if phase == "TRAIN":
            raise not_ported(spec, "the engine's training slice (stochastic sampling)")
        return lambda p, b: pool_ops.stochastic_pool2d_test(b[0], kernel=kernel, stride=stride)
    return lambda p, b: pool_ops.avg_pool2d(b[0], kernel=kernel, stride=stride, pad=pad)


# Shape / fusion ------------------------------------------------------------


@register("Eltwise")
def _eltwise(spec, phase, compute_dtype):
    ep = spec.param("eltwise_param")
    op = ep.get_str("operation", "SUM")
    coeffs = [float(c) for c in ep.get_list("coeff")] or None
    if op == "SUM":
        return lambda p, b: elt_ops.eltwise_sum(b, coeffs)
    if op == "PROD":
        return lambda p, b: elt_ops.eltwise_prod(b)
    return lambda p, b: elt_ops.eltwise_max(b)


@register("Crop")
def _crop(spec, phase, compute_dtype):
    cp = spec.param("crop_param")
    axis = cp.get_int("axis", 2)
    offsets = [int(o) for o in cp.get_list("offset")]
    return lambda p, b: elt_ops.crop_like(b[0], b[1].shape, axis=axis, offsets=offsets)


@register("Concat")
def _concat(spec, phase, compute_dtype):
    cp = spec.param("concat_param")
    axis = cp.get_int("concat_dim", None)
    if axis is None:
        axis = cp.get_int("axis", 1)
    return lambda p, b: torch.cat(b, dim=axis)


@register("Slice")
def _slice(spec, phase, compute_dtype):
    sp = spec.param("slice_param")
    axis = sp.get_int("slice_dim", None)
    if axis is None:
        axis = sp.get_int("axis", 1)
    points = [int(v) for v in sp.get_list("slice_point")]
    n_top = len(spec.tops)
    return lambda p, b: elt_ops.slice_op(b[0], axis=axis, slice_points=points, num_outputs=n_top)


@register("Split")
def _split(spec, phase, compute_dtype):
    n = len(spec.tops)
    return lambda p, b: [b[0]] * n


@register("Flatten")
def _flatten(spec, phase, compute_dtype):
    fp = spec.param("flatten_param")
    axis, end_axis = fp.get_int("axis", 1), fp.get_int("end_axis", -1)
    return lambda p, b: elt_ops.flatten_op(b[0], axis=axis, end_axis=end_axis)


@register("Reshape")
def _reshape(spec, phase, compute_dtype):
    rp = spec.param("reshape_param")
    dims = [int(d) for d in rp.get("shape", PbNode()).get_list("dim")]
    axis = rp.get_int("axis", 0)
    num_axes = rp.get_int("num_axes", -1)

    def fn(p, bottoms):
        x = bottoms[0]
        old = list(x.shape)
        end = len(old) if num_axes == -1 else axis + num_axes
        mid = [old[axis + i] if d == 0 else d for i, d in enumerate(dims)]
        return x.reshape(old[:axis] + mid + old[end:])
    return fn


@register("Tile")
def _tile(spec, phase, compute_dtype):
    tp = spec.param("tile_param")
    axis, tiles = tp.get_int("axis", 1), tp.get_int("tiles", 1)
    return lambda p, b: elt_ops.tile_op(b[0], axis=axis, tiles=tiles)


@register("BatchReindex")
def _batch_reindex(spec, phase, compute_dtype):
    return lambda p, b: elt_ops.batch_reindex(b[0], b[1])


@register("Reduction")
def _reduction(spec, phase, compute_dtype):
    rp = spec.param("reduction_param")
    cfg = dict(op=rp.get_str("operation", "SUM"), axis=rp.get_int("axis", 0),
               coeff=rp.get_float("coeff", 1.0))
    return lambda p, b: elt_ops.reduction_op(b[0], **cfg)


@register("Im2col")
def _im2col(spec, phase, compute_dtype):
    g = conv_geometry(spec.param("convolution_param"))

    def fn(p, bottoms):
        x = bottoms[0]
        oh, ow = (conv_output_size(x.shape[2 + i], g["kernel"][i], g["stride"][i], g["pad"][i],
                                   g["dilation"][i]) for i in (0, 1))
        cols = F.unfold(x.float(), g["kernel"], dilation=g["dilation"], padding=g["pad"],
                        stride=g["stride"])
        return cols.reshape(x.shape[0], -1, oh, ow)
    return fn


@register("Filter")
def _filter(spec, phase, compute_dtype):
    """Filter layer (filter_layer.cpp): the last bottom is a (N, 1, ...)
    selector; items with a non-zero selector are kept. `Net.forward` runs
    `host_dynamic`, which truly shrinks the batch as the reference does;
    `make_forward` keeps the JAX package's static form, kept items first
    and the rest zeroed."""
    n_tops = len(spec.tops)

    def fn(p, bottoms):
        keep = bottoms[-1].reshape(bottoms[-1].shape[0], -1)[:, 0] != 0
        order = torch.argsort((~keep).to(torch.int8), stable=True)  # kept items first
        outs = []
        for b in bottoms[:-1]:
            mask = keep[order].reshape((-1,) + (1,) * (b.dim() - 1))
            outs.append(torch.where(mask, b[order], torch.zeros((), dtype=b.dtype, device=b.device)))
        return outs if n_tops > 1 else outs[0]

    def host_dynamic(p, bottoms):
        kept = torch.nonzero(bottoms[-1].reshape(bottoms[-1].shape[0], -1)[:, 0] != 0)[:, 0]
        outs = [b.index_select(0, kept) for b in bottoms[:-1]]
        return outs if n_tops > 1 else outs[0]
    fn.host_dynamic = host_dynamic
    return fn


@register("SPP")
def _spp(spec, phase, compute_dtype):
    """Spatial pyramid pooling (spp_layer.cpp): pooling levels of 4^l bins,
    each flattened (C, bin row, bin column) and concatenated."""
    sp = spec.param("spp_param")
    levels = sp.get_int("pyramid_height", 3)
    method = sp.get_str("pool", "MAX")

    def fn(p, bottoms):
        x = bottoms[0]
        n, _, h, w = x.shape
        feats = []
        for level in range(levels):
            bins = 2 ** level
            # kernel = ceil(dim / bins), stride = kernel, pad = (rest + 1) / 2
            kh, kw = -(-h // bins), -(-w // bins)
            pad = ((kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2)
            pool = pool_ops.max_pool2d if method == "MAX" else pool_ops.avg_pool2d
            y = pool(x, kernel=(kh, kw), stride=(kh, kw), pad=pad)
            feats.append(y[:, :, :bins, :bins].reshape(n, -1))
        return torch.cat(feats, dim=1)
    return fn


# Dense ---------------------------------------------------------------------


def _ip_param_spec(spec, bottom_shapes):
    ip = spec.param("inner_product_param")
    axis = ip.get_int("axis", 1)
    n = ip.get_int("num_output", 0)
    k = 1
    for d in bottom_shapes[0][axis:]:
        k *= d
    out = [("w", (k, n) if ip.get_bool("transpose", False) else (n, k),
            _filler(ip, "weight_filler"))]
    if ip.get_bool("bias_term", True):
        out.append(("b", (n,), _filler(ip, "bias_filler")))
    return out


@register("InnerProduct", _ip_param_spec)
def _inner_product(spec, phase, compute_dtype):
    ip = spec.param("inner_product_param")
    axis = ip.get_int("axis", 1)
    transpose = ip.get_bool("transpose", False)

    def fn(p, bottoms):
        x = bottoms[0]
        lead = tuple(x.shape[:axis])
        b = p.get("b")
        if x.dtype == BF16:
            y = lin_ops.inner_product(x, p["w"], axis=axis, transpose=transpose)
            y = conv_epilogue(y.reshape(y.shape[0], y.shape[1], 1, 1), b)
            return y.reshape(lead + (y.shape[1],)).to(BF16)
        xr = x.to(BF16) if compute_dtype is not None else x
        y = lin_ops.inner_product(xr, p["w"], axis=axis, transpose=transpose)
        y = y if b is None else y + b
        return y.reshape(lead + (y.shape[-1],))
    return fn


def _embed_param_spec(spec, bottom_shapes):
    ep = spec.param("embed_param")
    out = [("w", (ep.get_int("input_dim", 0), ep.get_int("num_output", 0)),
            _filler(ep, "weight_filler"))]
    if ep.get_bool("bias_term", True):
        out.append(("b", (ep.get_int("num_output", 0),), _filler(ep, "bias_filler")))
    return out


@register("Embed", _embed_param_spec)
def _embed(spec, phase, compute_dtype):
    return lambda p, b: lin_ops.embed(b[0], p["w"], p.get("b"))


@register("Softmax")
def _softmax(spec, phase, compute_dtype):
    axis = spec.param("softmax_param").get_int("axis", 1)
    return lambda p, b: lin_ops.softmax_op(b[0], axis=axis)


@register("ArgMax")
def _argmax(spec, phase, compute_dtype):
    ap = spec.param("argmax_param")
    axis = ap.get_int("axis", None)
    cfg = dict(top_k=ap.get_int("top_k", 1), out_max_val=ap.get_bool("out_max_val", False))
    return lambda p, b: lin_ops.argmax_op(b[0], axis=axis, **cfg)
