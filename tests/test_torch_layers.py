"""Each of the graph engine's 37 forward layer types in the port
(`deepcut_tpu_torch.core.layers`) against the JAX package's
(`deepcut_tpu.core.layers`), one parametrised case per type and mode.

Every case is a one-layer prototxt built by both packages' `Net` on the
CPU. The JAX net's params (constant fillers: the fillers have their own
test in tests/test_torch_graph.py) are replaced by seeded numpy values (so that BatchNorm statistics, scale factors and slopes are
not the identity) and carried across with
`models.convert.graph_params_from_numpy`; the inputs are the same seeded
numpy arrays. Each case runs in two precisions:

- ``f32``: `Net.forward` with ``compute_dtype=None`` on both sides (the
  pycaffe contract, every blob f32);
- ``bf16``: `make_forward` with ``compute_dtype=bf16`` (the JAX function
  jitted, as the package runs it), so the stream and each layer's
  arithmetic are bf16 on both sides.

Tolerances, per case: f32 in units in the last place at the output's
largest magnitude (sums and products that cancel are exact to that scale,
not to their tiny results); bf16 in steps of the stream at each element's
magnitude; 0 is bit-equal. Their reasons:
- data movement, comparisons, max / min, ReLU, and single f32 adds and
  products: 0. PyTorch and XLA both compute a bf16 op in f32 and round
  once, and f32 adds, products and quotients are correctly rounded;
- Scale in f32: 1. The jitted JAX forward contracts ``x * gamma + beta``
  into one FMA; the port rounds the product first;
- the last bf16 op of a stream before its f32 output (Scale, Bias,
  Eltwise SUM / PROD here): 0.5 step. XLA:CPU leaves the last bf16
  arithmetic op before ``astype(f32)`` unrounded (its f32 result of the
  bf16 operands) while keeping every earlier rounding, and ReLU's select
  and an explicit ``astype(bf16)`` rounded; the port rounds every bf16
  op (`test_xla_leaves_the_last_bf16_op_unrounded` pins this);
- convolutions and matrix products: the f32 sums run in another order
  (oneDNN / PyTorch against XLA), a few f32 ulps; in bf16 they round to
  the same value but for a rare tie: 1 step;
- transcendental functions (exp, log, pow, tanh, rsqrt, the softmax's
  exp) are each library's own approximation: 1-4 f32 ulps, 1 bf16 step;
  the bf16 sigmoid 2 steps (XLA expands the bf16 logistic over rounded
  intermediates and leaves its last op unrounded);
- means and window sums (MVN, AVE pooling, Reduction) sum in another
  order: 1-8 f32 ulps.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepcut_tpu.core.graph import Net as JNet
from deepcut_tpu.proto import text_format as j_tf
from deepcut_tpu_torch.core.graph import Net as TNet
from deepcut_tpu_torch.core.layers import registered_types
from deepcut_tpu_torch.models.convert import graph_params_from_numpy
from deepcut_tpu_torch.proto import text_format as t_tf

X = (2, 4, 7, 9)  # the default input: N, C, H, W

# (case id, inputs {name: shape or ("ids", shape, high) / ("abs", shape) /
#  ("sel", shape)}, layer body, f32 ulps, bf16 ulps)
CASES = [
    ("Convolution-3x3", {"data": X},
     'type: "Convolution" convolution_param { num_output: 6 kernel_size: 3 pad: 1 }',
     4, 1),
    ("Convolution-rect-strided-dilated", {"data": X},
     'type: "Convolution" convolution_param { num_output: 5 kernel_h: 3 kernel_w: 2 stride_h: 2 '
     'stride_w: 1 pad_h: 2 pad_w: 0 dilation: 2 }',
     4, 1),
    ("Convolution-grouped-nobias", {"data": X},
     'type: "Convolution" convolution_param { num_output: 6 kernel_size: 3 group: 2 '
     'bias_term: false }', 4, 1),
    ("Deconvolution-4x4-stride2", {"data": X},
     'type: "Deconvolution" convolution_param { num_output: 3 kernel_size: 4 stride: 2 pad: 1 }',
     4, 1),
    ("Deconvolution-grouped-dilated", {"data": X},
     'type: "Deconvolution" convolution_param { num_output: 4 kernel_size: 3 stride: 2 '
     'dilation: 2 group: 2 }', 4, 1),
    ("BatchNorm", {"data": X}, 'type: "BatchNorm" batch_norm_param { eps: 0.001 }', 2, 1),
    ("Scale-bias", {"data": X}, 'type: "Scale" scale_param { bias_term: true }', 1, 0.5),
    ("Scale-two-bottoms", {"data": X, "s": X}, 'type: "Scale" scale_param { bias_term: true }',
     1, 0.5),
    ("Bias", {"data": X}, 'type: "Bias"', 0, 0.5),
    ("Bias-two-bottoms", {"data": X, "s": X}, 'type: "Bias"', 0, 0.5),
    ("LRN-across", {"data": X},
     'type: "LRN" lrn_param { local_size: 3 alpha: 0.5 beta: 0.75 k: 2 }', 2, 1),
    ("LRN-within", {"data": X},
     'type: "LRN" lrn_param { local_size: 3 alpha: 0.5 beta: 0.75 norm_region: WITHIN_CHANNEL }',
     2, 1),
    ("MVN", {"data": X}, 'type: "MVN"', 4, 1),
    ("MVN-across-mean-only", {"data": X},
     'type: "MVN" mvn_param { across_channels: true normalize_variance: false }', 1, 1),
    ("ReLU", {"data": X}, 'type: "ReLU"', 0, 0),
    ("ReLU-leaky", {"data": X}, 'type: "ReLU" relu_param { negative_slope: 0.1 }', 0, 0),
    ("Sigmoid", {"data": X}, 'type: "Sigmoid"', 2, 2),
    ("TanH", {"data": X}, 'type: "TanH"', 4, 1),
    ("ELU", {"data": X}, 'type: "ELU" elu_param { alpha: 0.7 }', 1, 1),
    ("PReLU", {"data": X}, 'type: "PReLU"', 0, 0),
    ("PReLU-shared", {"data": X}, 'type: "PReLU" prelu_param { channel_shared: true }', 0, 0),
    ("BNLL", {"data": X}, 'type: "BNLL"', 1, 1),
    ("AbsVal", {"data": X}, 'type: "AbsVal"', 0, 0),
    ("Power", {"data": X}, 'type: "Power" power_param { power: 2 scale: 0.5 shift: 1 }', 1, 1),
    ("Power-fractional", {"data": ("abs", X)},
     'type: "Power" power_param { power: 0.5 shift: 0.25 }', 1, 1),
    ("Exp", {"data": X}, 'type: "Exp" exp_param { scale: 0.5 shift: 0.1 }', 1, 1),
    ("Exp-base2", {"data": X}, 'type: "Exp" exp_param { base: 2 scale: 0.5 }', 1, 1),
    ("Log", {"data": ("abs", X)}, 'type: "Log" log_param { shift: 0.5 }', 2, 1),
    ("Log-base10", {"data": ("abs", X)}, 'type: "Log" log_param { base: 10 scale: 2 shift: 1 }',
     2, 1),
    ("Threshold", {"data": X}, 'type: "Threshold" threshold_param { threshold: 0.2 }', 0, 0),
    ("Dropout", {"data": X}, 'type: "Dropout" dropout_param { dropout_ratio: 0.3 }', 0, 0),
    ("Pooling-max-ceil", {"data": X}, 'type: "Pooling" pooling_param { pool: MAX kernel_size: 3 '
     'stride: 2 }', 0, 0),
    ("Pooling-max-padded-rect", {"data": X}, 'type: "Pooling" pooling_param { pool: MAX '
     'kernel_h: 3 kernel_w: 2 stride_h: 2 stride_w: 3 pad_h: 1 pad_w: 1 }', 0, 0),
    ("Pooling-ave-padded-ceil", {"data": X}, 'type: "Pooling" pooling_param { pool: AVE '
     'kernel_size: 3 stride: 2 pad: 1 }', 1, 1),
    ("Pooling-stochastic-test", {"data": ("abs", X)}, 'type: "Pooling" pooling_param { '
     'pool: STOCHASTIC kernel_size: 3 stride: 2 }', 1, 1),
    ("Pooling-global-ave", {"data": X}, 'type: "Pooling" pooling_param { pool: AVE '
     'global_pooling: true }', 4, 1),
    ("Pooling-global-max", {"data": X}, 'type: "Pooling" pooling_param { pool: MAX '
     'global_pooling: true }', 0, 0),
    ("Eltwise-sum", {"data": X, "s": X}, 'type: "Eltwise"', 0, 0.5),
    ("Eltwise-sum-coeffs", {"data": X, "s": X},
     'type: "Eltwise" eltwise_param { operation: SUM coeff: 0.5 coeff: -1.5 }', 0, 0.5),
    ("Eltwise-prod", {"data": X, "s": X}, 'type: "Eltwise" eltwise_param { operation: PROD }',
     0, 0.5),
    ("Eltwise-max", {"data": X, "s": X}, 'type: "Eltwise" eltwise_param { operation: MAX }', 0, 0),
    ("Crop-offsets", {"data": X, "s": (2, 4, 4, 5)},
     'type: "Crop" crop_param { axis: 2 offset: 1 offset: 3 }', 0, 0),
    ("Crop-axis1", {"data": X, "s": (2, 3, 5, 5)}, 'type: "Crop" crop_param { axis: 1 offset: 1 }',
     0, 0),
    ("Concat-channels", {"data": X, "s": (2, 3, 7, 9)}, 'type: "Concat"', 0, 0),
    ("Concat-height", {"data": X, "s": (2, 4, 2, 9)}, 'type: "Concat" concat_param { axis: 2 }',
     0, 0),
    ("Slice-points", {"data": X}, 'type: "Slice" slice_param { axis: 1 slice_point: 1 '
     'slice_point: 3 }', 0, 0, 3),
    ("Slice-even-width", {"data": (2, 4, 7, 8)}, 'type: "Slice" slice_param { axis: 3 }', 0, 0, 2),
    ("Split", {"data": X}, 'type: "Split"', 0, 0, 2),
    ("Flatten", {"data": X}, 'type: "Flatten"', 0, 0),
    ("Flatten-end-axis", {"data": X}, 'type: "Flatten" flatten_param { axis: 1 end_axis: 2 }', 0, 0),
    ("Reshape", {"data": X}, 'type: "Reshape" reshape_param { shape { dim: 0 dim: 2 dim: -1 '
     'dim: 9 } }', 0, 0),
    ("Tile", {"data": X}, 'type: "Tile" tile_param { axis: 1 tiles: 2 }', 0, 0),
    ("BatchReindex", {"data": (4, 3, 5, 6), "idx": ("ids", (5,), 4)}, 'type: "BatchReindex"',
     0, 0),
    ("Reduction-sum", {"data": X}, 'type: "Reduction" reduction_param { axis: 1 }', 8, 1),
    ("Reduction-mean", {"data": X}, 'type: "Reduction" reduction_param { operation: MEAN '
     'axis: 2 coeff: 2 }', 8, 1),
    ("Reduction-asum", {"data": X}, 'type: "Reduction" reduction_param { operation: ASUM '
     'axis: 1 }', 8, 1),
    ("Reduction-sumsq", {"data": X}, 'type: "Reduction" reduction_param { operation: SUMSQ '
     'axis: 3 coeff: 0.5 }', 8, 1),
    ("Im2col", {"data": X}, 'type: "Im2col" convolution_param { kernel_size: 3 stride: 2 pad: 1 }',
     0, 0),
    ("Filter", {"data": (4, 3, 5, 6), "sel": ("sel", (4, 1, 1, 1))}, 'type: "Filter"', 0, 0),
    ("SPP-max", {"data": X}, 'type: "SPP" spp_param { pyramid_height: 3 }', 0, 0),
    ("SPP-ave", {"data": X}, 'type: "SPP" spp_param { pyramid_height: 2 pool: AVE }', 1, 1),
    ("InnerProduct", {"data": X}, 'type: "InnerProduct" inner_product_param { num_output: 5 }', 8, 1),
    ("InnerProduct-transpose-nobias", {"data": X}, 'type: "InnerProduct" inner_product_param { '
     'num_output: 5 transpose: true bias_term: false }', 8, 1),
    ("InnerProduct-axis2", {"data": X}, 'type: "InnerProduct" inner_product_param { '
     'num_output: 3 axis: 2 }', 8, 1),
    ("Embed", {"data": ("ids", (2, 5), 6)}, 'type: "Embed" embed_param { input_dim: 6 '
     'num_output: 4 }', 0, 0),
    ("Softmax", {"data": X}, 'type: "Softmax"', 2, 1),
    ("Softmax-height", {"data": X}, 'type: "Softmax" softmax_param { axis: 2 }', 2, 1),
    ("ArgMax-flat-topk", {"data": X}, 'type: "ArgMax" argmax_param { top_k: 3 }', 0, 0),
    ("ArgMax-flat-maxval", {"data": X}, 'type: "ArgMax" argmax_param { top_k: 2 '
     'out_max_val: true }', 0, 0),
    ("ArgMax-channels", {"data": X}, 'type: "ArgMax" argmax_param { axis: 1 top_k: 2 }', 0, 0),
    ("ArgMax-channels-maxval", {"data": X}, 'type: "ArgMax" argmax_param { axis: 1 '
     'out_max_val: true }', 0, 0),
]


def _case(entry):
    cid, inputs, body, f32_ulps, bf16_ulps = entry[:5]
    return cid, inputs, body, f32_ulps, bf16_ulps, (entry[5] if len(entry) > 5 else 1)


def _prototxt(inputs, body, n_tops):
    lines = ['name: "one"']
    for nm, spec in inputs.items():
        shape = spec if isinstance(spec[0], int) else spec[1]
        lines.append(f'input: "{nm}" input_shape {{ ' + " ".join(f"dim: {d}" for d in shape) + " }")
    tops = " ".join(f'top: "out{i}"' for i in range(n_tops))
    bottoms = " ".join(f'bottom: "{nm}"' for nm in inputs)
    lines.append(f'layer {{ name: "layer" {bottoms} {tops} {body} }}')
    return "\n".join(lines)


def _inputs(inputs, rng):
    out = {}
    for nm, spec in inputs.items():
        if isinstance(spec[0], int):
            out[nm] = (rng.randn(*spec) * 1.5).astype(np.float32)
        elif spec[0] == "abs":
            out[nm] = np.abs(rng.randn(*spec[1])).astype(np.float32) + 0.05
        elif spec[0] == "ids":
            out[nm] = rng.randint(0, spec[2], spec[1]).astype(np.float32)
        else:  # a Filter selector with zeros
            sel = np.zeros(spec[1], np.float32)
            sel[[0, 2]] = 1.0
            out[nm] = sel
    # planted ties for the ordering layers (ArgMax, MAX pooling)
    out["data"].reshape(-1)[:6] = 0.5
    return out


def _random_params(jnet, rng):
    """Seeded numpy values over the JAX net's params: positive variances,
    scale factors and slopes, everything else centred."""
    params = {}
    for name, entry in jnet.params.items():
        params[name] = {}
        for k, v in entry.items():
            shape = np.shape(v)
            if k in ("var", "scale_factor"):
                a = 0.5 + rng.rand(*shape)
            elif k == "slopes":
                a = 0.1 + 0.3 * rng.rand(*shape)
            elif k == "w" and len(shape) == 4:
                a = rng.randn(*shape) * 0.3
            else:
                a = rng.randn(*shape)
            params[name][k] = a.astype(np.float32)
    return params


def _nhwc(a):
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1)) if a.ndim == 4 else a


def _ulp(mag, dtype):
    mag = np.maximum(np.abs(mag), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - (7 if dtype == "bf16" else 23))


def _steps(got, want, dtype):
    """The largest |got - want| in units in the last place of `dtype`: for
    bf16 at each element's magnitude (a step of the stream), for f32 at the
    output's largest magnitude (sums and fused products that cancel are
    exact to that scale, not to their tiny results). 0 where equal, NaN
    where NaN."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    if same.all():
        return 0.0
    ulp = _ulp(want, "bf16") if dtype == "bf16" else _ulp(np.nanmax(np.abs(want)), "f32")
    return float(np.max(np.where(same, 0.0, np.abs(got - want) / ulp)))


def nhwc_flat_to_nchw(idx, shape):
    """A flat index into an (N, C, H, W) item taken in NHWC order (the JAX
    package's ArgMax without an axis) -> the same element's NCHW index."""
    _, c, h, w = shape
    idx = idx.astype(np.int64)
    return ((idx % c) * h * w + (idx // c)).astype(np.float32)


def run_both(inputs, body, n_tops, mode, seed=0):
    """(port outputs, JAX outputs) of the one-layer net, NCHW numpy."""
    proto = _prototxt(inputs, body, n_tops)
    rng = np.random.RandomState(seed)
    cdt = (jnp.bfloat16, torch.bfloat16) if mode == "bf16" else (None, None)
    jnet = JNet(j_tf.parse(proto), phase="TEST", compute_dtype=cdt[0])
    params = _random_params(jnet, rng)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    tnet = TNet(t_tf.parse(proto), phase="TEST", compute_dtype=cdt[1], device="cpu",
                weights=graph_params_from_numpy(params, jnet.layer_types()))
    xs = _inputs(inputs, rng)
    outs = [f"out{i}" for i in range(n_tops)]
    if mode == "f32":
        want, got = jnet.forward(**xs), tnet.forward(**xs)
        return [got[o] for o in outs], [want[o] for o in outs]
    jf = jax.jit(jnet.make_forward(outs))(jnet.params, {k: jnp.asarray(_nhwc(v)) for k, v in xs.items()})
    tf = tnet.make_forward(outs)(tnet.params, {k: torch.from_numpy(v) for k, v in xs.items()})
    want = [np.asarray(jf[o]) for o in outs]
    want = [w.transpose(0, 3, 1, 2) if w.ndim == 4 else w for w in want]
    return [tf[o].numpy() for o in outs], want


def _flat_argmax_in_nchw(want, shape):
    """The JAX package's ArgMax without an axis reports flat indices in its
    NHWC order; Caffe's (argmax_layer.cpp) and the port's are NCHW."""
    want = want.copy()
    want[:, 0] = nhwc_flat_to_nchw(want[:, 0], shape)
    return want


def test_every_forward_layer_type_has_a_case():
    covered = {body.split('"')[1] for _, _, body, *_ in CASES}
    assert covered == set(registered_types()) and len(covered) == 37


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("entry", CASES, ids=[c[0] for c in CASES])
def test_layer_matches_jax(entry, mode):
    cid, inputs, body, f32_ulps, bf16_ulps, n_tops = _case(entry)
    got, want = run_both(inputs, body, n_tops, mode)
    if cid.startswith("ArgMax-flat"):
        want = [_flat_argmax_in_nchw(w, inputs["data"]) for w in want]
    tol = f32_ulps if mode == "f32" else bf16_ulps
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.isfinite(w).all() or "Log" in cid
        steps = _steps(g, w, "bf16" if mode == "bf16" else "f32")
        assert steps <= tol, f"{cid} {mode} top {i}: {steps} ulps (held to {tol})"


@pytest.mark.parametrize("body", ['type: "SoftmaxWithLoss"', 'type: "Accuracy"',
                                  'type: "Python"', 'type: "EuclideanLoss"'])
def test_training_slice_layers_raise(body):
    proto = _prototxt({"data": (2, 3), "label": (2,)}, body, 1)
    with pytest.raises(NotImplementedError, match="training slice"):
        TNet(t_tf.parse(proto), device="cpu")


PIN_PROTO = """
name: "pin"
input: "data" input_shape { dim: 2 dim: 4 dim: 8 dim: 8 }
layer { name: "c" type: "Convolution" bottom: "data" top: "c"
        convolution_param { num_output: 6 kernel_size: 3 pad: 1 } }
layer { name: "c2" type: "Convolution" bottom: "data" top: "c2"
        convolution_param { num_output: 6 kernel_size: 1 } }
layer { name: "sc" type: "Scale" bottom: "c" top: "s" scale_param { bias_term: true } }
layer { name: "sum" type: "Eltwise" bottom: "c" bottom: "c2" top: "e" }
layer { name: "relu" type: "ReLU" bottom: "c2" top: "r" }
"""


def _bf16_valued(a):
    a = np.array(a, np.float32)
    return np.array_equal(a, torch.from_numpy(a).to(torch.bfloat16).float().numpy())


def test_xla_leaves_the_last_bf16_op_unrounded():
    """The JAX package's jitted make_forward after a conv: the Scale's and
    the Eltwise's outputs are NOT bf16 values (XLA:CPU leaves the last bf16
    op before astype(f32) unrounded), the ReLU's and the conv's are. The
    port rounds every op of the stream, so its outputs are all bf16 values,
    within half a step of the JAX package's."""
    rng = np.random.RandomState(3)
    jnet = JNet(j_tf.parse(PIN_PROTO), phase="TEST")
    params = _random_params(jnet, rng)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    tnet = TNet(t_tf.parse(PIN_PROTO), device="cpu",
                weights=graph_params_from_numpy(params, jnet.layer_types()))
    x = (rng.randn(2, 4, 8, 8) * 2).astype(np.float32)
    outs = ["c", "s", "e", "r"]
    jo = jax.jit(jnet.make_forward(outs))(jnet.params, {"data": jnp.asarray(_nhwc(x))})
    to = tnet.make_forward(outs)(tnet.params, {"data": torch.from_numpy(x)})
    want = {k: np.asarray(jo[k]).transpose(0, 3, 1, 2) for k in outs}
    assert [_bf16_valued(want[k]) for k in outs] == [True, False, False, True]
    for k in outs:
        assert _bf16_valued(to[k].numpy()), k
        assert _steps(to[k].numpy(), want[k], "bf16") <= (0 if k in ("c", "r") else 0.5), k
