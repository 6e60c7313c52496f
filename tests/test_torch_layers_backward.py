"""Each layer family's backward in the port's graph engine
(`deepcut_tpu_torch.core`) against the JAX package's, on the CPU: the port's
counterpart of tests/test_gradient_check.py, which holds the JAX package's
layers against finite differences.

Every case is a one-layer net built by both packages' `Net` from the same
prototxt, with the same seeded numpy params (carried across by
`models.convert.graph_params_from_numpy`) and inputs (tests/test_torch_layers.py's
helpers, which plant ties among the first elements for the ordering layers).
Three readings per case:

- the tops of the forward that the backward differentiates (BatchNorm's in
  TRAIN, which tests/test_torch_layers.py does not run);
- the input diffs: a seeded cotangent injected at every top,
  ``Net.backward(cotangents=...)`` on both sides (autograd against
  `jax.grad`); MAX pooling and Eltwise MAX get planted ties (the first-max
  backward; at an Eltwise tie both packages split the gradient evenly);
- for the learned layers (Convolution, Deconvolution, InnerProduct, PReLU,
  Scale, Bias, BatchNorm) the param diffs through a weighted EuclideanLoss
  on the top: the gradient of each package's own total loss over its
  executed plan (what its `make_train_step` differentiates), in the JAX
  package's layouts. BatchNorm runs in TRAIN (batch statistics), where its
  statistics get no gradient in either package.

Tolerance: 16 f32 ulps at each diff's largest magnitude, the rule of
tests/test_torch_engine_losses.py. The sums run in another order (oneDNN and
PyTorch against XLA) and the transcendental functions are each library's
own, a few ulps each; the normalisations (LRN, MVN, Softmax, BatchNorm)
compound them through their backward. A scalar top (Reduction over every
axis) is held absolutely, at 16 ulps of its bottom's largest magnitude:
it is a sum of terms of that size, taken in another order, and cancels to
a smaller result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcut_tpu.core.graph import Net as JNet
from deepcut_tpu.proto import text_format as j_tf
from deepcut_tpu_torch.core.graph import Net as TNet
from deepcut_tpu_torch.models.convert import graph_params_from_numpy, graph_params_to_numpy
from deepcut_tpu_torch.proto import text_format as t_tf
from test_torch_layers import _inputs, _nhwc, _prototxt, _random_params, _steps

ULPS = 16
X = (2, 3, 5, 6)  # N, C, H, W

# (case id, inputs {name: shape or ("abs", shape)}, layer body, phase, tops)
CASES = [
    ("Convolution-dilated", {"data": X},
     'type: "Convolution" convolution_param { num_output: 4 kernel_size: 3 pad: 2 dilation: 2 }'),
    ("Convolution-grouped-strided", {"data": (2, 4, 5, 6)},
     'type: "Convolution" convolution_param { num_output: 6 kernel_size: 3 stride: 2 pad: 1 '
     'group: 2 }'),
    ("Convolution-rect-nobias", {"data": X},
     'type: "Convolution" convolution_param { num_output: 3 kernel_h: 3 kernel_w: 2 '
     'bias_term: false }'),
    ("Deconvolution-4x4-stride2", {"data": X},
     'type: "Deconvolution" convolution_param { num_output: 3 kernel_size: 4 stride: 2 pad: 1 }'),
    ("Deconvolution-grouped", {"data": (2, 4, 5, 6)},
     'type: "Deconvolution" convolution_param { num_output: 4 kernel_size: 3 stride: 2 '
     'group: 2 }'),
    ("Pooling-max-ceil", {"data": X},
     'type: "Pooling" pooling_param { pool: MAX kernel_size: 3 stride: 2 }'),
    ("Pooling-max-padded-rect", {"data": X},
     'type: "Pooling" pooling_param { pool: MAX kernel_h: 3 kernel_w: 2 stride_h: 2 stride_w: 3 '
     'pad_h: 1 pad_w: 1 }'),
    ("Pooling-ave-padded-ceil", {"data": X},
     'type: "Pooling" pooling_param { pool: AVE kernel_size: 3 stride: 2 pad: 1 }'),
    ("Pooling-global-ave", {"data": X},
     'type: "Pooling" pooling_param { pool: AVE global_pooling: true }'),
    ("Pooling-global-max", {"data": X},
     'type: "Pooling" pooling_param { pool: MAX global_pooling: true }'),
    ("LRN-across", {"data": X}, 'type: "LRN" lrn_param { local_size: 3 alpha: 0.5 beta: 0.75 k: 2 }'),
    ("LRN-within", {"data": X},
     'type: "LRN" lrn_param { local_size: 3 alpha: 0.5 beta: 0.75 norm_region: WITHIN_CHANNEL }'),
    ("MVN", {"data": X}, 'type: "MVN"'),
    ("MVN-across-channels", {"data": X}, 'type: "MVN" mvn_param { across_channels: true }'),
    ("MVN-mean-only", {"data": X}, 'type: "MVN" mvn_param { normalize_variance: false }'),
    ("ReLU-leaky", {"data": X}, 'type: "ReLU" relu_param { negative_slope: 0.1 }'),
    ("PReLU", {"data": X}, 'type: "PReLU"'),
    ("PReLU-shared", {"data": X}, 'type: "PReLU" prelu_param { channel_shared: true }'),
    ("ELU", {"data": X}, 'type: "ELU" elu_param { alpha: 0.7 }'),
    ("TanH", {"data": X}, 'type: "TanH"'),
    ("Sigmoid", {"data": X}, 'type: "Sigmoid"'),
    ("AbsVal", {"data": X}, 'type: "AbsVal"'),
    ("BNLL", {"data": X}, 'type: "BNLL"'),
    ("Power", {"data": X}, 'type: "Power" power_param { power: 2 scale: 0.5 shift: 1 }'),
    ("Power-fractional", {"data": ("abs", X)}, 'type: "Power" power_param { power: 0.5 shift: 0.25 }'),
    ("Exp", {"data": X}, 'type: "Exp" exp_param { scale: 0.5 shift: 0.1 }'),
    ("Log", {"data": ("abs", X)}, 'type: "Log" log_param { base: 10 scale: 2 shift: 1 }'),
    ("Softmax", {"data": X}, 'type: "Softmax"'),
    ("Softmax-height", {"data": X}, 'type: "Softmax" softmax_param { axis: 2 }'),
    ("Scale-bias", {"data": X}, 'type: "Scale" scale_param { bias_term: true }'),
    ("Scale-two-bottoms", {"data": X, "s": X}, 'type: "Scale" scale_param { bias_term: true }'),
    ("Bias", {"data": X}, 'type: "Bias"'),
    ("Bias-two-bottoms", {"data": X, "s": X}, 'type: "Bias"'),
    ("InnerProduct", {"data": X}, 'type: "InnerProduct" inner_product_param { num_output: 5 }'),
    ("InnerProduct-axis2", {"data": X},
     'type: "InnerProduct" inner_product_param { num_output: 3 axis: 2 }'),
    ("InnerProduct-transpose-nobias", {"data": X},
     'type: "InnerProduct" inner_product_param { num_output: 4 transpose: true bias_term: false }'),
    ("Eltwise-max", {"data": X, "s": X}, 'type: "Eltwise" eltwise_param { operation: MAX }'),
    ("Eltwise-prod", {"data": X, "s": X}, 'type: "Eltwise" eltwise_param { operation: PROD }'),
    ("Eltwise-sum-coeffs", {"data": X, "s": X},
     'type: "Eltwise" eltwise_param { operation: SUM coeff: 0.5 coeff: -1.5 }'),
    ("SPP-max", {"data": X}, 'type: "SPP" spp_param { pyramid_height: 3 }'),
    ("SPP-ave", {"data": X}, 'type: "SPP" spp_param { pyramid_height: 2 pool: AVE }'),
    ("Reduction-sum", {"data": X}, 'type: "Reduction" reduction_param { axis: 1 }'),
    ("Reduction-mean-all", {"data": X},
     'type: "Reduction" reduction_param { operation: MEAN axis: 0 coeff: 2 }'),
    ("Reduction-asum", {"data": X}, 'type: "Reduction" reduction_param { operation: ASUM axis: 2 }'),
    ("Reduction-sumsq", {"data": X},
     'type: "Reduction" reduction_param { operation: SUMSQ axis: 3 coeff: 0.5 }'),
    ("Tile", {"data": X}, 'type: "Tile" tile_param { axis: 1 tiles: 2 }'),
    ("Crop-offsets", {"data": X, "s": (2, 3, 3, 4)},
     'type: "Crop" crop_param { axis: 2 offset: 1 offset: 2 }'),
    ("Concat-channels", {"data": X, "s": (2, 2, 5, 6)}, 'type: "Concat"'),
    ("Slice-points", {"data": X}, 'type: "Slice" slice_param { axis: 1 slice_point: 1 '
     'slice_point: 2 }', "TEST", 3),
    ("Split", {"data": X}, 'type: "Split"', "TEST", 2),
    ("Flatten", {"data": X}, 'type: "Flatten" flatten_param { axis: 1 end_axis: 2 }'),
    ("Reshape", {"data": X},
     'type: "Reshape" reshape_param { shape { dim: 0 dim: -1 dim: 6 } }'),
    ("Im2col", {"data": X}, 'type: "Im2col" convolution_param { kernel_size: 3 stride: 2 pad: 1 }'),
    ("BatchNorm-train", {"data": X}, 'type: "BatchNorm" batch_norm_param { eps: 0.001 }', "TRAIN"),
]

LEARNED = ("Convolution", "Deconvolution", "InnerProduct", "PReLU", "Scale", "Bias", "BatchNorm")
LOSS_WEIGHT = 0.5


def _case(entry):
    cid, inputs, body = entry[:3]
    return cid, inputs, body, (entry[3] if len(entry) > 3 else "TEST"), \
        (entry[4] if len(entry) > 4 else 1)


def _both_nets(proto, phase, params=None, rng=None):
    jnet = JNet(j_tf.parse(proto), phase=phase, compute_dtype=None)
    if params is None:
        params = _random_params(jnet, rng)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    tnet = TNet(t_tf.parse(proto), phase=phase, compute_dtype=None, device="cpu",
                weights=graph_params_from_numpy(params, jnet.layer_types()))
    return jnet, tnet, params


def _case_inputs(cid, inputs, rng):
    xs = _inputs(inputs, rng)
    if cid == "Eltwise-max":            # ties between the two bottoms
        xs["s"].reshape(-1)[:8] = xs["data"].reshape(-1)[:8]
    return xs


def _assert_diff(got, want, what, scalar_scale=None):
    """got within ULPS of want: f32 ulps at want's largest magnitude, or,
    with `scalar_scale`, at that magnitude (a scalar top's summands'). Only a
    top may hold -inf (an SPP bin wholly in the padding), and then the same
    -inf in both."""
    got, want = np.asarray(got), np.asarray(want)
    finite = np.isfinite(want)
    assert np.array_equal(got[~finite], want[~finite]) and (finite.all() or "top" in what), what
    got, want = got[finite], want[finite]
    assert np.abs(want).max() > 0 or not np.abs(got).any(), what
    if scalar_scale is None:
        steps = _steps(got, want, "f32")
    else:
        ulp = np.exp2(np.floor(np.log2(scalar_scale)) - 23)
        steps = float(np.abs(got.astype(np.float64) - want).max() / ulp)
    assert steps <= ULPS, f"{what}: {steps} f32 ulps (held to {ULPS})"


def test_every_family_of_the_gradient_check_has_a_case():
    """The layer types tests/test_gradient_check.py differentiates, but the
    loss layers (tests/test_torch_engine_losses.py holds their gradients),
    each have a backward case here."""
    covered = {body.split('"')[1] for _, _, body, *_ in CASES}
    checked = {"Convolution", "Deconvolution", "Pooling", "InnerProduct", "PReLU", "Scale",
               "Bias", "LRN", "MVN", "TanH", "Sigmoid", "ELU", "AbsVal", "BNLL", "Power", "Exp",
               "Log", "Eltwise", "Crop", "Concat", "Softmax", "SPP", "Reduction", "Tile"}
    assert checked <= covered, sorted(checked - covered)
    assert len(CASES) >= 45


@pytest.mark.parametrize("entry", CASES, ids=[c[0] for c in CASES])
def test_layer_backward_matches_jax(entry):
    cid, inputs, body, phase, n_tops = _case(entry)
    rng = np.random.RandomState(0)
    proto = _prototxt(inputs, body, n_tops)
    jnet, tnet, params = _both_nets(proto, phase, rng=rng)
    xs = _case_inputs(cid, inputs, rng)
    tops, jtops = tnet.forward(**xs), jnet.forward(**xs)
    for i in range(n_tops):
        top = f"out{i}"
        scalar = np.ndim(jtops[top]) == 0
        _assert_diff(tops[top], jtops[top], f"{cid}: top {top}",
                     float(np.abs(xs["data"]).max()) if scalar else None)
    cots = {f"out{i}": np.asarray(rng.randn(*np.shape(tops[f"out{i}"])), np.float32)
            for i in range(n_tops)}
    want = jnet.backward(cotangents=cots, **dict(xs))
    got = tnet.backward(cotangents=cots, **dict(xs))
    assert set(got) == set(want) == set(xs), (sorted(got), sorted(want))
    for nm in xs:
        _assert_diff(got[nm], want[nm], f"{cid}: diff of {nm}")
    assert np.abs(got["data"]).sum() > 0

    if body.split('"')[1] not in LEARNED or not any(params.values()):
        return      # no blobs to learn (a Scale or Bias taking its factor as a bottom has none)
    # param diffs through a weighted EuclideanLoss on the top
    target = rng.randn(*np.shape(tops["out0"])).astype(np.float32)
    lines = proto.split("\n")
    lines.insert(1, 'input: "target" input_shape { '
                 + " ".join(f"dim: {d}" for d in target.shape) + " }")
    lines.append('layer { name: "loss" type: "EuclideanLoss" bottom: "out0" bottom: "target" '
                 f'top: "loss" loss_weight: {LOSS_WEIGHT} }}')
    jnet, tnet, _ = _both_nets("\n".join(lines), phase, params=params)
    xs["target"] = target

    jin = {k: jnp.asarray(_nhwc(v)) for k, v in xs.items()}
    jgrad = jax.grad(lambda p: jnet.total_loss(jnet._execute(p, jin, collect_updates={})))(
        jnet.params)
    leaves, used = tnet._grad_params(tnet.params)
    loss = tnet.total_loss(tnet._execute(used, {k: torch.from_numpy(v) for k, v in xs.items()},
                                         collect_updates={}))
    flat = [(n, k, v) for n, e in leaves.items() for k, v in e.items() if v.requires_grad]
    # BatchNorm's statistics and a two-bottom Bias's unused blob do not reach the loss
    grads = (torch.autograd.grad(loss, [v for *_, v in flat], allow_unused=True)
             if loss.requires_grad else [None] * len(flat))
    tgrad = {n: {} for n in leaves}
    for (n, k, v), g in zip(flat, grads):
        tgrad[n][k] = torch.zeros_like(v) if g is None else g
    tgrad = graph_params_to_numpy(tgrad, tnet.layer_types())
    assert {n: set(e) for n, e in tgrad.items() if e} == \
           {n: set(e) for n, e in jgrad.items() if e}
    for n, entry_ in jgrad.items():
        for k, w in entry_.items():
            _assert_diff(tgrad[n][k], w, f"{cid}: param diff {n}/{k}")
