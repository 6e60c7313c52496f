"""Whole nets through the port's graph engine (`deepcut_tpu_torch.core.graph`)
against the JAX package's (`deepcut_tpu.core.graph`), on the CPU.

Four nets: a narrow CaffeNet-like prototxt (grouped conv, LRN, MAX and
AVE pools, InnerProduct, Dropout, Softmax), a few-block DeeperCut written by
`models.prototxt.deepercut_deploy` (conv, BatchNorm, Scale, Eltwise, dilated
conv, Deconvolution, Crop, Sigmoid), a legacy V1 prototxt and two
rectangular-kernel convs (1x3, then 3x1 strided and dilated). Both packages
get the same seeded numpy params (fan-in scaled, BN statistics away from the
identity), carried across by `models.convert.graph_params_from_numpy`, and
the same seeded numpy inputs.

Tolerances, with their reasons (units as tests/test_torch_layers.py: f32
ulps at the output's largest magnitude; bf16 steps at each element's):
- f32 `forward` (``compute_dtype=None``): every blob within 64 ulps. Each
  conv and matmul sums in another order (oneDNN against XLA), a few ulps a
  layer, compounding over the layers;
- `forward` with bf16 operands (f32 blobs): every blob within 2**-6 of its
  largest magnitude. A last-bit difference of an f32 sum can move the bf16
  rounding of the next layer's operand by a whole bf16 step (2**-8), and
  such steps compound over the layers;
- the serving chain on the JAX package's folded (and quantized) params:
  every output within 0.5 bf16 step, 2 for a Sigmoid's. The port rounds
  every op of the bf16 stream, XLA:CPU leaves the last op before the f32
  output unrounded (tests/test_torch_layers.py pins it); Sigmoid as there;
- `fold_bn`'s params: 2 f32 ulps (rsqrt is each library's own);
- quantize_int8: activation scales rtol 1e-5 (the calibration convs sum in
  another order; absmax and the percentile pick the same element); the
  int8 weights, their scales, and the quantized forward on a shared
  quantization as the serving chain;
- `.caffemodel` round trips: none (the bytes carry the same f32 values).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepcut_tpu.core.graph import Net as JNet
from deepcut_tpu.proto import text_format as j_tf
from deepcut_tpu.proto.caffemodel import save_caffemodel as j_save_caffemodel
from deepcut_tpu_torch import compat
from deepcut_tpu_torch.core.graph import Net as TNet
from deepcut_tpu_torch.models import resnet as tr
from deepcut_tpu_torch.models.convert import graph_params_from_numpy, graph_params_to_numpy
from deepcut_tpu_torch.models.prototxt import deepercut_deploy
from deepcut_tpu_torch.proto import text_format as t_tf
from test_torch_layers import _nhwc, _steps

CAFFENET = """
name: "NarrowCaffeNet"
input: "data"
input_shape { dim: 2 dim: 3 dim: 43 dim: 43 }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
        convolution_param { num_output: 8 kernel_size: 5 stride: 2 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
        pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "norm1" type: "LRN" bottom: "pool1" top: "norm1"
        lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "conv2" type: "Convolution" bottom: "norm1" top: "conv2"
        convolution_param { num_output: 16 pad: 2 kernel_size: 5 group: 2 } }
layer { name: "relu2" type: "ReLU" bottom: "conv2" top: "conv2" }
layer { name: "conv3" type: "Convolution" bottom: "conv2" top: "conv3"
        convolution_param { num_output: 16 pad: 1 kernel_size: 3 } }
layer { name: "relu3" type: "ReLU" bottom: "conv3" top: "conv3" }
layer { name: "pool2" type: "Pooling" bottom: "conv3" top: "pool2"
        pooling_param { pool: AVE kernel_size: 3 stride: 2 pad: 1 } }
layer { name: "fc6" type: "InnerProduct" bottom: "pool2" top: "fc6"
        inner_product_param { num_output: 32 } }
layer { name: "relu6" type: "ReLU" bottom: "fc6" top: "fc6" }
layer { name: "drop6" type: "Dropout" bottom: "fc6" top: "fc6" dropout_param { dropout_ratio: 0.5 } }
layer { name: "fc8" type: "InnerProduct" bottom: "fc6" top: "fc8"
        inner_product_param { num_output: 8 } }
layer { name: "prob" type: "Softmax" bottom: "fc8" top: "prob" }
"""

LEGACY_V1 = """
name: "LegacyV1"
input: "data"
input_dim: 2 input_dim: 4 input_dim: 12 input_dim: 12
layers { name: "conv" type: CONVOLUTION bottom: "data" top: "conv" blobs_lr: 1 blobs_lr: 2
         weight_decay: 1 weight_decay: 0
         convolution_param { num_output: 8 kernel_size: 3 pad: 1 } }
layers { name: "relu" type: RELU bottom: "conv" top: "conv" }
layers { name: "pool" type: POOLING bottom: "conv" top: "pool"
         pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layers { name: "ip" type: INNER_PRODUCT bottom: "pool" top: "ip"
         inner_product_param { num_output: 6 } }
layers { name: "sig" type: SIGMOID bottom: "ip" top: "sig" }
"""

RECT = """
name: "Rect"
input: "data"
input_shape { dim: 2 dim: 8 dim: 12 dim: 14 }
layer { name: "conv1x3" type: "Convolution" bottom: "data" top: "a"
        convolution_param { num_output: 16 kernel_h: 1 kernel_w: 3 pad: 1 } }
layer { name: "relu_a" type: "ReLU" bottom: "a" top: "a" }
layer { name: "conv3x1" type: "Convolution" bottom: "a" top: "b"
        convolution_param { num_output: 8 kernel_h: 3 kernel_w: 1 stride: 2 pad: 2 dilation: 2 } }
layer { name: "sig" type: "Sigmoid" bottom: "b" top: "sig" }
"""

TINY = tr.DeeperCutConfig(depths=(1, 2, 1, 1), stage_widths=(4, 4, 8, 8), num_joints=3)
DEEPERCUT = deepercut_deploy(TINY, (2, 3, 40, 48)).to_proto_text()
NETS = {"caffenet": CAFFENET, "deepercut": DEEPERCUT, "legacy_v1": LEGACY_V1, "rect": RECT}
SIGMOIDS = ("prob", "sig")  # the nets' Sigmoid outputs
SERVING_OUTPUTS = {"caffenet": ["prob"], "deepercut": ["fc_pose", "loc_pred", "prob"],
                   "legacy_v1": ["sig"], "rect": ["sig"]}


def tame_params(jnet, seed=0):
    """Seeded numpy params in the JAX layouts: fan-in scaled weights, BN
    statistics and Scale away from the identity, small biases."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, entry in jnet.params.items():
        out[name] = {}
        for k, v in entry.items():
            shape = np.shape(v)
            if k == "w":
                fan_in = np.prod(shape[:3]) if len(shape) == 4 else shape[1]
                a = rng.randn(*shape) * (1.0 / fan_in) ** 0.5
            elif k == "var":
                a = 1 + 0.3 * rng.rand(*shape)
            elif k == "scale_factor":
                a = 0.5 + rng.rand(*shape)
            elif k == "gamma":
                a = 1 + 0.3 * rng.randn(*shape)
            else:
                a = 0.1 * rng.randn(*shape)
            out[name][k] = a.astype(np.float32)
    return out


def build(which, cdt="f32", seed=0):
    """(JAX net, port net, numpy params, input) sharing params and input."""
    text = NETS[which]
    jnet = JNet(j_tf.parse(text), phase="TEST", compute_dtype=None if cdt == "f32" else jnp.bfloat16)
    params = tame_params(jnet, seed)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    tnet = TNet(t_tf.parse(text), phase="TEST", device="cpu",
                compute_dtype=None if cdt == "f32" else torch.bfloat16,
                weights=graph_params_from_numpy(params, jnet.layer_types()))
    shape = next(iter(jnet.input_shapes.values()))
    x = (np.random.RandomState(seed + 1).randn(*shape) * 2).astype(np.float32)
    return jnet, tnet, params, x


def _jax_serve(jnet, outputs, x):
    out = jax.jit(jnet.make_forward(outputs))(jnet.params, {"data": jnp.asarray(_nhwc(x))})
    return {k: (np.asarray(v).transpose(0, 3, 1, 2) if np.ndim(v) == 4 else np.asarray(v))
            for k, v in out.items()}


def _port_serve(tnet, outputs, x):
    out = tnet.make_forward(outputs)(tnet.params, {"data": torch.from_numpy(x)})
    return {k: v.numpy() for k, v in out.items()}


def _carry(jnet, tnet):
    """The JAX net's current params into the port's net."""
    tnet.params = graph_params_from_numpy(jax.tree_util.tree_map(np.asarray, jnet.params),
                                          jnet.layer_types())


# -- construction ----------------------------------------------------------------
FILTER_PROTO = """
name: "rules"
state { stage: "deploy" }
input: "data" input_shape { dim: 1 dim: 2 dim: 4 dim: 4 }
layer { name: "always" type: "ReLU" bottom: "data" top: "a" }
layer { name: "train_only" type: "ReLU" bottom: "data" top: "b" include { phase: TRAIN } }
layer { name: "test_only" type: "ReLU" bottom: "data" top: "c" include { phase: TEST } }
layer { name: "not_test" type: "ReLU" bottom: "data" top: "d" exclude { phase: TEST } }
layer { name: "stage_deploy" type: "ReLU" bottom: "data" top: "e" include { stage: "deploy" } }
layer { name: "stage_x" type: "ReLU" bottom: "data" top: "f" include { stage: "x" } }
layer { name: "not_stage_x" type: "ReLU" bottom: "data" top: "g" include { not_stage: "x" } }
layer { name: "level_2" type: "ReLU" bottom: "data" top: "h" include { min_level: 2 } }
layer { name: "level_le_1" type: "ReLU" bottom: "data" top: "i" include { max_level: 1 } }
layer { name: "either" type: "ReLU" bottom: "data" top: "j"
        include { phase: TRAIN } include { stage: "x" } }
"""


@pytest.mark.parametrize("phase,stages,level", [
    ("TEST", (), None), ("TRAIN", (), None), ("TEST", ("x",), None), ("TEST", (), 2),
    ("TRAIN", ("x",), 0), ("TEST", ("x", "y"), 1)])
def test_filtering_matches_jax(phase, stages, level):
    kw = dict(phase=phase, stages=stages, level=level)
    jnet = JNet(j_tf.parse(FILTER_PROTO), compute_dtype=None, **kw)
    tnet = TNet(t_tf.parse(FILTER_PROTO), compute_dtype=None, device="cpu", **kw)
    assert [s.name for s in tnet.layer_specs] == [s.name for s in jnet.layer_specs]
    assert tnet.output_names() == jnet.output_names()


@pytest.mark.parametrize("which", list(NETS))
def test_construction_matches_jax(which):
    jnet, tnet, params, _ = build(which)
    assert tnet.layer_types() == jnet.layer_types()
    assert tnet.input_shapes == jnet.input_shapes
    assert tnet.output_names() == jnet.output_names()
    assert tnet.deconv_names() == jnet.deconv_names()
    shapes = {n: {k: tuple(v.shape) for k, v in e.items()} for n, e in tnet.params.items()}
    want = graph_params_from_numpy(params, jnet.layer_types())
    assert shapes == {n: {k: tuple(v.shape) for k, v in e.items()} for n, e in want.items()}


def _v0_text():
    from test_legacy_and_tools import V0_TEXT_NET  # the JAX package's V0 fixture

    return V0_TEXT_NET


@pytest.mark.parametrize("source", ["v0", "v1", "examples/imagenet/caffenet_train_val.prototxt",
                                    "examples/pose/pose_train.prototxt"])
def test_upgrade_matches_jax(source):
    """The port's copy of `proto.upgrade` against the original: V0 (padding
    layers folded, types and fields moved), V1 and current nets."""
    from pathlib import Path

    from deepcut_tpu.proto.upgrade import upgrade_net as j_upgrade
    from deepcut_tpu_torch.proto.upgrade import is_v0_net, upgrade_net as t_upgrade

    text = {"v0": _v0_text, "v1": lambda: LEGACY_V1}.get(
        source, lambda: (Path(__file__).resolve().parents[1] / source).read_text())()
    assert is_v0_net(t_tf.parse(text)) == (source == "v0")
    assert t_tf.dump(t_upgrade(t_tf.parse(text))) == j_tf.dump(j_upgrade(j_tf.parse(text)))


def test_upgrade_solver_matches_jax():
    from deepcut_tpu.proto.upgrade import upgrade_solver as j_up
    from deepcut_tpu_torch.proto.upgrade import upgrade_solver as t_up

    for text in ("base_lr: 0.01\nsolver_type: NESTEROV\n", "solver_type: 4\n", "type: \"Adam\"\n"):
        assert t_tf.dump(t_up(t_tf.parse(text))) == j_tf.dump(j_up(j_tf.parse(text)))


def test_v0_net_runs_as_jax():
    """The V0 text net (its loss layer, of the training slice, cut) through
    both packages' forward."""
    text = _v0_text().split("layers {\n  layer { name: \"loss\"")[0] + _v0_text().split(
        "top: \"loss\"\n}")[1]
    x = np.random.RandomState(0).randn(2, 3, 14, 14).astype(np.float32)
    jnet = JNet(j_tf.parse(text), compute_dtype=None)
    params = tame_params(jnet)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    tnet = TNet(t_tf.parse(text), compute_dtype=None, device="cpu",
                weights=graph_params_from_numpy(params, jnet.layer_types()))
    label = np.zeros((2, 1, 1, 1), np.float32)
    want, got = jnet.forward(data=x, label=label), tnet.forward(data=x, label=label)
    assert got["pool1"].shape == (2, 4, 6, 6)
    for k in ("conv2", "pool1", "ip"):
        assert _steps(got[k], want[k], "f32") <= 64, k


# -- forward -----------------------------------------------------------------------
@pytest.mark.parametrize("cdt", ["f32", "bf16"])
@pytest.mark.parametrize("which", list(NETS))
def test_forward_matches_jax(which, cdt):
    jnet, tnet, _, x = build(which, cdt)
    want, got = jnet.forward(data=x), tnet.forward(data=x)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if cdt == "f32":
            assert _steps(got[k], want[k], "f32") <= 64, k
        else:
            scale = np.abs(want[k]).max()
            assert np.abs(got[k] - want[k]).max() <= 2.0 ** -6 * scale, k
    assert set(tnet.blobs) == set(want)


def test_partial_forward_matches_jax():
    jnet, tnet, _, x = build("caffenet")
    jnet.forward(data=x)
    tnet.forward(data=x)
    want = jnet.forward(start="conv3", end="fc6")
    got = tnet.forward(start="conv3", end="fc6")
    assert set(got) == set(want)
    for k in want:
        assert _steps(got[k], want[k], "f32") <= 64, k


def test_debug_info_matches_jax():
    jnet, tnet, _, x = build("legacy_v1")
    want, got = jnet.debug_info(data=x), tnet.debug_info(data=x)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 1e-6), k


# -- the serving chain ---------------------------------------------------------------
@pytest.mark.parametrize("which", list(NETS))
def test_serving_chain_matches_jax(which):
    """fold_bn -> prune -> fuse_siblings -> cast_weights -> make_forward,
    each transform's counts and params against the JAX package's; the
    outputs on the JAX package's transformed params."""
    jnet, tnet, _, x = build(which, "bf16")
    outs = SERVING_OUTPUTS[which]
    assert tnet.fold_bn() == jnet.fold_bn()
    folded = graph_params_from_numpy(jax.tree_util.tree_map(np.asarray, jnet.params),
                                     jnet.layer_types())
    assert set(tnet.params) == set(folded)
    for name, entry in folded.items():
        for k, v in entry.items():
            assert _steps(tnet.params[name][k].numpy(), v.numpy(), "f32") <= 2, (name, k)
    assert tnet.prune(outs) == jnet.prune(outs)
    assert tnet.fuse_siblings() == jnet.fuse_siblings()
    assert [s.name for _, s in tnet._plan] == [s.name for _, s in jnet._plan]
    assert [s.tops for _, s in tnet._plan] == [s.tops for _, s in jnet._plan]
    tnet.cast_weights()
    jnet.cast_weights()
    assert {n: {k: v.dtype for k, v in e.items()} for n, e in tnet.params.items()} == {
        n: {k: (torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
            for k, v in e.items()} for n, e in jnet.params.items()}
    own = _port_serve(tnet, outs, x)
    _carry(jnet, tnet)
    got, want = _port_serve(tnet, outs, x), _jax_serve(jnet, outs, x)
    for k in outs:
        assert _steps(got[k], want[k], "bf16") <= (2 if k in SIGMOIDS else 0.5), k
        # the port's own transforms: the same up to the folded weights' last bits
        assert np.abs(own[k] - got[k]).max() <= 2.0 ** -6 * np.abs(got[k]).max(), k


def test_in_place_weight_edit_reaches_the_forward():
    """Net surgery in place on `params` (the same tensors, new values): the
    next `make_forward` call and `forward` run the new weights, not the
    weights prepared before the edit."""
    _, tnet, _, x = build("caffenet", "bf16")
    fwd = tnet.make_forward(["prob"])
    before = fwd(tnet.params, {"data": torch.from_numpy(x)})["prob"]
    tnet.forward(data=x)
    tnet.params["fc8"]["w"].zero_()
    tnet.params["fc8"]["b"][...] = torch.arange(8, dtype=torch.float32) / 4
    want = torch.softmax(torch.arange(8, dtype=torch.float32) / 4, 0).expand(2, 8).numpy()
    got = fwd(tnet.params, {"data": torch.from_numpy(x)})["prob"]
    assert not np.allclose(before.numpy(), want, atol=1e-2)
    np.testing.assert_allclose(got.numpy(), want, atol=2.0 ** -7)  # bf16 stream
    np.testing.assert_allclose(tnet.forward(data=x)["prob"], want, rtol=1e-6)


def test_make_forward_f32_net_matches_forward():
    """compute_dtype=None: make_forward runs the f32 layers of forward."""
    _, tnet, _, x = build("caffenet", "f32")
    ref = tnet.forward(data=x)["prob"]
    got = _port_serve(tnet, ["prob"], x)["prob"]
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="compute_dtype=None"):
        tnet.cast_weights()


def test_graph_equals_native_model():
    """The DeeperCut prototxt through the serving chain against the port's
    native `DeeperCut` bf16 forward of the same weights: the heads' maps
    bit-equal (both round each conv's f32 bias once and add in bf16); prob
    is the graph's bf16 Sigmoid against the native f32 sigmoid of the same
    logits, one bf16 rounding apart."""
    cfg = TINY
    jnet, tnet, params, x = build("deepercut", "bf16")
    native = graph_params_from_numpy(params, jnet.layer_types())
    tnet.fold_bn()
    tnet.prune(["fc_pose", "loc_pred", "prob"])
    tnet.fuse_siblings()
    tnet.cast_weights()
    got = _port_serve(tnet, ["fc_pose", "loc_pred", "prob"], x)
    model = tr.DeeperCut(tr.fold_bn(native, cfg), cfg)
    with torch.inference_mode():
        want = model(torch.from_numpy(x), heads=("pose", "locref"))
    for k in ("fc_pose", "loc_pred"):
        np.testing.assert_array_equal(got[k], want[k].numpy(), err_msg=k)
    assert _steps(got["prob"], want["prob"].numpy(), "bf16") <= 0.5


# -- int8 --------------------------------------------------------------------------
@pytest.mark.parametrize("percentile", [100.0, 99.0])
@pytest.mark.parametrize("which", ["caffenet", "deepercut", "rect"])
def test_quantize_int8_matches_jax(which, percentile):
    jnet, tnet, _, x = build(which, "bf16")
    outs = SERVING_OUTPUTS[which]
    for net in (jnet, tnet):
        net.fold_bn()
        net.prune(outs)
        net.fuse_siblings()
    n = tnet.quantize_int8(percentile=percentile, data=x)
    assert n == jnet.quantize_int8(percentile=percentile, data=x) and n >= 1
    jq = graph_params_from_numpy(jax.tree_util.tree_map(np.asarray, jnet.params),
                                 jnet.layer_types())
    quantized = [name for name, e in jq.items() if "w_q" in e]
    assert sorted(quantized) == sorted(name for name, e in tnet.params.items() if "w_q" in e)
    for name in quantized:
        np.testing.assert_allclose(float(tnet.params[name]["act_scale"]),
                                   float(jq[name]["act_scale"]), rtol=1e-5, err_msg=name)
    # the same quantization on both sides: weights, scales and outputs
    _carry(jnet, tnet)
    for net in (jnet, tnet):
        net.cast_weights()
    got, want = _port_serve(tnet, outs, x), _jax_serve(jnet, outs, x)
    for k in outs:
        assert _steps(got[k], want[k], "bf16") <= (2 if k in SIGMOIDS else 0.5), k


def test_quantize_int8_weights_match_jax():
    jnet, tnet, _, x = build("deepercut", "bf16")
    for net in (jnet, tnet):
        net.fold_bn()
    _carry(jnet, tnet)  # the same folded weights
    tnet.quantize_int8(data=x)
    jnet.quantize_int8(data=x)
    jq = graph_params_from_numpy(jax.tree_util.tree_map(np.asarray, jnet.params),
                                 jnet.layer_types())
    for name, e in jq.items():
        if "w_q" in e:
            np.testing.assert_array_equal(tnet.params[name]["w_q"].numpy(), e["w_q"].numpy())
            np.testing.assert_array_equal(tnet.params[name]["w_scale"].numpy(), e["w_scale"].numpy())
            np.testing.assert_array_equal(tnet.params[name]["b"].numpy(), e["b"].numpy())


def test_quantize_int8_min_in_channels_and_forward():
    """The stem (3 input channels) stays float; the f32 `forward` of the
    quantized net runs its int8 convs without the bf16 rounding."""
    _, tnet, _, x = build("caffenet", "bf16")
    ref = tnet.forward(data=x)["prob"]
    assert tnet.quantize_int8(data=x) == 1  # conv3: conv1 has 3 inputs, conv2 is grouped
    assert "w" in tnet.params["conv1"] and "w_q" in tnet.params["conv3"]
    got = tnet.forward(data=x)["prob"]
    assert np.abs(got - ref).max() < 0.02


# -- weights files --------------------------------------------------------------------
@pytest.mark.parametrize("which", list(NETS))
def test_caffemodel_round_trip_with_jax(which, tmp_path):
    """A .caffemodel written by the JAX package loads into the port's Net
    with identical params; the port's compat.Net.save loads back into the
    JAX package's Net identically."""
    jnet, _, params, _ = build(which)
    path = str(tmp_path / "j.caffemodel")
    j_save_caffemodel(path, params, deconv_names=jnet.deconv_names())
    tnet = TNet(t_tf.parse(NETS[which]), weights=path, compute_dtype=None, device="cpu")
    want = graph_params_from_numpy(params, jnet.layer_types())
    for name, entry in want.items():
        for k, v in entry.items():
            np.testing.assert_array_equal(tnet.params[name][k].numpy(), v.numpy(), err_msg=name)
    back = str(tmp_path / "t.caffemodel")
    cnet = compat.Net.__new__(compat.Net)
    cnet._net = tnet
    cnet.save(back)
    jback = JNet(j_tf.parse(NETS[which]), weights=back, compute_dtype=None)
    for name, entry in params.items():
        for k, v in entry.items():
            np.testing.assert_array_equal(np.asarray(jback.params[name][k]), v, err_msg=name)
    np.testing.assert_array_equal(
        graph_params_to_numpy(tnet.params, tnet.layer_types())[name][k], params[name][k])


def test_load_weights_checks_shapes(tmp_path):
    jnet, tnet, params, _ = build("legacy_v1")
    bad = {"conv": {"w": np.zeros((8, 4, 5, 5), np.float32)}}
    with pytest.raises(ValueError, match="shape"):
        tnet.load_weights(bad)


def test_fillers_statistics():
    """Each filler by its statistics: the mean and standard deviation the
    JAX package's definition gives (its fans, `deepcut_tpu.core.fillers._fans`,
    on its HWIO layout of the same blob), on a conv, a deconv and an
    InnerProduct blob; the random streams differ. 5% of the standard
    deviation (each blob has >= 18432 draws: the sampling error is < 1%)."""
    from deepcut_tpu.core import fillers as jf
    from deepcut_tpu_torch.core import fillers as tf

    gen = torch.Generator().manual_seed(0)
    cases = [('type: "xavier"', (64, 32, 3, 3), False),
             ('type: "msra"', (64, 32, 3, 3), False),
             ('type: "msra" variance_norm: FAN_OUT', (32, 16, 4, 4), True),
             ('type: "xavier" variance_norm: AVERAGE', (200, 300), False),
             ('type: "gaussian" std: 0.5 mean: 1', (200, 300), False),
             ('type: "uniform" min: -2 max: 3', (200, 300), False)]
    for text, shape, deconv in cases:
        node = t_tf.parse(text)
        t = tf.fill(node, gen, shape, deconv=deconv).numpy()
        assert t.shape == shape
        jshape = ((shape[2], shape[3], shape[0], shape[1]) if deconv else
                  (shape[2], shape[3], shape[1], shape[0]) if len(shape) == 4 else shape)
        fan_in, fan_out = jf._fans(jshape)
        n = {"FAN_IN": fan_in, "FAN_OUT": fan_out, "AVERAGE": (fan_in + fan_out) / 2}[
            node.get_str("variance_norm", "FAN_IN")]
        mean, std = {"xavier": (0.0, (1.0 / n) ** 0.5), "msra": (0.0, (2.0 / n) ** 0.5),
                     "gaussian": (1.0, 0.5), "uniform": (0.5, 5 / 12 ** 0.5)}[node.get_str("type")]
        assert abs(t.mean() - mean) < 0.05 * std, text
        assert abs(t.std() / std - 1) < 0.05, text
    sparse = tf.fill(t_tf.parse('type: "gaussian" sparse: 8'), gen, (64, 32, 3, 3)).numpy()
    assert abs((sparse != 0).mean() - 8 / 64) < 0.02
    ball = tf.fill(t_tf.parse('type: "positive_unitball"'), gen, (6, 4, 3, 3)).numpy()
    np.testing.assert_allclose(ball.sum(axis=(1, 2, 3)), 1.0, rtol=1e-5)
    bil = tf.fill(t_tf.parse('type: "bilinear"'), gen, (3, 3, 4, 4), deconv=True).numpy()
    jbil = np.asarray(jf.fill(j_tf.parse('type: "bilinear"'), None, (4, 4, 3, 3)))
    np.testing.assert_array_equal(bil, jbil.transpose(2, 3, 0, 1))
    const = tf.fill(t_tf.parse('type: "constant" value: 0.25'), gen, (5,)).numpy()
    np.testing.assert_array_equal(const, np.full(5, 0.25, np.float32))
