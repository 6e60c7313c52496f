"""The graph engine's front ends in the port against the JAX package's, on
the CPU: `io` (Transformer, oversample, resize, blobproto), `net_spec`,
the pycaffe facade `compat.Net`, `Classifier`, `Detector`, and the CLI's
`test` / `time` / `device_query` verbs.

Tolerances, with their reasons:
- `io`, `net_spec` and the upgrade rules are the port's own copies of
  jax-free modules: none (the same numpy and PIL code on the same inputs);
- forwards through the facade, `Classifier.predict` and
  `Detector.detect_windows`: f32 (the facade's ``compute_dtype=None`` on
  both sides) on the same params from one `.caffemodel` written by the JAX
  package, rtol 1e-5 against the largest magnitude: the convs and matmuls
  sum in another order (oneDNN against XLA);
- the CLI's `test` means: printed to 6 decimals, equal to 2e-6.
"""

import contextlib
import io as pyio
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import deepcut_tpu.compat as j_caffe
from deepcut_tpu import io as j_io
from deepcut_tpu import net_spec as j_ns
from deepcut_tpu.classifier import Classifier as JClassifier
from deepcut_tpu.detector import Detector as JDetector
from deepcut_tpu.proto import text_format as j_tf
from deepcut_tpu.proto.caffemodel import save_caffemodel as j_save_caffemodel
from deepcut_tpu.tools import cli as j_cli
import deepcut_tpu_torch.compat as t_caffe
from deepcut_tpu_torch import io as t_io
from deepcut_tpu_torch import net_spec as t_ns
from deepcut_tpu_torch.classifier import Classifier as TClassifier
from deepcut_tpu_torch.core.graph import Net as TNet
from deepcut_tpu_torch.detector import Detector as TDetector
from deepcut_tpu_torch.models.convert import _graph_layout
from deepcut_tpu_torch.tools import cli as t_cli
from test_torch_graph import tame_params

CLASSIFIER = """
name: "TinyClassifier"
input: "data"
input_dim: 10
input_dim: 3
input_dim: 27
input_dim: 27
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
        convolution_param { num_output: 8 kernel_size: 5 stride: 2 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
        pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "norm1" type: "LRN" bottom: "pool1" top: "norm1" lrn_param { local_size: 3 } }
layer { name: "conv2" type: "Convolution" bottom: "norm1" top: "conv2"
        convolution_param { num_output: 8 pad: 1 kernel_size: 3 group: 2 } }
layer { name: "relu2" type: "ReLU" bottom: "conv2" top: "conv2" }
layer { name: "fc" type: "InnerProduct" bottom: "conv2" top: "fc"
        inner_product_param { num_output: 5 } }
layer { name: "prob" type: "Softmax" bottom: "fc" top: "prob" }
"""


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(prototxt path, .caffemodel path written by the JAX package)."""
    root = tmp_path_factory.mktemp("frontends")
    proto = root / "deploy.prototxt"
    proto.write_text(CLASSIFIER)
    jnet = j_caffe.Net(str(proto), j_caffe.TEST)._net
    weights = root / "w.caffemodel"
    j_save_caffemodel(str(weights), tame_params(jnet), deconv_names=jnet.deconv_names())
    return str(proto), str(weights)


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30)


# -- io ----------------------------------------------------------------------------
def test_transformer_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.rand(20, 24, 3).astype(np.float32)
    mean = rng.rand(3).astype(np.float32) * 100
    ts, js = t_io.Transformer({"data": (1, 3, 16, 18)}), j_io.Transformer({"data": (1, 3, 16, 18)})
    for tr in (ts, js):
        tr.set_transpose("data", (2, 0, 1))
        tr.set_channel_swap("data", (2, 1, 0))
        tr.set_raw_scale("data", 255)
        tr.set_mean("data", mean)
        tr.set_input_scale("data", 0.5)
    got, want = ts.preprocess("data", img), js.preprocess("data", img)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ts.deprocess("data", got), js.deprocess("data", want))


@pytest.mark.parametrize("interp", [0, 1, 3])
def test_resize_and_oversample_match_jax(interp):
    rng = np.random.RandomState(interp)
    ims = [rng.rand(13, 17, 3).astype(np.float32) for _ in range(2)]
    np.testing.assert_array_equal(t_io.resize_image(ims[0], (21, 9), interp),
                                  j_io.resize_image(ims[0], (21, 9), interp))
    np.testing.assert_array_equal(t_io.oversample(ims, (7, 8)), j_io.oversample(ims, (7, 8)))


def test_load_image_and_blobproto_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    path = tmp_path / "im.png"
    Image.fromarray(rng.randint(0, 256, (9, 11, 3), np.uint8)).save(path)
    for color in (True, False):
        np.testing.assert_array_equal(t_io.load_image(str(path), color),
                                      j_io.load_image(str(path), color))
    arr = rng.randn(2, 3, 4).astype(np.float32)
    buf = t_io.array_to_blobproto_bytes(arr)
    assert buf == j_io.array_to_blobproto_bytes(arr)
    np.testing.assert_array_equal(t_io.blobproto_bytes_to_array(buf), arr)


# -- net_spec ------------------------------------------------------------------------
def _spec(ns):
    n = ns.NetSpec()
    L = ns.layers
    n.data = L.Input(input_param=dict(shape=dict(dim=[2, 3, 12, 12])))
    n.conv1 = L.Convolution(n.data, num_output=4, kernel_size=3, pad=1,
                            weight_filler=dict(type="xavier"))
    n.relu1 = L.ReLU(n.conv1, in_place=True)
    n.pool = L.Pooling(n.conv1, pool="MAX", kernel_size=2, stride=2)
    n.a, n.b = L.Slice(n.pool, ntop=2, slice_param=dict(axis=1))
    n.cat = L.Concat(n.b, n.a)
    n.fc = L.InnerProduct(n.cat, num_output=3)
    n.prob = L.Softmax(n.fc)
    return n


def test_net_spec_matches_jax_and_builds_the_port_net():
    text = _spec(t_ns).to_proto_text()
    assert text == _spec(j_ns).to_proto_text()
    assert t_tf_dump_round_trip(text) == text
    net = _spec(t_ns).to_net(device="cpu", compute_dtype=None)
    assert net.output_names() == ["prob"]
    out = net.forward(data=np.random.RandomState(0).randn(2, 3, 12, 12).astype(np.float32))
    np.testing.assert_allclose(out["prob"].sum(1), 1.0, rtol=1e-6)


def t_tf_dump_round_trip(text):
    from deepcut_tpu_torch.proto import text_format as t_tf

    return t_tf.dump(t_tf.parse(text))


# -- the facade ---------------------------------------------------------------------
def test_entry_points_default_to_the_card(model):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device works")
    proto, weights = model
    for make in (lambda: TNet(proto), lambda: t_caffe.Net(proto, weights, t_caffe.TEST),
                 lambda: TClassifier(proto, weights), lambda: TDetector(proto, weights)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_cli.main(["test", "-model", proto, "-iterations", "1"])


def test_compat_net_matches_jax(model, tmp_path):
    proto, weights = model
    tnet = t_caffe.Net(proto, weights, t_caffe.TEST, device="cpu")
    jnet = j_caffe.Net(proto, weights, j_caffe.TEST)
    assert tnet.inputs == jnet.inputs and tnet.outputs == jnet.outputs
    assert list(tnet.params) == list(jnet.params)
    assert list(tnet.top_names.items()) == list(jnet.top_names.items())
    assert list(tnet.bottom_names.items()) == list(jnet.bottom_names.items())
    assert [l.type for l in tnet.layers] == [l.type for l in jnet.layers]
    assert list(tnet.layer_dict) == list(jnet.layer_dict)
    types = tnet._net.layer_types()
    for name in tnet.params:  # Caffe's blob layouts; the JAX facade shows its HWIO
        for tb, jb, key in zip(tnet.params[name], jnet.params[name], t_caffe.PARAM_ORDER):
            np.testing.assert_array_equal(tb.data, _graph_layout(types[name], key, jb.data, True))
    x = np.random.RandomState(2).randn(10, 3, 27, 27).astype(np.float32)
    tnet.blobs["data"].data[...] = x
    jnet.blobs["data"].data[...] = x
    _close(tnet.forward()["prob"], jnet.forward()["prob"])
    _close(tnet.blobs["conv2"].data, jnet.blobs["conv2"].data)
    # partial forward from the staged blobs
    got = tnet.forward(start="conv2", end="fc")
    want = jnet.forward(start="conv2", end="fc")
    assert set(got) == set(want) == {"fc"}
    _close(got["fc"], want["fc"])
    # net surgery: a write into a param view reaches the next forward
    for net in (tnet, jnet):
        net.params["fc"][0].data[...] *= 2.0
        net.params["fc"][1].data[0] = 3.0
    np.testing.assert_array_equal(tnet.params["fc"][0].data, jnet.params["fc"][0].data)
    _close(tnet.forward(data=x)["prob"], jnet.forward(data=x)["prob"])
    # forward_all in chunks of the input blob's batch
    many = np.random.RandomState(3).randn(25, 3, 27, 27).astype(np.float32)
    got, want = tnet.forward_all(data=many), jnet.forward_all(data=many)
    assert got["prob"].shape == (25, 5)
    _close(got["prob"], want["prob"])
    # save / copy_from / share_with
    path = str(tmp_path / "surgery.caffemodel")
    tnet.save(path)
    other = t_caffe.Net(proto, t_caffe.TEST, device="cpu")
    other.copy_from(path)
    np.testing.assert_array_equal(other.params["fc"][0].data, tnet.params["fc"][0].data)
    third = t_caffe.Net(proto, t_caffe.TEST, device="cpu")
    third.share_with(tnet)
    assert third._net.params["fc"] is tnet._net.params["fc"]
    assert t_caffe.layer_type_list() == sorted(t_caffe.layer_type_list())
    assert set(t_caffe.layer_type_list()) < set(j_caffe.layer_type_list())
    t_caffe.set_mode_gpu()
    t_caffe.set_device(0)
    with pytest.raises(NotImplementedError, match="training slice"):
        tnet.backward()
    with pytest.raises(NotImplementedError, match="data slice"):
        tnet.save(str(tmp_path / "w.h5"))
    with pytest.raises(NotImplementedError, match="training slice"):
        t_caffe.get_solver("solver.prototxt")


# -- Classifier / Detector ------------------------------------------------------------
def test_classifier_predict_matches_jax(model):
    proto, weights = model
    rng = np.random.RandomState(4)
    images = [rng.rand(32, 30, 3).astype(np.float32) for _ in range(2)]
    kw = dict(image_dims=(32, 32), raw_scale=255, channel_swap=(2, 1, 0),
              mean=np.array([104.0, 117.0, 123.0], np.float32))
    tcls = TClassifier(proto, weights, device="cpu", **kw)
    jcls = JClassifier(proto, weights, **kw)
    for oversample in (True, False):
        got = tcls.predict(images, oversample=oversample)
        want = jcls.predict(images, oversample=oversample)
        assert got.shape == (2, 5)
        np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)
        _close(got, want)


def test_detector_detect_windows_matches_jax(model, tmp_path):
    proto, weights = model
    rng = np.random.RandomState(5)
    paths = []
    for i in range(2):
        p = tmp_path / f"im{i}.png"
        Image.fromarray(rng.randint(0, 256, (40, 50, 3), np.uint8)).save(p)
        paths.append(str(p))
    windows = [(paths[0], np.array([[2, 3, 30, 40], [10, 5, 39, 25]])),
               (paths[1], np.array([[0, 0, 20, 20], [5, 10, 35, 49], [1, 1, 39, 49]]))]
    for pad in (0, 4):
        kw = dict(raw_scale=255, channel_swap=(2, 1, 0), context_pad=pad,
                  mean=np.array([104.0, 117.0, 123.0], np.float32))
        got = TDetector(proto, weights, device="cpu", **kw).detect_windows(windows)
        want = JDetector(proto, weights, **kw).detect_windows(windows)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert g["filename"] == w["filename"]
            np.testing.assert_array_equal(g["window"], w["window"])
            _close(g["prediction"], w["prediction"])


# -- the CLI ---------------------------------------------------------------------------
def _run(main, argv):
    buf = pyio.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def test_cli_test_matches_jax(model):
    proto, weights = model
    got = _run(t_cli.main, ["test", "-model", proto, "-weights", weights, "-iterations", "2",
                            "-fp32", "-device", "cpu"])
    want = _run(j_cli.main, ["test", "-model", proto, "-weights", weights, "-iterations", "2",
                             "-fp32"])
    parse = lambda out: {ln.split(" = ")[0]: float(ln.split(" = ")[1])
                         for ln in out.splitlines() if " = " in ln}
    assert set(parse(got)) == set(parse(want)) == {"prob"}
    assert abs(parse(got)["prob"] - parse(want)["prob"]) <= 2e-6


def test_cli_time_on_the_cpu(model, tmp_path):
    proto, weights = model
    out = _run(t_cli.main, ["time", "-model", proto, "-weights", weights, "-iterations", "2",
                            "-device", "cpu", "-per_layer", "-top", "3",
                            "-trace", str(tmp_path / "trace")])
    assert "Timing TinyClassifier: 8 layers, 2 iterations, bf16 on cpu" in out
    ms = float(out.split("Average forward (make_forward): ")[1].split()[0])
    assert ms > 0
    lines = out.splitlines()
    head = next(i for i, ln in enumerate(lines) if ln.startswith("layer "))
    rows = lines[head + 1:next(i for i, ln in enumerate(lines) if ln.startswith("Sum of layers"))]
    assert len(rows) == 3 and all(float(r.split()[-1]) >= 0 for r in rows)
    trace = json.loads((tmp_path / "trace" / "TinyClassifier_forward.json").read_text())
    assert trace["traceEvents"]
    out = _run(t_cli.main, ["time", "-model", proto, "-iterations", "1", "-device", "cpu",
                            "-fold_bn", "-fp32"])
    assert "folded 0 BN chains; weights cast to f32" in out
    assert "no CUDA card" in _run(t_cli.main, ["device_query"]) or torch.cuda.is_available()
