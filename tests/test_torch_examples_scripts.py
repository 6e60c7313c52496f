"""The port's example scripts against the JAX package's, on the CPU:
`classification.py` and `detection.py` (the same deploy net and
`.caffemodel` written by the JAX package, the same images, mean and labels:
the same stdout lines, and the detections' `.npz` within 1e-5),
`net_surgery.py` (the same classifier prototxts; the port's run, as a user
starts it, prints "surgery exact"), and pycaffe (`caffenet.py`'s prototxt
text byte-equal; the `pyloss` EuclideanLossLayer net's 60-step SGD
trajectory within 2e-5 of the JAX one's, at each step's loss and at the
trained weights' scale, from the same numpy weights).
"""

import contextlib
import importlib.util
import io as pyio
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import deepcut_tpu.compat as j_caffe
from deepcut_tpu.core import layers as j_layers
from deepcut_tpu.core.graph import Net as JNet
from deepcut_tpu.io import array_to_blobproto_bytes
from deepcut_tpu.proto import text_format as j_tf
from deepcut_tpu.proto.caffemodel import save_caffemodel as j_save_caffemodel
from deepcut_tpu.solver import update_rules as j_ur
from deepcut_tpu_torch.core import layers as t_layers
from deepcut_tpu_torch.core.graph import Net as TNet
from deepcut_tpu_torch.examples import classification as t_classification
from deepcut_tpu_torch.examples import detection as t_detection
from deepcut_tpu_torch.examples import net_surgery as t_net_surgery
from deepcut_tpu_torch.examples.pycaffe import caffenet as t_caffenet
from deepcut_tpu_torch.examples.pycaffe.layers import pyloss as t_pyloss
from deepcut_tpu_torch.models.convert import graph_params_from_numpy, graph_params_to_numpy
from deepcut_tpu_torch.proto import text_format as t_tf
from deepcut_tpu_torch.solver import update_rules as t_ur
from test_torch_frontends import CLASSIFIER
from test_torch_graph import tame_params

REPO = Path(__file__).resolve().parents[1]
TRAJECTORY_RTOL = 2e-5


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(main, argv):
    buf = pyio.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The deploy net, its `.caffemodel` (written by the JAX package), a
    mean `.binaryproto`, a labels file and two images."""
    root = tmp_path_factory.mktemp("scripts")
    proto = root / "deploy.prototxt"
    proto.write_text(CLASSIFIER)
    jnet = j_caffe.Net(str(proto), j_caffe.TEST)._net
    weights = root / "w.caffemodel"
    j_save_caffemodel(str(weights), tame_params(jnet), deconv_names=jnet.deconv_names())
    mean = root / "mean.binaryproto"
    mean.write_bytes(array_to_blobproto_bytes(
        np.stack([np.full((27, 27), v, np.float32) for v in (104.0, 117.0, 123.0)])[None]))
    labels = root / "labels.txt"
    labels.write_text("".join(f"class_{i}\n" for i in range(5)))
    rng = np.random.RandomState(0)
    images = []
    for i, (h, w) in enumerate(((36, 30), (40, 52))):
        images.append(str(root / f"img{i}.png"))
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(images[-1])
    return {"proto": str(proto), "weights": str(weights), "mean": str(mean),
            "labels": str(labels), "images": images, "root": root}


# -- classification.py --------------------------------------------------------------
@pytest.mark.parametrize("flags", [["--mean", "MEAN", "--labels", "LABELS"], ["--no-oversample"],
                                   ["--no-oversample", "--mean", "MEAN"]])
def test_classification_prints_what_jax_prints(model, flags):
    flags = [model["mean"] if f == "MEAN" else model["labels"] if f == "LABELS" else f
             for f in flags]
    argv = [model["proto"], model["weights"], *model["images"], *flags]
    want = _stdout(_load("j_classification", "examples/classification.py").main, argv)
    got = _stdout(t_classification.main, argv + ["--device", "cpu"])
    assert got == want
    assert got.count("\n") == 2 * 6 and model["images"][1] in got


# -- detection.py -------------------------------------------------------------------
def test_read_windows_file_matches_jax(tmp_path):
    wfile = tmp_path / "windows.txt"
    wfile.write_text("/a.png\n0 0 19 19\n\n5 5 30 30\nimages/b c.png\n-1 2 3 4\n/empty.png\n")
    got = t_detection.read_windows_file(str(wfile))
    want = _load("j_detection", "examples/detection.py").read_windows_file(str(wfile))
    assert [g[0] for g in got] == [w[0] for w in want] == ["/a.png", "images/b c.png",
                                                           "/empty.png"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1], w[1])


@pytest.mark.parametrize("pad", [0, 4])
def test_detection_prints_and_saves_what_jax_does(model, tmp_path, pad):
    wfile = tmp_path / "windows.txt"
    a, b = model["images"]
    wfile.write_text(f"{a}\n0 0 19 19\n5 5 30 25\n{b}\n2 3 39 51\n10 20 30 40\n")
    argv = [model["proto"], model["weights"], str(wfile), "--mean", model["mean"],
            "--context-pad", str(pad)]
    want = _stdout(_load("j_detection", "examples/detection.py").main,
                   argv + ["--out", str(tmp_path / "j.npz")])
    got = _stdout(t_detection.main, argv + ["--out", str(tmp_path / "t.npz"), "--device", "cpu"])
    assert got.replace("t.npz", "j.npz") == want
    assert got.count("-> class") == 4
    j, t = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    np.testing.assert_array_equal(t["windows"], j["windows"])
    np.testing.assert_array_equal(t["filenames"], j["filenames"])
    np.testing.assert_allclose(t["predictions"], j["predictions"], rtol=0, atol=1e-5)


# -- net_surgery.py -----------------------------------------------------------------
@pytest.mark.parametrize("h, w, fully_conv", [(33, 33, False), (63, 63, True)])
def test_net_surgery_prototxts_match_jax(h, w, fully_conv):
    j_mod = _load("j_net_surgery", "examples/net_surgery.py")
    assert t_net_surgery.classifier_prototxt(h, w, fully_conv) == \
        j_mod.classifier_prototxt(h, w, fully_conv)


def test_net_surgery_runs_as_a_module():
    proc = subprocess.run([sys.executable, "-m", "deepcut_tpu_torch.examples.net_surgery",
                           "--device", "cpu"], cwd=str(REPO), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    assert "channel 0 silenced" in proc.stdout and "surgery exact" in proc.stdout


# -- pycaffe ------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(lmdb_path="some_lmdb", batch_size=4, num_classes=8,
                                     include_acc=True),
                                dict(lmdb_path="examples/imagenet/data/train_lmdb")])
def test_caffenet_prototxt_byte_equal_to_jax(kw):
    j_mod = _load("j_caffenet", "examples/pycaffe/caffenet.py")
    assert t_caffenet.caffenet(**kw).to_proto_text() == j_mod.caffenet(**kw).to_proto_text()


def test_caffenet_main_writes_the_jax_file(tmp_path):
    out = tmp_path / "caffenet_train.prototxt"
    assert t_caffenet.main(["db_lmdb", str(out)]) == 0
    j_mod = _load("j_caffenet", "examples/pycaffe/caffenet.py")
    assert out.read_text() == j_mod.caffenet("db_lmdb").to_proto_text()


PYLOSS_NET = """
name: "pyloss_net"
input: "data"  input_shape { dim: 8 dim: 4 }
input: "label" input_shape { dim: 8 dim: 1 }
layer { name: "fc" type: "InnerProduct" bottom: "data" top: "pred"
        inner_product_param { num_output: 1
          weight_filler { type: "gaussian" std: 0.5 } } }
layer { name: "loss" type: "Python" bottom: "pred" bottom: "label"
        top: "loss" loss_weight: 1
        python_param { module: "pyloss" layer: "EuclideanLossLayer" } }
"""


def test_pyloss_trajectory_matches_jax():
    """60 SGD steps (momentum 0.9) from the same numpy weights on the same
    batch: the losses within 2e-5 relative, the trained weights within
    2e-5 of their scale; the loss equals the reference formula and falls
    twentyfold, as tests/test_example_pycaffe.py holds the JAX one."""
    j_pyloss = _load("j_pyloss", "examples/pycaffe/layers/pyloss.py")
    j_layers.register_python_layer("EuclideanLossLayer", j_pyloss.EuclideanLossLayer)
    t_layers.register_python_layer("EuclideanLossLayer", t_pyloss.EuclideanLossLayer)
    rng = np.random.RandomState(0)
    x = rng.randn(8, 4).astype(np.float32)
    y = x @ rng.randn(4, 1).astype(np.float32)
    start = {"fc": {"w": (0.5 * rng.randn(1, 4)).astype(np.float32),
                    "b": np.zeros(1, np.float32)}}
    jnet = JNet(j_tf.parse(PYLOSS_NET), phase="TRAIN", compute_dtype=None)
    types = jnet.layer_types()
    tnet = TNet(t_tf.parse(PYLOSS_NET), phase="TRAIN", compute_dtype=None, device="cpu",
                weights=graph_params_from_numpy(start, types))
    cfg = dict(solver_type="SGD", base_lr=0.05, momentum=0.9, weight_decay=0.0)
    jcfg, tcfg = j_ur.SolverConfig(**cfg), t_ur.SolverConfig(**cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, start)
    tp = tnet.params
    jstep, tstep = jax.jit(jnet.make_train_step(jcfg)), tnet.make_train_step(tcfg)
    js, ts = j_ur.init_state(jcfg, jp), t_ur.init_state(tcfg, tp)
    jin = {"data": jnp.asarray(x), "label": jnp.asarray(y)}
    tin = {"data": x, "label": y}
    losses = []
    for i in range(60):
        jp, js, jl = jstep(jp, js, jin)
        tp, ts, tl = tstep(tp, ts, tin)
        assert abs(float(tl) - float(jl)) <= TRAJECTORY_RTOL * abs(float(jl)), (i, tl, jl)
        losses.append(float(tl))
    got = graph_params_to_numpy(tp, types)
    for k in ("w", "b"):
        want = np.asarray(jp["fc"][k])
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got["fc"][k] - want).max()) <= TRAJECTORY_RTOL * scale, k
    tnet.params = tp
    out = tnet.forward(data=x, label=y)
    expect = float(np.sum((out["pred"] - y) ** 2) / (2 * 8))
    assert float(out["loss"]) == pytest.approx(expect, rel=1e-5)
    assert losses[-1] < 0.05 * losses[0], losses[:3] + losses[-3:]


def test_pyloss_resolves_by_module_path(monkeypatch):
    """Unregistered, `python_param { module: "pyloss" }` imports the layer
    from the example's directory on the path (its docstring's route), and
    autograd gives the backward: one plain SGD step moves the weights by
    the rate times the gradient of sum((pred - label)^2) / 2N."""
    layers_dir = REPO / "deepcut_tpu_torch/examples/pycaffe/layers"
    monkeypatch.syspath_prepend(str(layers_dir))
    monkeypatch.delitem(t_layers._PYTHON_REGISTRY, "EuclideanLossLayer", raising=False)
    monkeypatch.delitem(sys.modules, "pyloss", raising=False)
    rng = np.random.RandomState(2)
    x, y = rng.randn(8, 4).astype(np.float32), rng.randn(8, 1).astype(np.float32)
    w0 = rng.randn(1, 4).astype(np.float32)
    tnet = TNet(t_tf.parse(PYLOSS_NET), phase="TRAIN", compute_dtype=None, device="cpu",
                weights={"fc": {"w": torch.tensor(w0), "b": torch.zeros(1)}})
    cfg = t_ur.SolverConfig(solver_type="SGD", base_lr=0.1, momentum=0.0, weight_decay=0.0)
    params, _, loss = tnet.make_train_step(cfg)(tnet.params, t_ur.init_state(cfg, tnet.params),
                                                {"data": x, "label": y})
    assert Path(sys.modules["pyloss"].__file__).resolve() == layers_dir / "pyloss.py"
    residual = x @ w0.T - y
    assert float(loss) == pytest.approx(float(np.sum(residual ** 2) / 16), rel=1e-5)
    np.testing.assert_allclose(params["fc"]["w"].numpy(), w0 - 0.1 * residual.T @ x / 8,
                               rtol=1e-5, atol=1e-6)
