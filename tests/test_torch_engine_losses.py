"""The training slice's layer types in the port's graph engine
(`deepcut_tpu_torch.core.layers`: the nine losses, Accuracy, Python and
DummyData) against the JAX package's (`deepcut_tpu.core.layers`), on the CPU.

Each loss case is a one-layer TRAIN net with Input tops, built by both
packages' `Net` from the same prototxt and fed the same seeded numpy
inputs. Its tops are held by `Net.forward` and its gradients by
`Net.backward` (every floating input's diff: autograd against `jax.grad`,
or against the JAX package's custom VJP where it has one). Tolerance: 16
f32 ulps at each output's largest magnitude. The sums run in another order
(PyTorch against XLA) and exp / log are each library's own, a few ulps
each, and the softmax's backward compounds them.

Accuracy is held with top_k > 1, ignore_label, a class axis and its
per-class top. Each Python layer is written twice, with jax.numpy for the
JAX package and with torch for the port, and the two nets are held equal.
DummyData's random fillers cannot draw JAX's values: they are held by their
statistics and by their determinism under a seed.
"""

import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcut_tpu.core import layers as j_layers
from deepcut_tpu.core.graph import Net as JNet
from deepcut_tpu.proto import text_format as j_tf
from deepcut_tpu_torch.core import layers as t_layers
from deepcut_tpu_torch.core.graph import Net as TNet
from deepcut_tpu_torch.io import array_to_blobproto_bytes
from deepcut_tpu_torch.models.convert import graph_params_from_numpy
from deepcut_tpu_torch.proto import text_format as t_tf
from test_torch_layers import _steps

ULPS = 16
S = (4, 5)              # (N, C) scores
M = (2, 3, 4, 5)        # NCHW scores of a dense loss

# (case id, inputs {name: (kind, shape[, high])}, layer body, tops)
# kinds: "f" normal, "p" a probability row (softmax of a normal), "pos" in
# (0, 1), "ids" class labels in [0, high), "ign" labels with some 255s,
# "bin" 0/1, "vec" dense score-map labels with some IGNORE_VALUE, "w" >= 0
LOSS_CASES = [
    ("softmax-valid", {"s": ("f", S), "l": ("ids", (4,), 5)},
     'type: "SoftmaxWithLoss"', 1),
    ("softmax-valid-ignore-prob", {"s": ("f", M), "l": ("ign", (2, 1, 4, 5), 3)},
     'type: "SoftmaxWithLoss" loss_param { ignore_label: 255 }', 2),
    ("softmax-batch-size", {"s": ("f", M), "l": ("ign", (2, 1, 4, 5), 3)},
     'type: "SoftmaxWithLoss" loss_param { ignore_label: 255 normalization: BATCH_SIZE }', 1),
    ("softmax-full", {"s": ("f", M), "l": ("ids", (2, 1, 4, 5), 3)},
     'type: "SoftmaxWithLoss" loss_param { normalization: FULL }', 1),
    ("softmax-none", {"s": ("f", M), "l": ("ign", (2, 1, 4, 5), 3)},
     'type: "SoftmaxWithLoss" loss_param { ignore_label: 255 normalization: NONE }', 1),
    ("softmax-normalize-false", {"s": ("f", S), "l": ("ids", (4, 1), 5)},
     'type: "SoftmaxWithLoss" loss_param { normalize: false }', 1),
    ("softmax-loss-weight", {"s": ("f", S), "l": ("ids", (4,), 5)},
     'type: "SoftmaxWithLoss" loss_weight: 0.25', 1),
    ("softmax-vec-ce", {"s": ("f", (2, 3, 4, 5)), "l": ("vec", (2, 3, 4, 5))},
     'type: "SoftmaxWithLossVec" softmax_with_loss_vec_param { cross_entropy: true }', 2),
    ("softmax-vec-softmax", {"s": ("f", (2, 3, 4, 5)), "l": ("vec", (2, 3, 4, 5))},
     'type: "SoftmaxWithLossVec"', 2),
    ("softmax-vec-weighted", {"s": ("f", (2, 3, 4, 5)), "l": ("bin", (2, 3, 4, 5)),
                              "w": ("w", (2, 3, 4, 5))},
     'type: "SoftmaxWithLossVec" softmax_with_loss_vec_param { cross_entropy: true }', 1),
    ("smooth-l1", {"a": ("f", (2, 4, 3, 3)), "b": ("f", (2, 4, 3, 3))},
     'type: "SmoothL1Loss"', 1),
    ("smooth-l1-weighted", {"a": ("f", (2, 4, 3, 3)), "b": ("f", (2, 4, 3, 3)),
                            "w": ("bin", (2, 4, 3, 3))}, 'type: "SmoothL1Loss"', 1),
    ("sigmoid-ce", {"s": ("f", M), "t": ("pos", M)}, 'type: "SigmoidCrossEntropyLoss"', 1),
    ("euclidean", {"a": ("f", M), "b": ("f", M)}, 'type: "EuclideanLoss"', 1),
    ("hinge-l1", {"s": ("f", S), "l": ("ids", (4,), 5)}, 'type: "HingeLoss"', 1),
    ("hinge-l2", {"s": ("f", S), "l": ("ids", (4,), 5)},
     'type: "HingeLoss" hinge_loss_param { norm: L2 }', 1),
    ("contrastive", {"a": ("f", (6, 3)), "b": ("f", (6, 3)), "y": ("bin", (6,))},
     'type: "ContrastiveLoss" contrastive_loss_param { margin: 2.0 }', 1),
    ("contrastive-legacy", {"a": ("f", (6, 3)), "b": ("f", (6, 3)), "y": ("bin", (6,))},
     'type: "ContrastiveLoss" contrastive_loss_param { margin: 2.0 legacy_version: true }', 1),
    ("infogain-bottom", {"p": ("p", S), "l": ("ids", (4,), 5), "h": ("w", (5, 5))},
     'type: "InfogainLoss"', 1),
    ("multinomial-logistic", {"p": ("p", S), "l": ("ids", (4,), 5)},
     'type: "MultinomialLogisticLoss"', 1),
]

ACCURACY_CASES = [
    ("top1", {"s": ("f", (6, 5)), "l": ("ids", (6,), 5)}, "", 1),
    ("top3", {"s": ("f", (6, 5)), "l": ("ids", (6,), 5)}, "top_k: 3", 1),
    ("ignore-per-class", {"s": ("f", (6, 5)), "l": ("ign", (6,), 5)}, "ignore_label: 255", 2),
    ("axis-dense-top2", {"s": ("f", M), "l": ("ids", (2, 1, 4, 5), 3)}, "top_k: 2 axis: 1", 2),
]


def make_inputs(spec, seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for nm, (kind, shape, *rest) in spec.items():
        if kind == "f":
            a = rng.randn(*shape) * 1.5
        elif kind == "p":
            z = np.exp(rng.randn(*shape))
            a = z / z.sum(axis=-1, keepdims=True)
        elif kind == "pos":
            a = rng.rand(*shape)
        elif kind in ("ids", "ign"):
            a = rng.randint(0, rest[0], shape)
            if kind == "ign":
                a.reshape(-1)[::4] = 255
        elif kind == "bin":
            a = rng.randint(0, 2, shape)
        elif kind == "vec":
            a = rng.randint(0, 2, shape).astype(np.float64)
            a[:, :, 0, :2] = 1000.0      # IGNORE_VALUE at some positions
        else:
            a = rng.rand(*shape) + 0.1
        out[nm] = a.astype(np.float32)
    return out


def prototxt(spec, body, n_tops, name="loss"):
    lines = ['name: "one"']
    for nm, (_, shape, *_) in spec.items():
        lines.append(f'input: "{nm}" input_shape {{ ' + " ".join(f"dim: {d}" for d in shape) + " }")
    bottoms = " ".join(f'bottom: "{nm}"' for nm in spec)
    tops = " ".join(f'top: "out{i}"' for i in range(n_tops))
    lines.append(f'layer {{ name: "{name}" {bottoms} {tops} {body} }}')
    return "\n".join(lines)


def both_nets(proto, phase="TRAIN", params=None):
    jnet = JNet(j_tf.parse(proto), phase=phase, compute_dtype=None)
    if params is not None:
        jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    weights = graph_params_from_numpy(
        params if params is not None else jax.tree_util.tree_map(np.asarray, jnet.params),
        jnet.layer_types())
    return jnet, TNet(t_tf.parse(proto), phase=phase, compute_dtype=None, device="cpu",
                      weights=weights)


def assert_close(got, want, what, ulps=ULPS):
    assert np.isfinite(want).all(), what
    steps = _steps(got, want, "f32")
    assert steps <= ulps, f"{what}: {steps} f32 ulps (held to {ulps})"


@pytest.mark.parametrize("case", LOSS_CASES, ids=[c[0] for c in LOSS_CASES])
def test_loss_layer_forward_and_gradient_match_jax(case):
    _, spec, body, n_tops = case
    jnet, tnet = both_nets(prototxt(spec, body, n_tops))
    xs = make_inputs(spec)
    want, got = jnet.forward(**xs), tnet.forward(**xs)
    for i in range(n_tops):
        assert_close(got[f"out{i}"], want[f"out{i}"], f"top {i}")
    gwant, ggot = jnet.backward(**xs), tnet.backward(**xs)
    assert set(ggot) == set(gwant) == set(xs)
    for nm in xs:
        assert_close(ggot[nm], gwant[nm], f"d loss / d {nm}")
    assert np.abs(ggot[next(iter(xs))]).sum() > 0


def test_softmax_with_loss_out_of_range_label_is_nan():
    """A live label outside [0, C) makes the loss NaN in both packages (the
    reference CHECKs the range), and an ignored one does not."""
    spec = {"s": ("f", S), "l": ("ids", (4,), 5)}
    xs = make_inputs(spec)
    xs["l"][1] = 7
    for body, nan in (('type: "SoftmaxWithLoss"', True),
                      ('type: "SoftmaxWithLoss" loss_param { ignore_label: 7 }', False)):
        jnet, tnet = both_nets(prototxt(spec, body, 1))
        assert np.isnan(jnet.forward(**xs)["out0"]) == np.isnan(tnet.forward(**xs)["out0"]) == nan


def test_infogain_h_from_a_file(tmp_path):
    """InfogainLoss with two bottoms reads H from infogain_loss_param.source,
    a BlobProto file, once at setup."""
    spec = {"p": ("p", S), "l": ("ids", (4,), 5)}
    xs = make_inputs(spec)
    h = np.random.RandomState(5).rand(1, 1, 5, 5).astype(np.float32)
    (tmp_path / "h.binaryproto").write_bytes(array_to_blobproto_bytes(h))
    body = f'type: "InfogainLoss" infogain_loss_param {{ source: "{tmp_path / "h.binaryproto"}" }}'
    jnet, tnet = both_nets(prototxt(spec, body, 1))
    assert_close(tnet.forward(**xs)["out0"], jnet.forward(**xs)["out0"], "loss")
    assert_close(tnet.backward(**xs)["p"], jnet.backward(**xs)["p"], "d loss / d p")
    bare = prototxt(spec, 'type: "InfogainLoss"', 1)
    with pytest.raises(ValueError, match="third bottom"):
        TNet(t_tf.parse(bare), device="cpu").forward(**xs)


@pytest.mark.parametrize("case", ACCURACY_CASES, ids=[c[0] for c in ACCURACY_CASES])
def test_accuracy_matches_jax(case):
    _, spec, param, n_tops = case
    jnet, tnet = both_nets(prototxt(spec, f'type: "Accuracy" accuracy_param {{ {param} }}',
                                    n_tops), phase="TEST")
    xs = make_inputs(spec, seed=3)
    xs["s"].reshape(-1)[:4] = 0.5                # planted ties: the lower index ranks first
    want, got = jnet.forward(**xs), tnet.forward(**xs)
    for i in range(n_tops):   # the same hits; the share's quotient within 1 ulp (XLA's division)
        assert_close(got[f"out{i}"], want[f"out{i}"], f"top {i}", ulps=1)
    assert 0 <= float(got["out0"]) <= 1


# -- Python layers, each written twice ------------------------------------------
class SimpleJ:
    """top = 10 * bottom with its own backward (the reference's SimpleLayer)."""

    def forward(self, x):
        return 10.0 * x

    def backward(self, g, x):
        return 10.0 * g


class SimpleT(SimpleJ):
    pass


class ParamStrJ:
    def setup(self, param_str):
        self.scale = float(param_str)

    def forward(self, x):
        return self.scale * x


class ParamStrT(ParamStrJ):
    pass


class PhaseJ:
    def forward(self, x):
        return jnp.full_like(x, 1.0 if self.phase == "TEST" else 0.0)


class PhaseT:
    def forward(self, x):
        return torch.full_like(x, 1.0 if self.phase == "TEST" else 0.0)


class ScaleJ:
    """A learnable scale with its own backward returning the param grads."""

    def param_spec(self, bottom_shapes):
        return [("alpha", (1,), None)]

    def forward(self, x, params=None):
        return (params["alpha"] + 0.5) * x

    def backward(self, g, x, params=None):
        return (params["alpha"] + 0.5) * g, {"alpha": jnp.sum(g * x).reshape(1)}


class ScaleT(ScaleJ):
    def backward(self, g, x, params=None):
        return (params["alpha"] + 0.5) * g, {"alpha": (g * x).sum().reshape(1)}


def _python_net(kind, layer, extra=""):
    return f"""
    input: "data" input_shape {{ dim: 4 dim: 3 }}
    input: "target" input_shape {{ dim: 4 dim: 3 }}
    layer {{ name: "py" type: "Python" bottom: "data" top: "py"
             python_param {{ layer: "{layer}{kind}" {extra} }} }}
    layer {{ name: "loss" type: "EuclideanLoss" bottom: "py" bottom: "target" top: "loss" }}
    """


@pytest.mark.parametrize("layer,extra", [("Simple", ""), ("ParamStr", 'param_str: "2.5"'),
                                         ("Scale", "")])
def test_python_layer_forward_backward_match_jax(layer, extra):
    """A Python layer's forward, its own backward (installed as an
    autograd.Function in the port, a custom_vjp in the JAX package), its
    param_str and its declared params, against the JAX package."""
    j_layers.register_python_layer(layer + "J", globals()[layer + "J"])
    t_layers.register_python_layer(layer + "T", globals()[layer + "T"])
    jnet = JNet(j_tf.parse(_python_net("J", layer, extra)), phase="TRAIN", compute_dtype=None)
    tnet = TNet(t_tf.parse(_python_net("T", layer, extra)), phase="TRAIN", compute_dtype=None,
                device="cpu")
    xs = make_inputs({"data": ("f", (4, 3)), "target": ("f", (4, 3))})
    assert_close(tnet.forward(**xs)["py"], jnet.forward(**xs)["py"], "forward")
    for nm, g in tnet.backward(**xs).items():
        assert_close(g, jnet.backward(**xs)[nm], f"d loss / d {nm}")
    if layer == "Scale":   # the param grads of the custom rule, through a train step
        from deepcut_tpu.solver import update_rules as j_ur
        from deepcut_tpu_torch.solver import update_rules as t_ur

        cfg = dict(solver_type="SGD", base_lr=0.1, momentum=0.0, weight_decay=0.0)
        jp, _, _ = jnet.make_train_step(j_ur.SolverConfig(**cfg))(
            jnet.params, j_ur.init_state(j_ur.SolverConfig(**cfg), jnet.params), xs)
        tp, _, _ = tnet.make_train_step(t_ur.SolverConfig(**cfg))(
            tnet.params, t_ur.init_state(t_ur.SolverConfig(**cfg), tnet.params), xs)
        assert float(tp["py"]["alpha"][0]) != 0.0
        assert_close(tp["py"]["alpha"].numpy(), np.asarray(jp["py"]["alpha"]), "alpha")


def test_python_layer_phase_and_module_import(tmp_path):
    """The layer sees the net's phase; python_param.module imports a user
    module by path (a torch layer here)."""
    j_layers.register_python_layer("PhaseJ", PhaseJ)
    t_layers.register_python_layer("PhaseT", PhaseT)
    proto = ('input: "data" input_shape { dim: 1 dim: 2 }\n'
             'layer { name: "p" type: "Python" bottom: "data" top: "p" '
             'python_param { layer: "Phase%s" } }')
    x = np.ones((1, 2), np.float32)
    for phase, want in (("TRAIN", 0.0), ("TEST", 1.0)):
        t = TNet(t_tf.parse(proto % "T"), phase=phase, compute_dtype=None, device="cpu")
        j = JNet(j_tf.parse(proto % "J"), phase=phase, compute_dtype=None)
        np.testing.assert_array_equal(t.forward(data=x)["p"], j.forward(data=x)["p"])
        assert float(t.forward(data=x)["p"][0, 0]) == want
    (tmp_path / "torch_user_layers.py").write_text(textwrap.dedent("""
        import torch

        class Doubler:
            def forward(self, x):
                return torch.mul(x, 2.0)
    """))
    sys.path.insert(0, str(tmp_path))
    try:
        net = TNet(t_tf.parse(
            'input: "data" input_shape { dim: 1 dim: 3 }\n'
            'layer { name: "d" type: "Python" bottom: "data" top: "d" '
            'python_param { module: "torch_user_layers" layer: "Doubler" } }'),
            compute_dtype=None, device="cpu")
        np.testing.assert_array_equal(net.forward(data=np.ones((1, 3), np.float32))["d"],
                                      np.full((1, 3), 2.0, np.float32))
    finally:
        sys.path.remove(str(tmp_path))


# -- DummyData ------------------------------------------------------------------
def test_dummy_data_constant_and_legacy_dims_match_jax():
    """The legacy four-field dims (one value for all tops, or one per top)
    and constant fillers, as the JAX package builds them; a constant top
    handed in as an input keeps its value (filled once)."""
    proto = """
    layer { name: "dd" type: "DummyData" top: "a" top: "b"
      dummy_data_param { num: 2 channels: 3 channels: 1 height: 4 width: 5
        data_filler { type: "constant" value: 0.5 } data_filler { type: "constant" value: -2 } } }
    layer { name: "ip" type: "InnerProduct" bottom: "a" top: "ip"
      inner_product_param { num_output: 3 weight_filler { type: "gaussian" std: 0.1 } } }
    """
    jnet = JNet(j_tf.parse(proto), phase="TRAIN", compute_dtype=None)
    jnet.forward()
    _, tnet = both_nets(proto, params=jax.tree_util.tree_map(np.asarray, jnet.params))
    want, got = jnet.forward(), tnet.forward()
    assert got["a"].shape == (2, 3, 4, 5) and got["b"].shape == (2, 1, 4, 5)
    for k in ("a", "b", "ip"):
        assert_close(got[k], want[k], k)
    staged = np.full((2, 1, 4, 5), 7.0, np.float32)
    assert tnet.sticky_top_names() == jnet.sticky_top_names() == {"a", "b"}
    np.testing.assert_array_equal(tnet.forward(b=staged)["b"], staged)


def test_dummy_data_random_fillers_statistics_and_seed():
    """Gaussian and uniform tops refill every forward of a TRAIN net, with
    their mean, spread and range, drawn from the net's seed: the same seed
    draws the same tops, another seed others."""
    proto = """
    layer { name: "dd" type: "DummyData" top: "g" top: "u"
      dummy_data_param { shape { dim: 64 dim: 64 } shape { dim: 64 dim: 64 }
        data_filler { type: "gaussian" mean: 1.5 std: 2.0 }
        data_filler { type: "uniform" min: -1 max: 3 } } }
    """
    nets = [TNet(t_tf.parse(proto), phase="TRAIN", device="cpu", seed=s) for s in (3, 3, 4)]
    first = [n.forward() for n in nets]
    g, u = first[0]["g"], first[0]["u"]
    assert abs(g.mean() - 1.5) < 0.1 and abs(g.std() - 2.0) < 0.1
    assert u.min() >= -1 and u.max() < 3 and abs(u.mean() - 1.0) < 0.1
    np.testing.assert_array_equal(first[0]["g"], first[1]["g"])
    assert not np.array_equal(first[0]["g"], first[2]["g"])
    assert not np.array_equal(nets[0].forward()["g"], g)       # refilled
