"""The graph engine's training core in the port (`core.graph.Net`:
`make_train_step`, `backward`, BatchNorm / Dropout / STOCHASTIC pooling in
TRAIN) against the JAX package's, on the CPU.

Trajectories: one small net holds every feature at once: a bias-free
convolution (a bias before BatchNorm gets a gradient of rounding noise
only), BatchNorm with batch statistics (its moving averages compared too),
a Scale, a ceil-mode
MAX pool (planted ties: the first-max backward), two 1x1 convolutions
sharing one named weight and bias (the gradients sum into the owner), a
frozen InnerProduct (lr_mult 0), a second InnerProduct with decay_mult 0
(and lr_mult 2 on its bias),
SoftmaxWithLoss and a weighted EuclideanLoss. Both packages start from the
same seeded numpy params (carried across by
`models.convert.graph_params_from_numpy`) and take 5 steps on the same
inputs under each of the six update rules, with iter_size 1 and 2. The
losses agree within 1e-5 relative, and every param and every solver-state
blob within 2e-5 of that blob's largest magnitude (RTOL). The f32 sums run
in another order each step (oneDNN against XLA, a few ulps), and the
adaptive rules divide by square roots of small second moments, which
scales those ulps up.

`backward` with intermediate diffs, injected cotangents, start / end and
propagate_down is held against the JAX package's `backward` on the same
params within 16 f32 ulps at each diff's largest magnitude (as
tests/test_torch_engine_losses.py). Dropout and STOCHASTIC pooling cannot
draw JAX's masks: they are held by their statistics (the keep rate and the
1/(1-ratio) scale; samples taken from the window in proportion to their
values) and by their determinism under the seed and the iteration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcut_tpu.core.graph import Net as JNet
from deepcut_tpu.proto import text_format as j_tf
from deepcut_tpu.solver import update_rules as j_ur
from deepcut_tpu_torch import compat as t_caffe
from deepcut_tpu_torch.core.graph import Net as TNet
from deepcut_tpu_torch.models.convert import (
    graph_params_from_numpy, graph_params_to_numpy, graph_state_to_numpy)
from deepcut_tpu_torch.proto import text_format as t_tf
from deepcut_tpu_torch.solver import update_rules as t_ur
from test_torch_engine_losses import assert_close

RTOL = 2e-5
LOSS_RTOL = 1e-5

FEATURE_NET = """
name: "features"
input: "data" input_shape { dim: 4 dim: 3 dim: 9 dim: 9 }
input: "label" input_shape { dim: 4 }
input: "target" input_shape { dim: 4 dim: 4 }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 6 kernel_size: 3 pad: 1 bias_term: false } }
layer { name: "bn1" type: "BatchNorm" bottom: "conv1" top: "conv1" }
layer { name: "sc1" type: "Scale" bottom: "conv1" top: "conv1" scale_param { bias_term: true } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "conv2a" type: "Convolution" bottom: "pool1" top: "conv2a"
  param { name: "shared_w" } param { name: "shared_b" lr_mult: 2 }
  convolution_param { num_output: 5 kernel_size: 1 } }
layer { name: "conv2b" type: "Convolution" bottom: "pool1" top: "conv2b"
  param { name: "shared_w" } param { name: "shared_b" }
  convolution_param { num_output: 5 kernel_size: 1 } }
layer { name: "sum" type: "Eltwise" bottom: "conv2a" bottom: "conv2b" top: "sum" }
layer { name: "fc1" type: "InnerProduct" bottom: "sum" top: "fc1"
  param { lr_mult: 0 } param { lr_mult: 0 } inner_product_param { num_output: 8 } }
layer { name: "relu2" type: "ReLU" bottom: "fc1" top: "fc1" }
layer { name: "fc2" type: "InnerProduct" bottom: "fc1" top: "fc2"
  param { decay_mult: 0 } param { lr_mult: 2 decay_mult: 0 } inner_product_param { num_output: 4 } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc2" bottom: "label" top: "loss" }
layer { name: "reg" type: "EuclideanLoss" bottom: "fc2" bottom: "target" top: "reg"
  loss_weight: 0.1 }
"""

RULES = {
    "SGD": dict(base_lr=0.05, momentum=0.9, lr_policy="step", gamma=0.5, stepsize=3),
    "Nesterov": dict(base_lr=0.05, momentum=0.9),
    "AdaGrad": dict(base_lr=0.05, momentum=0.0, delta=1e-6),
    "RMSProp": dict(base_lr=0.01, momentum=0.0, rms_decay=0.95, delta=1e-6),
    "AdaDelta": dict(base_lr=1.0, momentum=0.95, delta=1e-6),
    "Adam": dict(base_lr=0.01, momentum=0.9, momentum2=0.999, delta=1e-6),
}


def tame_params(jnet, seed=0):
    """Seeded fan-in-scaled weights, small biases, BN statistics away from
    the identity, in the JAX package's layouts (numpy)."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, entry in jnet.params.items():
        out[name] = {}
        for k, v in entry.items():
            shape = np.shape(v)
            if k == "w":
                fan_in = np.prod(shape[:3]) if len(shape) == 4 else shape[1]
                a = rng.randn(*shape) * (2.0 / fan_in) ** 0.5
            elif k in ("var", "scale_factor", "gamma"):
                a = 1 + 0.3 * rng.rand(*shape)
            else:
                a = 0.1 * rng.randn(*shape)
            out[name][k] = a.astype(np.float32)
    return out


def nets(proto, phase="TRAIN", seed=0):
    jnet = JNet(j_tf.parse(proto), phase=phase, compute_dtype=None)
    params = tame_params(jnet, seed)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    tnet = TNet(t_tf.parse(proto), phase=phase, compute_dtype=None, device="cpu",
                weights=graph_params_from_numpy(params, jnet.layer_types()))
    return jnet, tnet


def feature_inputs(seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(4, 3, 9, 9) * 2 + 0.5).astype(np.float32)
    x[:, :, :3, :3] = 0.25                       # ties for the max pool
    return {"data": x, "label": rng.randint(0, 4, 4).astype(np.float32),
            "target": rng.randn(4, 4).astype(np.float32)}


def _nhwc(v):
    return v.transpose(0, 2, 3, 1) if v.ndim == 4 else v


def assert_trees_close(got, want, what):
    for name, entry in want.items():
        for k, w in entry.items():
            w = np.asarray(w)
            scale = max(float(np.abs(w).max()), 1e-30)
            d = float(np.abs(got[name][k] - w).max())
            assert d <= RTOL * scale, f"{what} {name}/{k}: |d| {d:.3g} at scale {scale:.3g}"


@pytest.mark.parametrize("iter_size", [1, 2])
@pytest.mark.parametrize("rule", list(RULES))
def test_five_step_trajectory_matches_jax(rule, iter_size):
    jnet, tnet = nets(FEATURE_NET)
    cfg = dict(RULES[rule], solver_type=rule, weight_decay=0.01, iter_size=iter_size)
    jcfg, tcfg = j_ur.SolverConfig(**cfg), t_ur.SolverConfig(**cfg)
    jstep, tstep = jax.jit(jnet.make_train_step(jcfg)), tnet.make_train_step(tcfg)
    jp, js = jnet.params, j_ur.init_state(jcfg, jnet.params)
    tp, ts = tnet.params, t_ur.init_state(tcfg, tnet.params)
    assert tnet.params["conv2b"] == {} and tnet._aliases["conv2b"]["w"] == ("conv2a", "w")
    frozen = tp["fc1"]["w"].clone()
    for i in range(5):
        batches = [feature_inputs(10 * i + m) for m in range(iter_size)]
        if iter_size == 1:
            tin = batches[0]
            jin = {k: jnp.asarray(_nhwc(v)) for k, v in tin.items()}
        else:
            tin = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
            jin = {k: jnp.asarray(np.stack([_nhwc(b[k]) for b in batches])) for k in batches[0]}
        jp, js, jl = jstep(jp, js, jin)
        tp, ts, tl = tstep(tp, ts, tin)
        assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl)), (i, float(tl), float(jl))
    types = tnet.layer_types()
    assert_trees_close(graph_params_to_numpy(tp, types), jax.tree_util.tree_map(np.asarray, jp),
                       "param")
    got_state = graph_state_to_numpy(ts, types)
    assert int(got_state["iter"]) == int(js["iter"]) == 5
    for key in js:
        if key != "iter":
            assert_trees_close(got_state[key], jax.tree_util.tree_map(np.asarray, js[key]), key)
    assert torch.equal(tp["fc1"]["w"], frozen)                       # lr_mult 0
    sf = float(tp["bn1"]["scale_factor"][0])                         # moving average moved
    assert sf != float(tame_params(jnet)["bn1"]["scale_factor"][0])


DIFF_NET = """
name: "diffnet"
input: "data" input_shape { dim: 2 dim: 3 dim: 6 dim: 6 }
input: "target" input_shape { dim: 2 dim: 3 }
input: "label" input_shape { dim: 2 }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param { num_output: 4 kernel_size: 3 } }
layer { name: "relu" type: "ReLU" bottom: "conv" top: "conv" }
layer { name: "split" type: "Split" bottom: "conv" top: "c1" top: "c2" }
layer { name: "ip" type: "InnerProduct" bottom: "c1" top: "ip" inner_product_param { num_output: 3 } }
layer { name: "ipb" type: "InnerProduct" bottom: "c2" top: "ipb"
  propagate_down: false inner_product_param { num_output: 3 } }
layer { name: "loss" type: "EuclideanLoss" bottom: "ip" bottom: "target" top: "loss" }
layer { name: "loss2" type: "SoftmaxWithLoss" bottom: "ipb" bottom: "label" top: "loss2" }
"""


def _diff_inputs():
    rng = np.random.RandomState(7)
    return {"data": rng.randn(2, 3, 6, 6).astype(np.float32),
            "target": rng.randn(2, 3).astype(np.float32),
            "label": np.array([0, 2], np.float32)}


@pytest.mark.parametrize("variant", ["diffs", "cotangents", "start", "end"])
def test_backward_matches_jax(variant):
    """Input diffs, intermediate diffs (each top of a Split its own branch's;
    a non-floating input's zeros), injected cotangents at a mid-graph blob,
    and the partial backward from a start layer (seeded) or down to an end
    layer, against the JAX package; propagate_down: false blocks the second
    branch's gradient into the trunk."""
    jnet, tnet = nets(DIFF_NET)
    xs = _diff_inputs()
    kw = {"diffs": dict(diffs=["c1", "c2", "conv", "ip"]),
          "cotangents": dict(cotangents={"ip": np.random.RandomState(1).randn(2, 3)
                                         .astype(np.float32)}),
          "start": dict(start="ip", cotangents={"ip": np.ones((2, 3), np.float32)}),
          "end": dict(end="relu", diffs=["conv"])}[variant]
    jnet.forward(**xs)
    tnet.forward(**xs)
    want = jnet.backward(**kw, **dict(xs))
    got = tnet.backward(**kw, **dict(xs))
    assert set(got) == set(want), (sorted(got), sorted(want))
    for nm in want:
        assert_close(got[nm], np.asarray(want[nm]), f"diff of {nm}")
    assert np.abs(got["conv" if variant == "end" else "data"]).sum() > 0
    if variant == "diffs":
        assert not got["c2"].any() or np.abs(got["c2"]).sum() > 0
        assert not np.allclose(got["c1"], got["conv"])    # a top's own branch


def test_backward_nonfloat_input_and_unknown_blob():
    tnet = TNet(t_tf.parse(DIFF_NET), phase="TRAIN", compute_dtype=None, device="cpu")
    xs = _diff_inputs()
    xs["label"] = xs["label"].astype(np.int32)
    got = tnet.backward(diffs=["label", "ip"], **xs)
    np.testing.assert_array_equal(got["label"], np.zeros(2, np.float32))
    with pytest.raises(KeyError, match="unknown blobs"):
        tnet.backward(diffs=["nosuchblob"], **xs)
    with pytest.raises(ValueError, match="seed diffs"):
        tnet.backward(start="ip", **xs)
    from deepcut_tpu_torch.parallel.mesh import Mesh

    # a spatial mesh takes the plan-splitting step, planned at its first call
    step = tnet.make_train_step(t_ur.SolverConfig(),
                                mesh=Mesh(None, 0, 1, 2, torch.device("cpu")))
    assert callable(step) and step.plans == {}


def test_compat_backward_and_blob_diff():
    """compat.Net.backward fills each blob's .diff: the inputs', the named
    blobs', and the end layer's tops; a start layer is seeded from the
    staged .diff of its tops; kwargs are top diffs of the net's outputs."""
    net = t_caffe.Net._from_graph(nets(DIFF_NET)[1])
    for nm, v in _diff_inputs().items():
        net.blobs[nm].data[...] = v
    net.forward()
    full = net.backward(diffs=["ip"])
    np.testing.assert_array_equal(net.blobs["ip"].diff, full["ip"])
    np.testing.assert_array_equal(net.blobs["data"].diff, full["data"])
    out_end = net.backward(end="relu")
    np.testing.assert_array_equal(net.blobs["conv"].diff, out_end["conv"])
    net.blobs["ip"].diff[...] = full["ip"]
    part = net.backward(start="ip")
    np.testing.assert_allclose(part["data"], net._net.backward(
        start="ip", cotangents={"ip": full["ip"]}, **_diff_inputs())["data"], rtol=1e-6)
    net.blobs["ip"]._diff = None
    with pytest.raises(ValueError, match="no staged diff"):
        net.backward(start="ip")
    with pytest.raises(Exception, match="do not match net outputs"):
        net.backward(ip=np.ones((2, 3), np.float32))


DROPOUT_NET = """
input: "data" input_shape { dim: 64 dim: 256 }
layer { name: "drop" type: "Dropout" bottom: "data" top: "dp" dropout_param { dropout_ratio: 0.3 } }
"""


def test_dropout_keep_rate_scaling_and_determinism():
    """TRAIN Dropout keeps 1 - ratio of the units (within 0.01 over 16384),
    scales the kept ones by 1/(1 - ratio) exactly as the JAX package does
    (x / (1 - ratio)), draws anew on each forward, the same draws for the
    same seed, and is the identity in TEST."""
    x = (np.abs(np.random.RandomState(0).randn(64, 256)) + 0.5).astype(np.float32)
    a, b = (TNet(t_tf.parse(DROPOUT_NET), phase="TRAIN", device="cpu", seed=5) for _ in range(2))
    d1, d2 = a.forward(data=x)["dp"], a.forward(data=x)["dp"]
    kept = d1 != 0
    assert abs(kept.mean() - 0.7) < 0.01
    np.testing.assert_array_equal(d1[kept], (torch.from_numpy(x) / (1 - 0.3)).numpy()[kept])
    assert not np.array_equal(d1, d2)
    np.testing.assert_array_equal(b.forward(data=x)["dp"], d1)
    test = TNet(t_tf.parse(DROPOUT_NET), phase="TEST", device="cpu")
    np.testing.assert_array_equal(test.forward(data=x)["dp"], x)


def test_dropout_masks_fixed_by_seed_and_iteration():
    """A train step's masks come from (seed, iteration): two nets of one seed
    at the same iteration take the same step; the next iteration draws
    another mask."""
    proto = DROPOUT_NET.replace('dim: 64 dim: 256', 'dim: 8 dim: 16') + """
    input: "t" input_shape { dim: 8 dim: 4 }
    layer { name: "ip" type: "InnerProduct" bottom: "dp" top: "ip"
      inner_product_param { num_output: 4 weight_filler { type: "gaussian" std: 0.3 } } }
    layer { name: "loss" type: "EuclideanLoss" bottom: "ip" bottom: "t" top: "loss" }
    """
    rng = np.random.RandomState(2)
    xs = {"data": rng.randn(8, 16).astype(np.float32), "t": rng.randn(8, 4).astype(np.float32)}
    cfg = t_ur.SolverConfig(base_lr=0.1, momentum=0.0, weight_decay=0.0)
    runs = []
    for it in (0, 0, 1):
        net = TNet(t_tf.parse(proto), phase="TRAIN", device="cpu", seed=1)
        state = t_ur.init_state(cfg, net.params)
        state["iter"] = it
        _, _, loss = net.make_train_step(cfg)(net.params, state, xs)
        runs.append((float(loss), net.params["ip"]["w"].clone()))
    assert runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])
    assert runs[0][0] != runs[2][0]


def test_stochastic_pool_train_samples_in_proportion():
    """TRAIN STOCHASTIC pooling outputs an element of its window, picked in
    proportion to its value (windows of 1, 2, 3, 4: frequencies within 0.02
    of 0.1 .. 0.4 over 4096 windows), with gradient to the picked element
    alone; TEST is the weighted average, as the JAX package's."""
    proto = """
    input: "data" input_shape { dim: 4 dim: 64 dim: 8 dim: 8 }
    layer { name: "pool" type: "Pooling" bottom: "data" top: "pool"
      pooling_param { pool: STOCHASTIC kernel_size: 2 stride: 2 } }
    layer { name: "loss" type: "EuclideanLoss" bottom: "pool" bottom: "t" top: "loss" }
    input: "t" input_shape { dim: 4 dim: 64 dim: 4 dim: 4 }
    """
    x = np.tile(np.array([[1.0, 2.0], [3.0, 4.0]], np.float32), (4, 64, 4, 4))
    net = TNet(t_tf.parse(proto), phase="TRAIN", device="cpu")
    out = net.forward(data=x, t=np.zeros((4, 64, 4, 4), np.float32))["pool"]
    freq = np.array([(out == v).mean() for v in (1, 2, 3, 4)])
    assert np.abs(freq - np.array([0.1, 0.2, 0.3, 0.4])).max() < 0.02 and freq.sum() == 1.0
    jnet, tnet = nets(proto, phase="TEST")
    t = np.zeros((4, 64, 4, 4), np.float32)
    assert_close(tnet.forward(data=x, t=t)["pool"], jnet.forward(data=x, t=t)["pool"], "TEST")
    xt = torch.from_numpy(x).requires_grad_()
    from deepcut_tpu_torch.ops.pool import stochastic_pool2d_train

    y = stochastic_pool2d_train(xt, torch.Generator().manual_seed(0), kernel=2, stride=2)
    (g,) = torch.autograd.grad(y.sum(), xt)
    assert g.sum() == y.numel() and set(np.unique(g.numpy())) <= {0.0, 1.0}
    np.testing.assert_array_equal(np.sort(x[g.numpy() == 1]), np.sort(y.detach().numpy().ravel()))


def test_bn_train_statistics_get_no_gradient():
    """BatchNorm in TRAIN normalises with the batch moments, its moving
    averages follow Caffe's formulas, and its statistics blobs get no
    gradient (lr_mult 0 whatever the prototxt says)."""
    proto = """
    input: "data" input_shape { dim: 4 dim: 3 dim: 5 dim: 5 }
    layer { name: "bn" type: "BatchNorm" bottom: "data" top: "bn"
      param { lr_mult: 5 } param { lr_mult: 5 } param { lr_mult: 5 }
      batch_norm_param { moving_average_fraction: 0.9 } }
    layer { name: "loss" type: "EuclideanLoss" bottom: "bn" bottom: "t" top: "loss" }
    input: "t" input_shape { dim: 4 dim: 3 dim: 5 dim: 5 }
    """
    rng = np.random.RandomState(4)
    xs = {"data": (rng.randn(4, 3, 5, 5) * 3 + 1).astype(np.float32),
          "t": rng.randn(4, 3, 5, 5).astype(np.float32)}
    jnet, tnet = nets(proto)
    assert tnet._lr_mults["bn"] == {"mean": 0.0, "var": 0.0, "scale_factor": 0.0}
    y = tnet.forward(**xs)["bn"]
    assert_close(y, jnet.forward(**xs)["bn"], "batch-normalised")
    assert np.abs(y.mean(axis=(0, 2, 3))).max() < 1e-5
    cfg = dict(base_lr=0.5, momentum=0.0, weight_decay=0.1)
    before = {k: v.clone() for k, v in tnet.params["bn"].items()}
    tp, _, _ = tnet.make_train_step(t_ur.SolverConfig(**cfg))(
        tnet.params, t_ur.init_state(t_ur.SolverConfig(**cfg), tnet.params), xs)
    jp, _, _ = jax.jit(jnet.make_train_step(j_ur.SolverConfig(**cfg)))(
        jnet.params, j_ur.init_state(j_ur.SolverConfig(**cfg), jnet.params),
        {k: jnp.asarray(_nhwc(v)) for k, v in xs.items()})
    m = 4 * 5 * 5
    x64 = xs["data"].astype(np.float64)
    mean, var = x64.mean(axis=(0, 2, 3)), x64.var(axis=(0, 2, 3))
    np.testing.assert_allclose(tp["bn"]["mean"], 0.9 * before["mean"].numpy() + mean, rtol=1e-5)
    np.testing.assert_allclose(tp["bn"]["var"], 0.9 * before["var"].numpy() + m / (m - 1) * var,
                               rtol=1e-5)
    assert_trees_close(graph_params_to_numpy(tp, tnet.layer_types()),
                       jax.tree_util.tree_map(np.asarray, jp), "bn")


def test_forward_in_train_runs_the_train_forms():
    """Net.forward of a TRAIN net normalises BatchNorm with the batch's
    moments (as the JAX package's forward) and a TEST net with the stored
    statistics; the TRAIN forward leaves the statistics as they are."""
    jnet, tnet = nets(FEATURE_NET)
    xs = feature_inputs(3)
    before = tnet.params["bn1"]["mean"].clone()
    got, want = tnet.forward(**xs), jnet.forward(**xs)
    for k in ("conv1", "pool1", "loss"):
        assert_close(got[k], want[k], k)
    assert torch.equal(tnet.params["bn1"]["mean"], before)
