"""The port's GraphSolver (`deepcut_tpu_torch.solver.solver`), the pycaffe
Solver family (`deepcut_tpu_torch.compat`) and the CLI's `train` verb for a
generic prototxt net, on the CPU, against the JAX package's where both run.

- `SolverParams` parses the same fields as the JAX package's, and
  `test_net_sources` orders the test nets the same way.
- Snapshot interchange: a `.npz` written by either package's GraphSolver
  is restored by the other, and the two then continue the same trajectory
  (params within 2e-5 of each blob's largest magnitude, as
  tests/test_torch_engine_training.py; the same constant inputs staged
  through `extra_inputs`).
- The multi-test-net cases of tests/test_solver_multinet.py that need no
  LMDB, with MemoryData and DummyData in place of its Data layer, and
  tests/test_compat_solver.py's facade cases.
- A step's Dropout masks are fixed by the seed and the iteration, so a
  restored solver takes the step the uninterrupted one took.
- `cli train` runs a DummyData solver.
- The data slice: a LeNet-width net fed by a Data layer on an LMDB (its
  test net on a LevelDB) trains 5 steps on the same trajectory as the JAX
  package's (loss and params within 2e-5 of each blob's scale), a
  `.solverstate` written by either package restores in the other with the
  same history and iteration, and `snapshot_format: HDF5` writes the same
  weights as the `.caffemodel`.
"""

import dataclasses
import glob
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from deepcut_tpu.solver.solver import GraphSolver as JSolver
from deepcut_tpu.solver.solver import SolverParams as JParams
from deepcut_tpu_torch import compat as caffe
from deepcut_tpu_torch.models.convert import graph_params_to_numpy
from deepcut_tpu_torch.proto.caffemodel import load_caffemodel
from deepcut_tpu_torch.proto import text_format as t_tf
from deepcut_tpu_torch.solver.solver import GraphSolver, SolverParams
from deepcut_tpu_torch.tools import cli
from test_torch_engine_training import assert_trees_close

QUIET = dict(handle_signals=False, log=lambda *_: None)

MEM_NET = """
name: "memnet"
layer { name: "data" type: "MemoryData" top: "data" top: "label" include { phase: TRAIN }
  memory_data_param { batch_size: 4 channels: 2 height: 3 width: 3 } }
layer { name: "data" type: "MemoryData" top: "data" top: "label" include { phase: TEST }
  memory_data_param { batch_size: 2 channels: 2 height: 3 width: 3 } }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param { num_output: 2 weight_filler { type: "gaussian" std: 0.1 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" top: "loss" }
layer { name: "accuracy" type: "Accuracy" bottom: "ip" bottom: "label" top: "accuracy"
  include { phase: TEST } }
"""

STAGES = """
layer { name: "markA" type: "DummyData" top: "mark" include { phase: TEST stage: "A" }
  dummy_data_param { data_filler { type: "constant" value: 1 } shape { dim: 1 } } }
layer { name: "markB" type: "DummyData" top: "mark" include { phase: TEST stage: "B" }
  dummy_data_param { data_filler { type: "constant" value: 2 } shape { dim: 1 } } }
"""

DUMMY_NET = """
name: "dummynet"
layer { name: "data" type: "DummyData" top: "data" top: "label"
  dummy_data_param { shape { dim: 4 dim: 6 } shape { dim: 4 }
    data_filler { type: "constant" value: 0.5 } data_filler { type: "constant" value: 1 } } }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param { num_output: 3 weight_filler { type: "gaussian" std: 0.3 } } }
layer { name: "relu" type: "ReLU" bottom: "ip" top: "ip" }
layer { name: "ip2" type: "InnerProduct" bottom: "ip" top: "ip2"
  inner_product_param { num_output: 3 weight_filler { type: "gaussian" std: 0.3 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip2" bottom: "label" top: "loss" }
"""


def solver_text(extra, max_iter=4):
    return f"""
base_lr: 0.1
momentum: 0.9
lr_policy: "fixed"
display: 0
max_iter: {max_iter}
snapshot: 0
{extra}
"""


def mem_arrays(n=8, seed=0):
    rng = np.random.RandomState(seed)
    label = np.arange(n) % 2
    data = rng.randn(n, 2, 3, 3).astype(np.float32) + label[:, None, None, None] * 2.0
    return data, label.astype(np.float32)


def feed(solver, n=8):
    """MemoryData arrays for the train net and every test net."""
    solver.net.set_input_arrays(*mem_arrays(n))
    for tnet, _ in solver._init_test_nets():
        tnet.set_input_arrays(*mem_arrays(n, seed=1))
    return solver


def write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return path


def test_solver_params_match_jax(tmp_path):
    text = solver_text(f"""
net: "{tmp_path}/n.prototxt"
type: "Adam" momentum2: 0.99 delta: 1e-7 weight_decay: 0.002 regularization_type: "L1"
clip_gradients: 5 iter_size: 3 average_loss: 7 random_seed: 11 snapshot_prefix: "x/y"
test_interval: 5 test_iter: 2 test_iter: 3 test_state {{ stage: "A" }} test_state {{ stage: "B" }}
test_initialization: false test_compute_loss: true snapshot_after_train: false
snapshot_diff: true debug_info: true train_state {{ stage: "S" level: 2 }}
lr_policy: "multistep" stepvalue: 10 stepvalue: 20 gamma: 0.3
""")
    got, want = SolverParams.from_prototxt(text), JParams.from_prototxt(text)
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
    node_free = lambda p: {k: v for k, v in dataclasses.asdict(p).items()  # noqa: E731
                           if k not in ("config", "train_state", "test_states", "net_param",
                                        "train_net_param", "test_net_params")}
    assert node_free(got) == node_free(want)
    assert got.resolve_train_net() == want.resolve_train_net()
    assert ([s[1:] for s in got.test_net_sources()] == [s[1:] for s in want.test_net_sources()]
            == [(2, ("A",), None), (3, ("B",), None)])


def _interchange_solvers(tmp_path, rule):
    net = write(tmp_path, "dummy.prototxt", DUMMY_NET)
    sp_text = solver_text(f'net: "{net}"\ntype: "{rule}"\nsnapshot_prefix: "{tmp_path}/snap"')
    x = np.random.RandomState(3).randn(4, 6).astype(np.float32)
    extra = {"data": x, "label": np.array([0, 1, 2, 1], np.float32)}
    return (SolverParams.from_prototxt(sp_text), JParams.from_prototxt(sp_text), extra)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("rule", ["SGD", "Adam"])
def test_snapshot_interchange_continues_the_trajectory(tmp_path, writer, rule):
    """One package trains 3 steps and snapshots, the other restores the
    .npz, and both continue 2 steps: the same params and solver state."""
    tsp, jsp, extra = _interchange_solvers(tmp_path, rule)
    port, jx = GraphSolver(tsp, device="cpu", **QUIET), JSolver(jsp, **QUIET)
    jx.net.params = jax.tree_util.tree_map(
        np.asarray, graph_params_to_numpy(port.net.params, port.net.layer_types()))
    for s in (port, jx):
        s.extra_inputs = dict(extra)
    first, second = (port, jx) if writer == "port" else (jx, port)
    first.step(3)
    second.restore(first.snapshot())
    assert second.iter == first.iter == 3
    first.step(2)
    second.step(2)
    assert_trees_close(graph_params_to_numpy(port.net.params, port.net.layer_types()),
                       jax.tree_util.tree_map(np.asarray, jx.net.params), "param")
    key = "history" if rule == "SGD" else "v"
    assert_trees_close(graph_params_to_numpy(port.state[key], port.net.layer_types()),
                       jax.tree_util.tree_map(np.asarray, jx.state[key]), key)


def test_caffemodel_export_and_snapshot_diff(tmp_path):
    """snapshot writes the .caffemodel in Caffe's layouts; with snapshot_diff
    each blob's diff is its last update (P_prev - P_now over two interval
    snapshots)."""
    net = write(tmp_path, "dummy.prototxt", DUMMY_NET)
    sp = SolverParams.from_prototxt(solver_text(
        f'train_net: "{net}"\nsnapshot_prefix: "{tmp_path}/sd"\nsnapshot_diff: true',
        max_iter=2).replace("snapshot: 0", "snapshot: 1"))
    solver = GraphSolver(sp, device="cpu", **QUIET)
    solver.solve()
    m1, m2 = (load_caffemodel(str(tmp_path / f"sd_iter_{i}.caffemodel")) for i in (1, 2))
    assert list(m2) == ["ip", "ip2"]
    for name, blobs in m2.items():
        for b1, b2 in zip(m1[name], blobs):
            np.testing.assert_allclose(b2.diff, b1.data - b2.data, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(m2["ip"][0].data.reshape(3, 6),
                                  solver.net.params["ip"]["w"].numpy())
    pytest.importorskip("h5py")
    from deepcut_tpu_torch.proto.caffemodel import decode_solverstate

    sp_h5 = dataclasses.replace(sp, snapshot_format="HDF5")
    h5_solver = GraphSolver(sp_h5, device="cpu", **QUIET)
    h5_solver.net.params = solver.net.params
    h5_solver.state["iter"] = 2
    h5_solver.snapshot()
    h5 = load_caffemodel(str(tmp_path / "sd_iter_2.caffemodel.h5"))
    assert list(h5) == list(m2)
    for name, blobs in m2.items():
        for a, b in zip(h5[name], blobs):
            np.testing.assert_array_equal(a.data.reshape(b.data.shape), b.data)
    it, learned, _, _ = decode_solverstate((tmp_path / "sd_iter_2.solverstate").read_bytes())
    assert it == 2 and learned == f"{tmp_path}/sd_iter_2.caffemodel.h5"


def test_multiple_test_nets_with_test_state_and_ordering(tmp_path):
    """Solver::InitTestNets: an inline test_net_param, then a test_net file,
    then instances of the generic net, each with its test_state and its own
    test_iter; TestAll runs them in order (tests/test_solver_multinet.py)."""
    generic = write(tmp_path, "net.prototxt", MEM_NET + STAGES)
    mark = lambda v: MEM_NET + (  # noqa: E731
        f'layer {{ name: "mark" type: "DummyData" top: "mark" include {{ phase: TEST }} '
        f'dummy_data_param {{ data_filler {{ type: "constant" value: {v} }} shape {{ dim: 1 }} }} }}')
    file_net = write(tmp_path, "file.prototxt", mark(20))
    sp = SolverParams.from_prototxt(solver_text(f"""
net: "{generic}"
test_interval: 2
test_iter: 1 test_iter: 2 test_iter: 3 test_iter: 1
test_net_param {{ {mark(10)} }}
test_net: "{file_net}"
test_state {{ }} test_state {{ }} test_state {{ stage: "A" }} test_state {{ stage: "B" }}
"""))
    logs = []
    solver = feed(GraphSolver(sp, device="cpu", handle_signals=False, log=logs.append))
    assert [iters for _, iters in solver._init_test_nets()] == [1, 2, 3, 1]
    results = solver.test_all()
    assert [r["mark"] for r in results] == [10.0, 20.0, 1.0, 2.0]
    assert all(0 <= r["accuracy"] <= 1 for r in results)
    assert sum("Testing net (#" in ln for ln in logs) == 4
    assert any("(* 1 = " in ln for ln in logs)       # the loss output's weighted line


def test_solver_net_sources_and_states(tmp_path):
    """net_param inline trains; train_net_param with train_state stages;
    exactly one train net source; test_iter per test net; the net's own
    state merges (tests/test_solver_multinet.py)."""
    sp = SolverParams.from_prototxt(solver_text(f"net_param {{ {MEM_NET} }}"))
    solver = feed(GraphSolver(sp, device="cpu", **QUIET))
    solver.solve()
    assert solver.iter == 4 and np.isfinite(solver.smoothed_loss)
    staged = MEM_NET + ('layer { name: "extra" type: "Power" bottom: "ip" top: "extra" '
                        'include { phase: TRAIN stage: "S" } }')
    for state, present in (('train_state { stage: "S" }', True), ("", False)):
        sp = SolverParams.from_prototxt(solver_text(f"train_net_param {{ {staged} }}\n{state}"))
        names = [s.name for _, s in GraphSolver(sp, device="cpu", **QUIET).net._plan]
        assert ("extra" in names) == present
    path = write(tmp_path, "n.prototxt", MEM_NET)
    with pytest.raises(ValueError, match="more than one"):
        GraphSolver(SolverParams.from_prototxt(solver_text(
            f'net: "{path}"\ntrain_net: "{path}"')), device="cpu", **QUIET)
    with pytest.raises(ValueError, match="must specify a train net"):
        GraphSolver(SolverParams.from_prototxt(solver_text("")), device="cpu", **QUIET)
    sp = SolverParams.from_prototxt(solver_text(
        f'train_net: "{path}"\ntest_net: "{path}"\ntest_net: "{path}"\ntest_interval: 2\n'
        'test_iter: 1'))
    with pytest.raises(ValueError, match="test_iter"):
        GraphSolver(sp, device="cpu", **QUIET)._init_test_nets()
    from deepcut_tpu_torch.core.graph import Net

    own = Net(t_tf.parse('state { stage: "A" }\n' + MEM_NET + STAGES), phase="TEST",
              device="cpu")
    assert {"markA"} == {s.name for _, s in own._plan} & {"markA", "markB"}


@pytest.mark.parametrize("flag", ["test_initialization", "test_compute_loss",
                                  "snapshot_after_train", "debug_info"])
def test_solver_flags(tmp_path, flag):
    path = write(tmp_path, "n.prototxt", MEM_NET)
    base = f'net: "{path}"\ntest_interval: 2\ntest_iter: 2\nsnapshot_prefix: "{tmp_path}/snap"\n'
    logs = []

    def run(extra, steps=2):
        sp = SolverParams.from_prototxt(solver_text(base + extra))
        sp.display = 1 if flag == "debug_info" else 0
        logs.clear()
        solver = feed(GraphSolver(sp, device="cpu", handle_signals=False, log=logs.append))
        solver.step(steps) if steps else solver.solve()
        return solver

    if flag == "test_initialization":      # the iteration-0 test pass
        run("test_initialization: true")
        assert sum("Testing net" in ln for ln in logs) == 1
        run("test_initialization: false")
        assert sum("Testing net" in ln for ln in logs) == 0
    elif flag == "test_compute_loss":      # the averaged weighted test loss
        solver = run("test_compute_loss: true", steps=0)
        avgs = solver.test()
        (line,) = [ln for ln in logs if ln.startswith("Test loss:")][-1:]
        assert float(line.split(":")[1]) == pytest.approx(avgs["loss"], rel=1e-5)
    elif flag == "snapshot_after_train":
        run("snapshot_after_train: false", steps=0)
        assert not glob.glob(str(tmp_path / "snap*"))
        run("", steps=0)
        assert glob.glob(str(tmp_path / "snap_iter_4.caffemodel"))
    else:                                  # the per-blob and per-param stream
        run("debug_info: true")
        assert any("[Forward] Blob ip, data:" in ln for ln in logs)
        assert any("[Backward] Param ip/w, data:" in ln for ln in logs)


def test_dropout_step_after_restore_is_the_uninterrupted_step(tmp_path):
    """A step's Dropout mask comes from (seed, iteration): the step after a
    restore is the step the uninterrupted solver took."""
    net = write(tmp_path, "drop.prototxt", DUMMY_NET.replace(
        'layer { name: "relu"',
        'layer { name: "drop" type: "Dropout" bottom: "ip" top: "ip" }\nlayer { name: "relu"'))
    sp = SolverParams.from_prototxt(solver_text(
        f'net: "{net}"\nsnapshot_prefix: "{tmp_path}/d"\nrandom_seed: 3'))
    a = GraphSolver(sp, device="cpu", **QUIET)
    a.step(2)
    path = a.snapshot()
    a.step(1)
    b = GraphSolver(sp, device="cpu", **QUIET)
    b.restore(path)
    b.step(1)
    for name, entry in a.net.params.items():
        for k, v in entry.items():
            assert torch.equal(v, b.net.params[name][k]), (name, k)
    assert a._loss_window[-1] == b._loss_window[-1]


# -- the pycaffe facade (tests/test_compat_solver.py) -------------------------------
@pytest.fixture
def solver_file(tmp_path):
    net = write(tmp_path, "net.prototxt", DUMMY_NET.replace(
        'data_filler { type: "constant" value: 0.5 }', 'data_filler { type: "gaussian" std: 1 }'))
    return str(write(tmp_path, "solver.prototxt", solver_text(
        f'net: "{net}"\nsnapshot_prefix: "{tmp_path}/s"', max_iter=12)))


def test_get_solver_typed_classes_and_live_net(solver_file):
    solver = caffe.get_solver(solver_file, device="cpu")
    w0 = solver.net.params["ip"][0].data.copy()
    solver.step(5)
    assert solver.iter == 5 and not np.allclose(w0, solver.net.params["ip"][0].data)
    solver.solve()
    assert solver.iter == 12 and np.isfinite(solver.smoothed_loss)
    again = caffe.get_solver(solver_file, device="cpu")
    again.restore(solver.snapshot())
    assert again.iter == 12
    np.testing.assert_array_equal(again.net.params["ip"][0].data, solver.net.params["ip"][0].data)
    for cls, rule in ((caffe.SGDSolver, "SGD"), (caffe.NesterovSolver, "Nesterov"),
                      (caffe.AdaGradSolver, "AdaGrad"), (caffe.RMSPropSolver, "RMSProp"),
                      (caffe.AdaDeltaSolver, "AdaDelta"), (caffe.AdamSolver, "Adam")):
        s = cls(solver_file, device="cpu")
        assert s._solver.params_cfg.config.solver_type == rule and isinstance(s, caffe.Solver)
        s.step(2)
        assert s.iter == 2 and np.isfinite(s.smoothed_loss)


def test_test_nets_share_the_trained_layers(tmp_path):
    """solver.test_nets see the live training params, and their MemoryData
    takes set_input_arrays."""
    path = write(tmp_path, "n.prototxt", MEM_NET)
    sol = write(tmp_path, "s.prototxt", solver_text(f'net: "{path}"\ntest_iter: 1\n'
                                                    'test_interval: 100'))
    solver = caffe.get_solver(str(sol), device="cpu")
    solver.net.set_input_arrays(*mem_arrays())
    (tnet,) = solver.test_nets
    tnet.set_input_arrays(*mem_arrays(seed=1))
    solver.step(3)
    assert tnet._net.params is solver.net._net.params
    assert solver.test_nets[0] is tnet
    out = tnet.forward()
    assert set(out) == {"loss", "accuracy"} and 0 <= float(out["accuracy"][0]) <= 1


def test_facade_net_surface(tmp_path):
    """blob_loss_weights, forward_backward_all, set_input_arrays, and the
    fill-once DummyData tops through compat.Net."""
    deploy = write(tmp_path, "d.prototxt", """
    input: "data" input_shape { dim: 2 dim: 5 }
    input: "tgt" input_shape { dim: 2 dim: 3 }
    layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
      inner_product_param { num_output: 3 weight_filler { type: "gaussian" std: 0.4 } } }
    layer { name: "loss" type: "EuclideanLoss" bottom: "ip" bottom: "tgt" top: "loss"
      loss_weight: 2.0 }
    """)
    net = caffe.Net(str(deploy), caffe.TEST, device="cpu")
    lw = net.blob_loss_weights
    assert lw["loss"] == 2.0 and lw["ip"] == 0.0 and lw["data"] == 0.0
    X = np.random.RandomState(2).randn(6, 5).astype(np.float32)
    T = np.random.RandomState(3).randn(6, 3).astype(np.float32)
    outs, diffs = net.forward_backward_all(blobs=["ip"], data=X, tgt=T)
    assert outs["ip"].shape == (6, 3) and diffs["data"].shape == (6, 5)
    w = net._net.params["ip"]["w"].numpy()
    ip = X @ w.T + net._net.params["ip"]["b"].numpy()
    np.testing.assert_allclose(diffs["data"], 2.0 * (ip - T) / 2 @ w, rtol=1e-4, atol=1e-6)
    assert np.all(net.params["ip"][0].diff == 0)
    mem = caffe.Net(str(write(tmp_path, "m.prototxt", MEM_NET)), caffe.TEST, device="cpu")
    mem.set_input_arrays(*mem_arrays())
    assert mem.forward()["loss"].size == 1
    dd = caffe.Net(str(write(tmp_path, "dd.prototxt", DUMMY_NET)), caffe.TRAIN, device="cpu")
    dd.forward()
    np.testing.assert_array_equal(dd.blobs["label"].data, 1.0)
    dd.blobs["label"].data[...] = [0, 2, 2, 1]
    dd.forward()
    np.testing.assert_array_equal(dd.blobs["label"].data, [0, 2, 2, 1])


def test_extra_inputs_reach_the_train_step(tmp_path):
    """GraphSolver.extra_inputs staged over a fill-once top reach every step."""
    path = write(tmp_path, "n.prototxt", DUMMY_NET)
    sp = SolverParams.from_prototxt(solver_text(f'net: "{path}"').replace("base_lr: 0.1",
                                                                          "base_lr: 0.0"))

    def loss_with(label):
        s = GraphSolver(sp, device="cpu", **QUIET)
        s.extra_inputs = {"label": np.asarray(label, np.float32)}
        s.step(1)
        return s.smoothed_loss

    assert loss_with([0, 0, 0, 0]) == loss_with([0, 0, 0, 0]) != loss_with([2, 2, 2, 2])


def test_cli_train_graph_solver(tmp_path, capsys):
    """`train` on a solver without a PoseData layer runs GraphSolver:
    -weights finetunes by layer name, -snapshot resumes, TF32 is off."""
    net = write(tmp_path, "net.prototxt", DUMMY_NET)
    sol = write(tmp_path, "solver.prototxt", solver_text(
        f'net: "{net}"\nsnapshot_prefix: "{tmp_path}/c"', max_iter=4).replace("display: 0",
                                                                            "display: 2"))
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        assert cli.main(["train", "-solver", str(sol), "-device", "cpu"]) == 0
        assert (tmp_path / "c_iter_4.npz").is_file() and (tmp_path / "c_iter_4.caffemodel").is_file()
        assert cli.main(["train", "-solver", str(sol), "-device", "cpu",
                         "-weights", str(tmp_path / "c_iter_4.caffemodel")]) == 0
        out = capsys.readouterr().out
        assert "TF32 off" in out and "Iteration 2, loss = " in out and "Optimization Done." in out
        more = write(tmp_path, "more.prototxt", sol.read_text().replace("max_iter: 4", "max_iter: 6"))
        assert cli.main(["train", "-solver", str(more), "-device", "cpu",
                         "-snapshot", str(tmp_path / "c_iter_4.npz")]) == 0
        assert "Restored from" in capsys.readouterr().out
        assert (tmp_path / "c_iter_6.npz").is_file()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


# -- the data slice ----------------------------------------------------------------------
def lenet_data(tmp_path):
    """A LeNet train net (BVLC widths 20 / 50 / 500 / 10, batch 32) fed by
    a Data layer on an LMDB of 40 seeded 28x28 digits, its test net by one
    on a LevelDB of 16, as examples/mnist/lenet_train.prototxt."""
    from deepcut_tpu.data.datum import Datum
    from deepcut_tpu.data.leveldb_store import LevelDBWriter
    from deepcut_tpu.data.lmdb_store import LMDBWriter

    rng = np.random.RandomState(0)
    for writer, name, n in ((LMDBWriter, "train_lmdb", 40), (LevelDBWriter, "val_leveldb", 16)):
        with writer(str(tmp_path / name)) as w:
            for i in range(n):
                img = rng.randint(0, 256, (1, 28, 28), np.uint8)
                w.put(f"{i:08d}".encode(), Datum.from_array(img, i % 10).encode())
    text = (Path(__file__).resolve().parents[1] / "examples/mnist/lenet_train.prototxt").read_text()
    text = text.replace('source: "examples/mnist/train_lmdb"', f'source: "{tmp_path}/train_lmdb"')
    text = text.replace("  top: \"label\"\n", "  top: \"label\"\n  include { phase: TRAIN }\n", 1)
    text += (f'layer {{ name: "mnist" type: "Data" top: "data" top: "label" include {{ phase: TEST }} '
             f'transform_param {{ scale: 0.00390625 }} data_param {{ source: "{tmp_path}/val_leveldb" '
             'batch_size: 8 backend: LEVELDB } }\n'
             'layer { name: "accuracy" type: "Accuracy" bottom: "ip2" bottom: "label" '
             'top: "accuracy" include { phase: TEST } }\n')
    net = write(tmp_path, "lenet.prototxt", text)
    return write(tmp_path, "lenet_solver.prototxt", f"""
net: "{net}"
base_lr: 0.01 momentum: 0.9 weight_decay: 0.0005 lr_policy: "inv" gamma: 0.0001 power: 0.75
display: 0 max_iter: 5 snapshot: 0 test_iter: 2 test_interval: 100 test_initialization: false
snapshot_prefix: "{tmp_path}/lenet" random_seed: 1
""")


def test_lmdb_lenet_trajectory_matches_jax(tmp_path):
    """5 SGD steps of LeNet from an LMDB, each package pulling its own
    batches through its Data layer: the same losses and params within 2e-5
    of each blob's scale, and the same test outputs from the LevelDB."""
    sol = lenet_data(tmp_path)
    port = GraphSolver(SolverParams.from_prototxt(str(sol)), device="cpu", **QUIET)
    jx = JSolver(JParams.from_prototxt(str(sol)), **QUIET)
    jx.net.params = jax.tree_util.tree_map(
        np.asarray, graph_params_to_numpy(port.net.params, port.net.layer_types()))
    try:
        for _ in range(5):
            port.step(1)
            jx.step(1)
            lt, lj = port._loss_window[-1], jx._loss_window[-1]
            assert abs(lt - lj) <= 2e-5 * abs(lj), (lt, lj)
        assert port.iter == jx.iter == 5
        assert_trees_close(graph_params_to_numpy(port.net.params, port.net.layer_types()),
                           jax.tree_util.tree_map(np.asarray, jx.net.params), "param")
        (got,), (want,) = port.test_all(), jx.test_all()
        assert sorted(got) == sorted(want) == ["accuracy", "loss"]
        assert got["accuracy"] == want["accuracy"]
        assert abs(got["loss"] - want["loss"]) <= 2e-5 * abs(want["loss"])
    finally:
        port.close()
        for net in [jx.net] + [n for n, _ in jx._init_test_nets()]:
            for src in net.data_sources.values():
                src.stop()
    assert all(src._pf is None for src in port.net.data_sources.values())


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("rule", ["SGD", "AdaDelta"])
def test_solverstate_restores_across_packages(tmp_path, writer, rule):
    """A `.solverstate` (history blobs in the JAX package's layouts, dicts
    in sorted key order, AdaDelta's history then update_sq) written by one
    package restores in the other: the same history bit for bit, the same
    iteration, the learned_net's weights, then the same 2 more steps."""
    from deepcut_tpu.proto.caffemodel import decode_solverstate as j_decode
    from deepcut_tpu_torch.proto.caffemodel import decode_solverstate

    tsp, jsp, extra = _interchange_solvers(tmp_path, rule)
    port, jx = GraphSolver(tsp, device="cpu", **QUIET), JSolver(jsp, **QUIET)
    jx.net.params = jax.tree_util.tree_map(
        np.asarray, graph_params_to_numpy(port.net.params, port.net.layer_types()))
    for s in (port, jx):
        s.extra_inputs = dict(extra)
    first, second = (port, jx) if writer == "port" else (jx, port)
    first.step(3)
    first.snapshot()
    path = f"{tmp_path}/snap_iter_3.solverstate"
    buf = open(path, "rb").read()
    it, learned, blobs, _ = decode_solverstate(buf)
    assert (it, learned) == j_decode(buf)[:2] == (3, f"{tmp_path}/snap_iter_3.caffemodel")
    assert len(blobs) == (8 if rule == "AdaDelta" else 4)
    second.restore(path)
    assert second.iter == first.iter == 3
    types = port.net.layer_types()
    for key in ("history", "update_sq") if rule == "AdaDelta" else ("history",):
        got = graph_params_to_numpy(port.state[key], types)
        want = jax.tree_util.tree_map(np.asarray, jx.state[key])
        for n, e in want.items():
            for k, v in e.items():
                np.testing.assert_array_equal(got[n][k], v, err_msg=f"{key} {n}/{k}")
    assert_trees_close(graph_params_to_numpy(port.net.params, types),
                       jax.tree_util.tree_map(np.asarray, jx.net.params), "param")
    first.step(2)
    second.step(2)
    assert_trees_close(graph_params_to_numpy(port.net.params, types),
                       jax.tree_util.tree_map(np.asarray, jx.net.params), "param")
