"""Data-parallel training in the port (`parallel.mesh`, `parallel.distributed`,
the `mesh=` paths of `Net.make_train_step`, `parallel.train_step`,
`GraphSolver` and `PoseSolver`), over gloo on the CPU with 2 and 4 ranks.

The `data`-axis cases of tests/test_parallel.py, with torch's idiom of one
process per rank: each rank (a spawned process joined by a gloo group on
localhost) trains on its rows of the global batch, and

- its trajectory (params after each run and the loss of each step) equals
  the port's single device on the global batch within the JAX tests'
  ``rtol=1e-5, atol=1e-6``, for GraphSolver (also with iter_size 2),
  PoseSolver, `parallel.train_step.make_train_step` and a net holding
  BatchNorm in TRAIN and Dropout (torch cannot draw JAX's masks: against
  the port's own single device);
- every rank ends with the same params, bit for bit;
- GraphSolver's and PoseSolver's trajectories also equal the JAX package's
  single device on the same params, at the cross-package tolerances the
  single-device port is held to (2e-5 of each blob's scale for the graph
  engine, tests/test_torch_engine_training.py; 1e-3 of the distance moved
  for PoseSolver, tests/test_torch_solver.py); the JAX package's own tests
  hold its mesh path equal to its single device;
- every loss layer runs with ignore_label (IGNORE_VALUE for the fork's
  SoftmaxWithLossVec) and smooth-L1 weights whose per-rank counts and sums
  differ, so a rank-local normaliser would fail, and Accuracy's counts
  are global;
- an all-reduce planted in a loss's backward falls outside the tolerance.

Each world of ranks is spawned once (module fixtures), and each rank is
joined with a 120 s timeout, so a hung rank fails its tests instead of
the run. The
spawned processes import this module: it imports no jax at module level.
"""

import multiprocessing as mp
import pickle
import socket
from pathlib import Path

import numpy as np
import pytest
import torch

JOIN_S = 120
RTOL, ATOL = 1e-5, 1e-6

GRAPH_NET = """
input: "data"
input_shape { dim: 8 dim: 12 }
input: "label"
input_shape { dim: 8 }
layer { name: "ip1" type: "InnerProduct" bottom: "data" top: "ip1"
        inner_product_param { num_output: 16 weight_filler { type: "xavier" } } }
layer { name: "relu1" type: "ReLU" bottom: "ip1" top: "ip1" }
layer { name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2"
        inner_product_param { num_output: 4 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip2" bottom: "label" top: "loss" }
"""

BN_DROPOUT_NET = """
input: "data"
input_shape { dim: 8 dim: 3 dim: 6 dim: 6 }
input: "label"
input_shape { dim: 8 }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 4 kernel_size: 3 bias_term: false
    weight_filler { type: "gaussian" std: 0.3 } } }
layer { name: "bn1" type: "BatchNorm" bottom: "conv1" top: "conv1" }
layer { name: "sc1" type: "Scale" bottom: "conv1" top: "conv1" scale_param { bias_term: true } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "drop1" type: "Dropout" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: STOCHASTIC kernel_size: 2 stride: 2 } }
layer { name: "ip" type: "InnerProduct" bottom: "pool1" top: "ip"
  inner_product_param { num_output: 3 weight_filler { type: "gaussian" std: 0.3 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" top: "loss" }
"""

LOSS_NET = """
input: "x"
input_shape { dim: 8 dim: 3 dim: 2 dim: 2 }
input: "lab"
input_shape { dim: 8 }
input: "lab3"
input_shape { dim: 8 }
input: "t"
input_shape { dim: 8 dim: 4 }
input: "w"
input_shape { dim: 8 dim: 4 }
input: "y"
input_shape { dim: 8 }
input: "vlab"
input_shape { dim: 8 dim: 4 dim: 2 dim: 2 }
input: "vw"
input_shape { dim: 8 dim: 4 dim: 2 dim: 2 }
layer { name: "s" type: "InnerProduct" bottom: "x" top: "s"
  inner_product_param { num_output: 4 weight_filler { type: "gaussian" std: 0.3 } } }
layer { name: "s2" type: "InnerProduct" bottom: "x" top: "s2"
  inner_product_param { num_output: 4 weight_filler { type: "gaussian" std: 0.3 } } }
layer { name: "pa" type: "InnerProduct" bottom: "x" top: "pa"
  inner_product_param { num_output: 3 weight_filler { type: "gaussian" std: 0.3 } } }
layer { name: "pb" type: "InnerProduct" bottom: "x" top: "pb"
  inner_product_param { num_output: 3 weight_filler { type: "gaussian" std: 0.3 } } }
layer { name: "m" type: "Convolution" bottom: "x" top: "m"
  convolution_param { num_output: 4 kernel_size: 1 weight_filler { type: "gaussian" std: 0.3 } } }
layer { name: "swl_valid" type: "SoftmaxWithLoss" bottom: "s" bottom: "lab" top: "swl_valid"
  loss_param { ignore_label: -1 } }
layer { name: "swl_batch" type: "SoftmaxWithLoss" bottom: "s" bottom: "lab" top: "swl_batch"
  loss_param { ignore_label: -1 normalization: BATCH_SIZE } }
layer { name: "swl_full" type: "SoftmaxWithLoss" bottom: "s" bottom: "lab" top: "swl_full"
  loss_param { ignore_label: -1 normalization: FULL } }
layer { name: "prob" type: "Softmax" bottom: "s2" top: "prob" }
layer { name: "mll" type: "MultinomialLogisticLoss" bottom: "prob" bottom: "lab3" top: "mll" }
layer { name: "info" type: "InfogainLoss" bottom: "prob" bottom: "lab3" top: "info"
  infogain_loss_param { source: "%(H)s" } }
layer { name: "sce" type: "SigmoidCrossEntropyLoss" bottom: "s" bottom: "t" top: "sce" }
layer { name: "euc" type: "EuclideanLoss" bottom: "s2" bottom: "t" top: "euc" }
layer { name: "sl1" type: "SmoothL1Loss" bottom: "s2" bottom: "t" bottom: "w" top: "sl1" }
layer { name: "hinge" type: "HingeLoss" bottom: "s" bottom: "lab3" top: "hinge"
  hinge_loss_param { norm: L2 } }
layer { name: "con" type: "ContrastiveLoss" bottom: "pa" bottom: "pb" bottom: "y" top: "con" }
layer { name: "vec_ce" type: "SoftmaxWithLossVec" bottom: "m" bottom: "vlab" top: "vec_ce"
  softmax_with_loss_vec_param { cross_entropy: true } }
layer { name: "vec_sm" type: "SoftmaxWithLossVec" bottom: "m" bottom: "vlab" bottom: "vw"
  top: "vec_sm" }
layer { name: "acc" type: "Accuracy" bottom: "s" bottom: "lab" top: "acc"
  accuracy_param { ignore_label: -1 } }
"""

SOLVER = """
base_lr: %(lr)s
momentum: 0.9
weight_decay: 0.0005
lr_policy: "fixed"
iter_size: %(iter_size)d
display: 0
max_iter: 100
snapshot: 0
snapshot_prefix: "unused"
random_seed: 0
"""


# -- what a rank runs (also the single-device reference, with mesh=None) ------

def _flat(tree):
    return {f"{n}/{k}": v.detach().cpu().numpy().copy() for n, e in tree.items()
            for k, v in e.items()}


def run_graph(spec, mesh):
    """GraphSolver over `spec["proto"]` from the given params, fed the
    global batches: -> {"losses": [...], "params": {layer/key: array}}."""
    from deepcut_tpu_torch.core.graph import Net
    from deepcut_tpu_torch.ops import losses as loss_ops
    from deepcut_tpu_torch.proto import text_format
    from deepcut_tpu_torch.solver.solver import GraphSolver, SolverParams

    net = Net(text_format.parse(spec["proto"]), weights=spec["params"], phase="TRAIN",
              compute_dtype=None, device="cpu")
    sp = SolverParams.from_prototxt(SOLVER % dict(lr=spec["lr"], iter_size=spec["iter_size"]))
    solver = GraphSolver(sp, net, mesh=mesh, handle_signals=False, log=lambda *_: None,
                         device="cpu")
    batches = iter(spec["batches"])
    solver._next_inputs = lambda: next(batches)
    saved = loss_ops._GlobalSums.backward
    if spec.get("planted"):
        # the fault the design rules out: an all-reduce on the differentiation path
        loss_ops._GlobalSums.backward = staticmethod(
            lambda ctx, g: (mesh.all_reduce_(g.clone()), None))
    try:
        losses = []
        for _ in spec["batches"]:
            solver.step(1)
            losses.append(solver._loss_window[-1])
    finally:
        loss_ops._GlobalSums.backward = saved
    out = {"losses": np.asarray(losses), "params": _flat(net.params)}
    if "acc" in spec:   # Accuracy's counts (ignore_label, per class) on this rank's rows
        from deepcut_tpu_torch.parallel.mesh import shard_batch

        rows = spec["acc"] if mesh is None else shard_batch(mesh, spec["acc"])
        with loss_ops.sharded_losses(mesh):
            total, per_class = loss_ops.accuracy(torch.from_numpy(rows["scores"]),
                                                 torch.from_numpy(rows["labels"]),
                                                 ignore_label=-1, per_class=True)
        out["acc"] = np.concatenate([[float(total)], per_class.numpy()])
    return out


def run_pose(spec, mesh):
    """PoseSolver on the tiny DeeperCut from the given params and batches."""
    from deepcut_tpu_torch.models.convert import params_from_numpy
    from deepcut_tpu_torch.solver.solver import PoseSolver

    batches = iter(spec["batches"])
    solver = PoseSolver(spec["solver"], spec["model_cfg"], lambda: next(batches),
                        net_params=params_from_numpy(spec["params"]), mesh=mesh,
                        handle_signals=False, log=lambda *_: None,
                        target_cfg=spec["target_cfg"], device="cpu")
    losses = []
    for _ in range(spec["steps"]):
        solver.step(1)
        losses.append(float(solver._loss_window[-1]))
    return {"losses": np.asarray(losses), "params": _flat(solver.net_params)}


def run_train_step(spec, mesh):
    """`parallel.train_step.make_train_step` and `make_eval_step`."""
    from deepcut_tpu_torch.models.convert import params_from_numpy
    from deepcut_tpu_torch.parallel.train_step import make_eval_step, make_train_step
    from deepcut_tpu_torch.solver import update_rules

    cfg = spec["solver"].config
    params = params_from_numpy(spec["params"])
    state = update_rules.init_state(cfg, params)
    step = make_train_step(spec["model_cfg"], cfg, mesh)
    losses = []
    for batch in spec["batches"]:
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["total_loss"]))
    images = torch.from_numpy(spec["batches"][0]["image"]).permute(0, 3, 1, 2)
    outs = make_eval_step(spec["model_cfg"], mesh, folded=False)(params, images)
    return {"losses": np.asarray(losses), "params": _flat(params),
            "eval": outs["fc_pose"].numpy().copy()}


RUNNERS = {"graph": run_graph, "pose": run_pose, "train_step": run_train_step}


def _rank_main(rank, world, port, spec_path, out_dir):
    torch.set_num_threads(2)   # up to six ranks share the test worker's cores
    from deepcut_tpu_torch.parallel import distributed
    from deepcut_tpu_torch.parallel.mesh import make_mesh

    distributed.initialize(f"tcp://127.0.0.1:{port}", world, rank, device="cpu")
    try:
        mesh = make_mesh(world)
        assert (mesh.rank, mesh.data, mesh.spatial, str(mesh.device)) == (rank, world, 1, "cpu")
        with open(spec_path, "rb") as f:
            specs = pickle.load(f)
        results = {name: RUNNERS[spec["kind"]](spec, mesh) for name, spec in specs.items()}
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        distributed.shutdown()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world, specs, out_dir):
    """Spawn `world` ranks over gloo, each running every spec; -> each
    rank's results. A rank still alive after JOIN_S is killed and fails."""
    out_dir.mkdir(parents=True, exist_ok=True)
    spec_path = out_dir / "specs.pkl"
    with open(spec_path, "wb") as f:
        pickle.dump(specs, f)
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, str(spec_path), str(out_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} still running after {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * world
    out = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# -- the scenarios (built in the test process, which also runs the references) --

def graph_spec(seed=0, iter_size=1, steps=5):
    from test_torch_engine_training import nets
    from deepcut_tpu_torch.models.convert import graph_params_from_numpy

    jnet, _ = nets(GRAPH_NET, seed=seed)
    params = graph_params_from_numpy(jax_numpy(jnet.params), jnet.layer_types())
    rng = np.random.RandomState(seed)
    x = rng.randn(8, 12).astype(np.float32)
    y = rng.randint(0, 4, (8,)).astype(np.float32)
    batch = {"data": x, "label": y}
    if iter_size > 1:   # the same 8 rows as two micro-batches of 4
        batch = {k: v.reshape((iter_size, 8 // iter_size) + v.shape[1:]) for k, v in batch.items()}
    return jnet, {"kind": "graph", "proto": GRAPH_NET, "lr": 0.1, "iter_size": iter_size,
                  "params": _numpy(params), "batches": [batch] * steps}


def bn_dropout_spec():
    from deepcut_tpu_torch.core.graph import Net
    from deepcut_tpu_torch.proto import text_format

    net = Net(text_format.parse(BN_DROPOUT_NET), phase="TRAIN", compute_dtype=None,
              device="cpu", seed=3)
    rng = np.random.RandomState(4)
    batches = [{"data": rng.randn(8, 3, 6, 6).astype(np.float32) + 0.5,
                "label": rng.randint(0, 3, (8,)).astype(np.float32)} for _ in range(5)]
    return {"kind": "graph", "proto": BN_DROPOUT_NET, "lr": 0.05, "iter_size": 1,
            "params": _numpy(net.params), "batches": batches}


def loss_spec(tmp_path, planted=False):
    from deepcut_tpu_torch.core.graph import Net
    from deepcut_tpu_torch.io import array_to_blobproto_bytes
    from deepcut_tpu_torch.proto import text_format

    h = tmp_path / "H.binaryproto"
    h.write_bytes(array_to_blobproto_bytes(
        (np.eye(4) + 0.1 * np.random.RandomState(5).rand(4, 4)).astype(np.float32)[None, None]))
    proto = LOSS_NET % {"H": h}
    net = Net(text_format.parse(proto), phase="TRAIN", compute_dtype=None, device="cpu", seed=6)
    rng = np.random.RandomState(7)
    batches = []
    for _ in range(3):
        # ignored labels pile up in the first rows: each rank's VALID count differs
        lab = np.array([-1, -1, -1, 2, 0, 1, 3, 2], np.float32)
        vlab = (rng.rand(8, 4, 2, 2) > 0.5).astype(np.float32)
        vlab[:3, :, :, :1] = 1000.0                           # IGNORE_VALUE positions
        vlab[5, 0] = 1000.0
        w = (rng.rand(8, 4) > 0.3).astype(np.float32)
        w[:2] = 0.0                                           # smooth-L1 weight sums differ
        batches.append({"x": rng.randn(8, 3, 2, 2).astype(np.float32),
                        "lab": lab, "lab3": rng.randint(0, 4, (8,)).astype(np.float32),
                        "t": rng.rand(8, 4).astype(np.float32), "w": w,
                        "y": (rng.rand(8) > 0.5).astype(np.float32), "vlab": vlab,
                        "vw": (0.5 + rng.rand(8, 4, 2, 2)).astype(np.float32)})
    acc = {"scores": rng.randn(8, 5).astype(np.float32),
           "labels": np.array([-1, -1, -1, 4, 0, 1, 1, 2], np.float32)}
    return {"kind": "graph", "proto": proto, "lr": 0.05, "iter_size": 1, "planted": planted,
            "params": _numpy(net.params), "batches": batches, "acc": acc}


def pose_spec(kind="pose"):
    """The tiny DeeperCut of tests/test_torch_training.py from tamed params,
    on the JAX test's dense batches (random frames, dense targets); the
    PoseSolver at its rate, `make_train_step` at SGD's plainest (a rate of
    0.01, no momentum or decay: each step subtracts the scaled gradient)."""
    from test_torch_solver import jax_cfg, port_cfg, tame_params
    from deepcut_tpu_torch.solver import solver as ts
    from deepcut_tpu_torch.solver import update_rules as tu

    cfg = port_cfg()
    rule = (dict(solver_type="SGD", base_lr=0.001, momentum=0.9, weight_decay=1e-4)
            if kind == "pose" else dict(solver_type="SGD", base_lr=0.01, momentum=0.0,
                                        weight_decay=0.0))
    sp = ts.SolverParams(config=tu.SolverConfig(**rule), max_iter=100, display=0, snapshot=0,
                         snapshot_prefix="unused")
    return {"kind": kind, "solver": sp, "model_cfg": cfg, "target_cfg": None,
            "params": tame_params(jax_cfg()), "batches": dense_batches(cfg, 3), "steps": 3}


def dense_batches(cfg, n_batches, n=4, h=32, w=32):
    """tests/test_parallel.py's PoseSolver batch: random frames, a part at
    one grid cell, dense locref and pairwise targets, NHWC."""
    out = []
    for i in range(n_batches):
        rng = np.random.RandomState(10 + i)
        hh, ww, j = h // 8, w // 8, cfg.num_joints
        batch = {
            "image": rng.randn(n, h, w, 3).astype(np.float32) * 0.3,
            "part_score_targets": np.zeros((n, hh, ww, j), np.float32),
            "part_score_weights": np.ones((n, hh, ww, j), np.float32),
            "locref_targets": 0.1 * rng.randn(n, hh, ww, 2 * j).astype(np.float32),
            "locref_weights": (rng.rand(n, hh, ww, 2 * j) > 0.5).astype(np.float32),
        }
        batch["part_score_targets"][:, 1, 1, :] = 1.0
        if cfg.pairwise:
            c = cfg.pairwise_channels
            batch["pairwise_targets"] = 0.1 * rng.randn(n, hh, ww, c).astype(np.float32)
            batch["pairwise_weights"] = np.ones((n, hh, ww, c), np.float32)
        out.append(batch)
    return out


def jax_numpy(tree):
    return {n: {k: np.asarray(v) for k, v in e.items()} for n, e in tree.items()}


def _numpy(tree):
    return {n: {k: (v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)).copy()
                for k, v in e.items()} for n, e in tree.items()}


def assert_run_close(got, want, what):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL, atol=ATOL,
                               err_msg=f"{what}: losses")
    assert set(got["params"]) == set(want["params"])
    for key, w in want["params"].items():
        np.testing.assert_allclose(got["params"][key], w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: {key}")


def assert_replicas_equal(results, name):
    for r, res in enumerate(results[1:], 1):
        for key, v in results[0][name]["params"].items():
            np.testing.assert_array_equal(res[name]["params"][key], v,
                                          err_msg=f"{name}: rank {r} {key}")
        np.testing.assert_array_equal(res[name]["losses"], results[0][name]["losses"])


# -- the worlds -------------------------------------------------------------

@pytest.fixture(scope="module")
def specs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_specs")
    jnet, graph = graph_spec()
    jnet_is, graph_is = graph_spec(seed=1, iter_size=2, steps=3)
    full_is = dict(graph_is, iter_size=1, batches=[{k: v.reshape((8,) + v.shape[2:])
                                                   for k, v in graph_is["batches"][0].items()}] * 3)
    return {
        "graph": graph, "graph_jnet": jnet,
        "graph_iter_size": graph_is, "graph_iter_size_full": full_is, "graph_is_jnet": jnet_is,
        "bn_dropout": bn_dropout_spec(),
        "losses": loss_spec(tmp), "planted": loss_spec(tmp, planted=True),
        "pose": pose_spec(), "train_step": pose_spec("train_step"),
    }


WORLDS = {2: ("graph", "graph_iter_size", "bn_dropout", "losses", "planted", "pose",
               "train_step"),
           4: ("graph", "losses", "pose", "train_step")}


@pytest.fixture(scope="module")
def dp_runs(specs, tmp_path_factory):
    return {world: run_ranks(world, {n: specs[n] for n in names},
                             tmp_path_factory.mktemp(f"dp{world}"))
            for world, names in WORLDS.items()}


@pytest.fixture(scope="module")
def single(specs):
    """The port's single device on the global batches."""
    names = {n for ns in WORLDS.values() for n in ns} | {"graph_iter_size_full"}
    return {n: RUNNERS[specs[n]["kind"]](specs[n], None) for n in names}


# -- the tests ----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(specs):
    """The JAX package's single device on the same params and batches:
    GraphSolver (iter_size 1 and 2; params in the port's layouts) and
    PoseSolver (its JAX-layout params)."""
    import jax
    import jax.numpy as jnp
    from deepcut_tpu.solver import solver as js
    from deepcut_tpu.solver import update_rules as ju
    from deepcut_tpu_torch.models.convert import graph_params_from_numpy
    from test_torch_solver import jax_cfg

    out = {}
    for name, jname, iter_size in (("graph", "graph_jnet", 1),
                                   ("graph_iter_size", "graph_is_jnet", 2)):
        jnet, spec = specs[jname], specs[name]
        jsolver = js.GraphSolver(
            js.SolverParams.from_prototxt(SOLVER % dict(lr=spec["lr"], iter_size=iter_size)),
            jnet, handle_signals=False, log=lambda *_: None)
        batches = iter(spec["batches"])
        jsolver._next_inputs = lambda: {k: jnp.asarray(v) for k, v in next(batches).items()}
        jsolver.step(len(spec["batches"]))
        out[name] = _numpy(graph_params_from_numpy(jax_numpy(jnet.params), jnet.layer_types()))
    spec = specs["pose"]
    batches = iter(spec["batches"])
    jsp = js.SolverParams(config=ju.SolverConfig(solver_type="SGD", base_lr=0.001, momentum=0.9,
                                                 weight_decay=1e-4), max_iter=100, display=0,
                          snapshot=0, snapshot_prefix="unused")
    jsol = js.PoseSolver(jsp, jax_cfg(), lambda: next(batches),
                         net_params=jax.tree_util.tree_map(jnp.asarray, spec["params"]),
                         handle_signals=False, log=lambda *_: None, target_cfg=spec["target_cfg"])
    jsol.step(spec["steps"])
    out["pose"] = jsol.net_params
    return out


def _tree(flat, to_tensor=False):
    tree = {}
    for key, v in flat.items():
        n, k = key.split("/")
        tree.setdefault(n, {})[k] = torch.from_numpy(v) if to_tensor else v
    return tree


@pytest.mark.parametrize("world", [2, 4])
def test_graph_solver_dp_matches_single_device(world, dp_runs, single, jax_runs):
    """GraphSolver over a 'data' mesh follows the single-device trajectory
    (the P2PSync contract: summed rank gradients == the full-batch gradient),
    and the JAX package's single device on the same params."""
    from test_torch_engine_training import assert_trees_close

    results = dp_runs[world]
    assert_replicas_equal(results, "graph")
    assert_run_close(results[0]["graph"], single["graph"], "graph")
    assert_trees_close(_tree(results[0]["graph"]["params"]), jax_runs["graph"],
                       "DP against the JAX package")


def test_graph_solver_dp_with_iter_size(dp_runs, single, jax_runs):
    """mesh DP with iter_size 2: the batch dim behind the iter_size axis is
    the sharded one; the trajectory equals the un-accumulated full batch on
    one device, and the JAX package's accumulated run."""
    from test_torch_engine_training import assert_trees_close

    results = dp_runs[2]
    assert_replicas_equal(results, "graph_iter_size")
    got = results[0]["graph_iter_size"]
    assert_run_close(got, single["graph_iter_size_full"], "iter_size 2 vs full batch")
    assert_run_close(got, single["graph_iter_size"], "iter_size 2 vs one device, iter_size 2")
    assert_trees_close(_tree(got["params"]), jax_runs["graph_iter_size"],
                       "DP against the JAX package")


@pytest.mark.parametrize("world", [2, 4])
def test_pose_solver_dp_matches_single_device(world, dp_runs, single, jax_runs):
    """PoseSolver(mesh=...) shards the global batch and follows the single
    device's trajectory; against the JAX package's PoseSolver too."""
    from test_torch_solver import assert_params_close

    results = dp_runs[world]
    assert_replicas_equal(results, "pose")
    assert_run_close(results[0]["pose"], single["pose"], "pose")
    assert_params_close(_tree(results[0]["pose"]["params"], to_tensor=True), jax_runs["pose"])


@pytest.mark.parametrize("world", [2, 4])
def test_train_step_dp_gradients_and_eval(world, dp_runs, single):
    """parallel.train_step.make_train_step with a mesh: each step (no
    momentum) subtracts the global gradient, as on one device;
    make_eval_step gathers the global batch's outputs."""
    results = dp_runs[world]
    assert_replicas_equal(results, "train_step")
    assert_run_close(results[0]["train_step"], single["train_step"], "train_step")
    for res in results:
        np.testing.assert_allclose(res["train_step"]["eval"], single["train_step"]["eval"],
                                   rtol=RTOL, atol=ATOL)


def test_batchnorm_dropout_dp_matches_single_device(dp_runs, single):
    """BatchNorm in TRAIN (global-batch moments, moving averages and
    scale_factor), Dropout and STOCHASTIC pooling (the global draw, the
    rank's rows) under DP equal the port's single device."""
    results = dp_runs[2]
    assert_replicas_equal(results, "bn_dropout")
    got, want = results[0]["bn_dropout"], single["bn_dropout"]
    assert_run_close(got, want, "bn_dropout")
    sf = want["params"]["bn1/scale_factor"]
    assert float(sf.ravel()[0]) > 1.0 and np.abs(want["params"]["bn1/mean"]).sum() > 0


@pytest.mark.parametrize("world", [2, 4])
def test_loss_layers_dp_global_normalisers(world, dp_runs, single):
    """Every loss layer with ignore_label / IGNORE_VALUE and per-rank
    weight sums: the global loss and the trajectory (the gradients) equal
    one device's; Accuracy's counts (with its per-class top) are global."""
    results = dp_runs[world]
    assert_replicas_equal(results, "losses")
    assert_run_close(results[0]["losses"], single["losses"], "losses")
    for res in results:
        np.testing.assert_allclose(res["losses"]["acc"], single["losses"]["acc"],
                                   rtol=RTOL, atol=ATOL)


def test_planted_backward_all_reduce_is_caught(dp_runs, single):
    """An all-reduce on the differentiation path (in the backward of the
    losses' global sums) scales those gradients by the world size: the
    trajectory falls outside the tolerance the real one meets."""
    planted = dp_runs[2][0]["planted"]
    np.testing.assert_allclose(planted["losses"][0], single["losses"]["losses"][0],
                               rtol=RTOL, atol=ATOL)   # the first forward is the same
    with pytest.raises(AssertionError):
        assert_run_close(planted, single["losses"], "planted")


def test_mesh_entry_points_raise_without_a_group(monkeypatch):
    """No process group, no mesh (no silent world of 1), with a spatial
    axis too; a batch that does not split raises."""
    from deepcut_tpu_torch.parallel import distributed
    from deepcut_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch

    assert not torch.distributed.is_initialized() and distributed.is_coordinator()
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(2, spatial=2)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        distributed.initialize(device="cpu", rank=0)
    mesh = Mesh(None, 1, 2, 1, torch.device("cpu"))   # rank 1 of 2
    np.testing.assert_array_equal(shard_batch(mesh, {"a": np.arange(8).reshape(4, 2)})["a"],
                                  [[4, 5], [6, 7]])
    np.testing.assert_array_equal(
        shard_batch(mesh, {"a": torch.arange(8).reshape(2, 4)}, axis=1)["a"].numpy(),
        [[2, 3], [6, 7]])
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(mesh, {"a": np.zeros((3, 2))})
