"""Row-sharded ('spatial') training of any prototxt net in the port
(`parallel.graph_spatial`, `core.graph.Net.make_train_step(mesh=)` and
`GraphSolver`), over gloo on the CPU with (data, spatial) = (2, 2),
(1, 2) and (1, 4).

The graph-engine cases of tests/test_parallel.py (:542 plain, :611 a
DeeperCut-style prototxt, :696 iter_size, :751 train BatchNorm in the
sharded prefix and after the boundary, :828 stochastic layers, :935 a
per-sample-mean loss), with torch's idiom of one process per rank
(spawned, a gloo group on localhost, each world spawned once per module
and each rank joined with a 120 s timeout):

- `split_plan` is a pure function of the plan and the blob shapes: the
  port's (boundary, infos, sharded inputs, gathered blobs) equal the JAX
  package's for each prototxt here at S = 2 and 4 (its NHWC shapes, the
  port's NCHW);
- each trajectory (losses and params, BN's moving averages included)
  equals the port's single device within the JAX tests' ``rtol=1e-5,
  atol=1e-6`` (the JAX tests' own 1e-4 for train BatchNorm, whose
  reduction order feeds back through rsqrt into the running statistics),
  and the JAX package's single device within 2e-5 of each blob's scale
  (tests/test_torch_engine_training.py); the stochastic net against the
  port's own single device only (torch cannot draw JAX's masks); every
  rank ends with the same params;
- GraphSolver over a (1, 2) mesh reports the split through its log.

Not mirrored: tests/test_mesh_scale.py's 16- and 32-device cases (a world
here holds at most 4 ranks). The spawned processes import this module: it
imports no jax at module level.
"""

import multiprocessing as mp
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_parallel import JOIN_S, RTOL, ATOL, _flat, _numpy, free_port, jax_numpy

PLAIN = """
input: "data"  input_shape { dim: 4 dim: 3 dim: 32 dim: 32 }
input: "label" input_shape { dim: 4 }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 3 pad: 1
    weight_filler { type: "xavier" } bias_filler { type: "constant" } } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "conv2" type: "Convolution" bottom: "pool1" top: "conv2"
  convolution_param { num_output: 16 kernel_size: 3 pad: 1
    weight_filler { type: "xavier" } bias_filler { type: "constant" } } }
layer { name: "relu2" type: "ReLU" bottom: "conv2" top: "conv2" }
layer { name: "ip" type: "InnerProduct" bottom: "conv2" top: "ip"
  inner_product_param { num_output: 10 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" top: "loss" }
"""

DEEPERCUT = """
input: "data"   input_shape { dim: 4 dim: 3 dim: 64 dim: 32 }
input: "targets" input_shape { dim: 4 dim: 5 dim: 16 dim: 8 }
input: "loc_t"  input_shape { dim: 4 dim: 10 dim: 16 dim: 8 }
input: "loc_w"  input_shape { dim: 4 dim: 10 dim: 16 dim: 8 }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 7 stride: 2 pad: 3 } }
layer { name: "bn1" type: "BatchNorm" bottom: "conv1" top: "conv1"
  batch_norm_param { use_global_stats: true } }
layer { name: "sc1" type: "Scale" bottom: "conv1" top: "conv1" scale_param { bias_term: true } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "br1" type: "Convolution" bottom: "pool1" top: "br1"
  convolution_param { num_output: 16 kernel_size: 1 } }
layer { name: "br2a" type: "Convolution" bottom: "pool1" top: "br2a"
  convolution_param { num_output: 8 kernel_size: 1 } }
layer { name: "r2a" type: "ReLU" bottom: "br2a" top: "br2a" }
layer { name: "br2b" type: "Convolution" bottom: "br2a" top: "br2b"
  convolution_param { num_output: 8 kernel_size: 3 pad: 2 dilation: 2 } }
layer { name: "r2b" type: "ReLU" bottom: "br2b" top: "br2b" }
layer { name: "br2c" type: "Convolution" bottom: "br2b" top: "br2c"
  convolution_param { num_output: 16 kernel_size: 1 } }
layer { name: "res" type: "Eltwise" bottom: "br1" bottom: "br2c" top: "res" }
layer { name: "relur" type: "ReLU" bottom: "res" top: "res" }
layer { name: "score" type: "Convolution" bottom: "res" top: "score"
  convolution_param { num_output: 5 kernel_size: 1 } }
layer { name: "locref" type: "Convolution" bottom: "res" top: "locref"
  convolution_param { num_output: 10 kernel_size: 1 } }
layer { name: "loss_parts" type: "SoftmaxWithLossVec"
  bottom: "score" bottom: "targets" top: "loss_parts"
  softmax_with_loss_vec_param { cross_entropy: true } }
layer { name: "loss_loc" type: "SmoothL1Loss"
  bottom: "locref" bottom: "loc_t" bottom: "loc_w" top: "loss_loc" }
"""

SMALL = """
input: "data"  input_shape { dim: 4 dim: 3 dim: 32 dim: 32 }
input: "label" input_shape { dim: 4 }
layer { name: "c1" type: "Convolution" bottom: "data" top: "c1"
  convolution_param { num_output: 8 kernel_size: 3 pad: 1 weight_filler { type: "xavier" } } }
%(bn)s
layer { name: "r1" type: "ReLU" bottom: "c1" top: "c1" }
layer { name: "p1" type: "Pooling" bottom: "c1" top: "p1"
  pooling_param { pool: %(pool)s kernel_size: 2 stride: 2 } }
layer { name: "ip" type: "InnerProduct" bottom: "p1" top: "ip"
  inner_product_param { num_output: %(ip)d weight_filler { type: "xavier" } } }
%(mid)s
layer { name: "loss" type: "%(loss)s" bottom: "%(top)s" bottom: "label" top: "loss" }
"""
ITER_SIZE = SMALL % dict(bn="", pool="MAX", ip=5, mid="", loss="SoftmaxWithLoss", top="ip")
TRAIN_BN = SMALL % dict(
    bn='layer { name: "bn1" type: "BatchNorm" bottom: "c1" top: "c1" '
       'batch_norm_param { moving_average_fraction: 0.9 } }\n'
       'layer { name: "sc1" type: "Scale" bottom: "c1" top: "c1" scale_param { bias_term: true } }',
    pool="MAX", ip=6, loss="SoftmaxWithLoss", top="ip2",
    mid='layer { name: "bn2" type: "BatchNorm" bottom: "ip" top: "ip" }\n'
        'layer { name: "ip2" type: "InnerProduct" bottom: "ip" top: "ip2" '
        'inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }')
STOCHASTIC = SMALL % dict(
    bn="", pool="STOCHASTIC", ip=16, loss="SoftmaxWithLoss", top="ip2",
    mid='layer { name: "drop" type: "Dropout" bottom: "ip" top: "ip" '
        'dropout_param { dropout_ratio: 0.4 } }\n'
        'layer { name: "ip2" type: "InnerProduct" bottom: "ip" top: "ip2" '
        'inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }')
MEAN_LOSS = SMALL % dict(bn="", pool="MAX", ip=5, mid="", loss="HingeLoss", top="ip")
IP_FIRST = """
input: "data"  input_shape { dim: 4 dim: 3 dim: 8 dim: 8 }
input: "label" input_shape { dim: 4 }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" top: "loss" }
"""
PROTOS = {"plain": PLAIN, "deepercut": DEEPERCUT, "iter_size": ITER_SIZE, "train_bn": TRAIN_BN,
          "stochastic": STOCHASTIC, "mean_loss": MEAN_LOSS, "ip_first": IP_FIRST}

WORLDS = {(2, 2): ("plain", "deepercut"),
          (1, 2): ("iter_size", "train_bn", "stochastic", "mean_loss", "solver"),
          (1, 4): ("plain",)}


# -- what a rank runs (also the single-device reference, with mesh=None) ------

def run_graph(spec, mesh):
    """Net.make_train_step over the spec's batches from its params."""
    from deepcut_tpu_torch.core.graph import Net
    from deepcut_tpu_torch.proto import text_format
    from deepcut_tpu_torch.solver import update_rules as tu

    net = Net(text_format.parse(spec["proto"]), weights=spec["params"], phase="TRAIN",
              compute_dtype=None, device="cpu", seed=3)
    cfg = tu.SolverConfig(**spec["cfg"])
    step = net.make_train_step(cfg, mesh=mesh)
    params, state = net.params, tu.init_state(cfg, net.params)
    losses = []
    for batch in spec["batches"]:
        params, state, loss = step(params, state, dict(batch))
        losses.append(float(loss))
    return {"losses": np.asarray(losses), "params": _flat(params),
            "plans": list(getattr(step, "plans", {}).values())}


def run_solver(spec, mesh):
    """GraphSolver over PLAIN (shared params, fed batches); -> its log."""
    from deepcut_tpu_torch.core.graph import Net
    from deepcut_tpu_torch.proto import text_format
    from deepcut_tpu_torch.solver.solver import GraphSolver, SolverParams

    net = Net(text_format.parse(spec["proto"]), weights=spec["params"], phase="TRAIN",
              compute_dtype=None, device="cpu")
    lines = []
    solver = GraphSolver(SolverParams.from_prototxt(
        'base_lr: 0.05\nmomentum: 0.9\nlr_policy: "fixed"\ndisplay: 1\nmax_iter: 10\n'
        'snapshot: 0\nsnapshot_prefix: "unused"\n'), net, mesh=mesh, handle_signals=False,
        log=lines.append, device="cpu")
    batches = iter(spec["batches"])
    solver._next_inputs = lambda: dict(next(batches))
    solver.step(len(spec["batches"]))
    return {"log": lines, "losses": np.asarray(list(solver._loss_window)),
            "params": _flat(net.params)}


RUNNERS = {"graph": run_graph, "solver": run_solver}


def _rank_main(rank, world, spatial, port, spec_path, out_dir):
    torch.set_num_threads(2)
    from deepcut_tpu_torch.parallel import distributed
    from deepcut_tpu_torch.parallel.mesh import make_mesh

    distributed.initialize(f"tcp://127.0.0.1:{port}", world, rank, device="cpu")
    try:
        mesh = make_mesh(world, spatial=spatial)
        with open(spec_path, "rb") as f:
            specs = pickle.load(f)
        results = {name: RUNNERS[spec["kind"]](spec, mesh) for name, spec in specs.items()}
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        distributed.shutdown()


def run_world(data, spatial, specs, out_dir):
    """data * spatial spawned ranks over gloo -> each rank's results."""
    world = data * spatial
    out_dir.mkdir(parents=True, exist_ok=True)
    spec_path = out_dir / "specs.pkl"
    with open(spec_path, "wb") as f:
        pickle.dump(specs, f)
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, spatial, port, str(spec_path), str(out_dir)))
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


# -- the scenarios ----------------------------------------------------------------

def _inputs(name, rng, micro=None):
    """One global batch (NCHW) for a prototxt of PROTOS."""
    lead = (micro,) if micro else ()
    if name == "deepercut":
        return {"data": rng.randn(*lead, 4, 3, 64, 32).astype(np.float32),
                "targets": (rng.rand(*lead, 4, 5, 16, 8) > 0.9).astype(np.float32),
                "loc_t": (0.2 * rng.randn(*lead, 4, 10, 16, 8)).astype(np.float32),
                "loc_w": (rng.rand(*lead, 4, 10, 16, 8) > 0.5).astype(np.float32)}
    classes = 10 if name == "plain" else 5
    return {"data": (0.3 * rng.randn(*lead, 4, 3, 32, 32)).astype(np.float32),
            "label": rng.randint(0, classes, lead + (4,)).astype(np.float32)}


def graph_spec(name):
    """The JAX net with tamed params and the port's spec on the same params."""
    from test_torch_engine_training import nets
    from deepcut_tpu_torch.models.convert import graph_params_from_numpy

    jnet, _ = nets(PROTOS[name])
    params = graph_params_from_numpy(jax_numpy(jnet.params), jnet.layer_types())
    rng = np.random.RandomState(0)
    micro = 2 if name == "iter_size" else None
    cfg = dict(solver_type="SGD", base_lr=0.02 if name == "deepercut" else 0.05, momentum=0.9,
               weight_decay=0.0005 if name == "plain" else 0.0, iter_size=micro or 1)
    batches = [_inputs(name, rng, micro) for _ in range(3 if name in ("plain", "deepercut")
                                                        else 2)]
    return jnet, {"kind": "graph", "proto": PROTOS[name], "params": _numpy(params), "cfg": cfg,
                  "batches": batches}


@pytest.fixture(scope="module")
def specs():
    out = {name: graph_spec(name) for name in
           ("plain", "deepercut", "iter_size", "train_bn", "stochastic", "mean_loss")}
    plain = out["plain"][1]
    out["solver"] = (None, dict(plain, kind="solver", batches=plain["batches"][:2]))
    return out


@pytest.fixture(scope="module")
def runs(specs, tmp_path_factory):
    return {shape: run_world(*shape, {n: specs[n][1] for n in names},
                             tmp_path_factory.mktemp(f"gsp{shape[0]}x{shape[1]}"))
            for shape, names in WORLDS.items()}


@pytest.fixture(scope="module")
def single(specs):
    return {name: RUNNERS[spec["kind"]](spec, None) for name, (_, spec) in specs.items()}


@pytest.fixture(scope="module")
def jax_runs(specs):
    """The JAX package's single device on the same params and batches (NHWC)."""
    import jax
    import jax.numpy as jnp
    from deepcut_tpu.solver import update_rules as ju
    from deepcut_tpu_torch.models.convert import graph_params_from_numpy

    out = {}
    for name in ("plain", "deepercut", "iter_size", "train_bn", "mean_loss"):
        jnet, spec = specs[name]
        cfg = ju.SolverConfig(**spec["cfg"])
        step = jax.jit(jnet.make_train_step(cfg))
        params, state = jnet.params, ju.init_state(cfg, jnet.params)
        for batch in spec["batches"]:
            nhwc = {k: jnp.asarray(np.moveaxis(v, -3, -1) if v.ndim >= 4 else v)
                    for k, v in batch.items()}
            params, state, _ = step(params, state, nhwc)
        out[name] = _numpy(graph_params_from_numpy(jax_numpy(params), jnet.layer_types()))
    return out


def _tree(flat):
    tree = {}
    for key, v in flat.items():
        n, k = key.split("/")
        tree.setdefault(n, {})[k] = v
    return tree


def assert_run_close(got, want, what, rtol=RTOL):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol, atol=ATOL,
                               err_msg=f"{what}: losses")
    assert set(got["params"]) == set(want["params"])
    for key, w in want["params"].items():
        np.testing.assert_allclose(got["params"][key], w, rtol=rtol, atol=ATOL,
                                   err_msg=f"{what}: {key}")


def assert_replicas_equal(results, name):
    for r, res in enumerate(results[1:], 1):
        for key, v in results[0][name]["params"].items():
            np.testing.assert_array_equal(res[name]["params"][key], v,
                                          err_msg=f"{name}: rank {r} {key}")


# -- split_plan, a pure function ----------------------------------------------------

def _jax_split(jnet, shapes, nsp):
    import jax
    import jax.numpy as jnp
    from deepcut_tpu.parallel.graph_spatial import split_plan as jax_split_plan

    nhwc = {k: (v[0], v[2], v[3], v[1]) if len(v) == 4 else v for k, v in shapes.items()}
    abstract = {k: jax.ShapeDtypeStruct(v, jnp.float32) for k, v in nhwc.items()}
    blobs = jax.eval_shape(lambda p, i: jnet._execute(p, i), jnet.params, abstract)
    nhwc.update({k: tuple(v.shape) for k, v in blobs.items()})
    return jax_split_plan(jnet, nhwc, nsp)


@pytest.mark.parametrize("nsp", [2, 4])
@pytest.mark.parametrize("name", sorted(PROTOS))
def test_split_plan_matches_jax(name, nsp):
    """The port's split (boundary, infos, sharded inputs, gathered blobs)
    equals the JAX package's for the same prototxt and global shapes."""
    from test_torch_engine_training import nets
    from deepcut_tpu_torch.parallel.graph_spatial import split_plan

    jnet, tnet = nets(PROTOS[name])
    blobs, _ = tnet._meta_pass(dict(tnet.input_shapes))
    got = split_plan(tnet, {k: tuple(v.shape) for k, v in blobs.items()}, nsp)
    want = _jax_split(jnet, dict(tnet.input_shapes), nsp)
    assert got == want


def test_split_plan_boundaries():
    """tests/test_parallel.py's sanity checks of the split: the plain net
    shards its conv / pool prefix up to the InnerProduct and gathers conv2;
    train BN's bn1 lies in the prefix and bn2 after it; the stochastic
    pool is the boundary; an InnerProduct first gives boundary 0."""
    from test_torch_engine_training import nets
    from deepcut_tpu_torch.parallel.graph_spatial import split_plan

    def split(name):
        _, tnet = nets(PROTOS[name])
        blobs, _ = tnet._meta_pass(dict(tnet.input_shapes))
        return [s.name for _, s in tnet._plan], split_plan(
            tnet, {k: tuple(v.shape) for k, v in blobs.items()}, 2)

    names, (boundary, _, sharded, gather) = split("plain")
    assert (boundary, sharded, gather) == (5, {"data"}, ["conv2"])
    names, (boundary, _, _, _) = split("train_bn")
    assert names.index("bn1") < boundary <= names.index("bn2")
    names, (boundary, _, _, _) = split("stochastic")
    assert boundary == names.index("p1")
    assert split("ip_first")[1][0] == 0


# -- the worlds ----------------------------------------------------------------------

CASES = [((2, 2), "plain"), ((2, 2), "deepercut"), ((1, 4), "plain"), ((1, 2), "iter_size"),
         ((1, 2), "train_bn"), ((1, 2), "mean_loss")]


@pytest.mark.parametrize("shape,name", CASES)
def test_graph_spatial_matches_single_device(shape, name, runs, single, jax_runs):
    """The spatial step follows the port's single device (and the JAX
    package's) on the same params and global batches: plain, the
    DeeperCut-style net (strided conv1, frozen BN, ceil pool, a dilated
    residual block, the fork's losses), S = 4, iter_size 2 accumulated
    inside the step, train BatchNorm on both sides of the boundary, a
    per-sample-mean loss (HingeLoss through `_wrap_mean_loss`)."""
    from test_torch_engine_training import assert_trees_close

    results = runs[shape]
    assert_replicas_equal(results, name)
    # train BN: the reduction order feeds back through rsqrt into the
    # running statistics (the JAX test's 1e-4)
    rtol = 1e-4 if name == "train_bn" else RTOL
    for res in results:
        assert_run_close(res[name], single[name], f"{shape} {name}", rtol=rtol)
    assert_trees_close(_tree(results[0][name]["params"]), jax_runs[name],
                       f"{shape} {name} against the JAX package")
    assert results[0][name]["plans"][0][0] > 0   # rows were sharded


def test_graph_spatial_stochastic_layers_match_single_device(runs, single):
    """Dropout and STOCHASTIC pooling under the (1, 2) mesh: the stochastic
    pool is the boundary, the suffix draws the global batch's masks with the
    layers' indices in the whole plan: the port's single device's
    trajectory, exactly as tolerated above."""
    results = runs[1, 2]
    assert_replicas_equal(results, "stochastic")
    assert_run_close(results[0]["stochastic"], single["stochastic"], "stochastic")


def test_graph_solver_spatial_logs_the_split(runs, single):
    """GraphSolver(mesh=(1, 2)) trains through the spatial step and its
    coordinator's log reports the split; the other rank logs nothing."""
    results = runs[1, 2]
    assert_run_close(results[0]["solver"], single["solver"], "GraphSolver")
    split = [ln for ln in results[0]["solver"]["log"] if ln.startswith("spatial graph training")]
    assert split == ["spatial graph training: rows sharded over 2 ranks up to layer 5 of 7 (ip), "
                     "gathering ['conv2']"], results[0]["solver"]["log"]
    assert results[1]["solver"]["log"] == []
