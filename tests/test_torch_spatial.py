"""Row-sharded ('spatial') DeeperCut in the port (`parallel.spatial`, the
spatial `make_train_step` and `PoseSolver`, `PoseEstimator(mesh=)`), over
gloo on the CPU with (data, spatial) = (2, 2), (1, 2) and (1, 4).

The spatial cases of tests/test_parallel.py and tests/test_hd_multiperson.py,
with torch's idiom of one process per rank (spawned, a gloo group on
localhost, each world spawned once per module and each rank joined with a
120 s timeout, so a hung rank fails its tests instead of the run):

- the halo ops alone: `halo_exchange` (forward and backward), and
  `spatial_conv2d` / `spatial_max_pool` (-inf fill, ceil mode) against the
  unsharded op and its gradient;
- the train step at (2, 2), (1, 2) and (1, 4) (H = 128 = 32 * 4, the
  contract's least canvas at S = 4), and PoseSolver at (2, 2) with
  iter_size 1 and 2: the trajectory (losses, params, momentum) equals the
  port's single device within the JAX tests' ``rtol=1e-5, atol=1e-6``, and
  the JAX package's single device within the data axis's cross-package tolerance
  (1e-3 of the distance each param moved, tests/test_torch_solver.py);
  every rank holds the same params, bit for bit; `make_spatial_value_and_grad`
  gives every rank the single device's loss and gradients;
- planted faults fall outside those tolerances: a gather backward that
  keeps only the local slice (the trunk's gradient then 1x, the heads' Sx)
  and a halo backward that drops its cotangents;
- the shape contract's errors (the JAX package's messages);
- `PoseEstimator(mesh=).scoremaps` (f32, and int8 on the JAX package's
  quantization) equals the JAX package's UNSHARDED forward of the same
  zero-padded canvas within ``rtol=2e-4, atol=2e-5`` (the bound the JAX
  test holds its mesh path to), at 688 rows with S = 2 (43 rows at
  res4 / res5: uneven row blocks) and at heights that do not divide;
  exact=True takes the tiled path exactly where the JAX package's does;
  quantize_int8 on a mesh gives every rank the unsharded scales;
- the HD frame of tests/test_hd_multiperson.py at a small width: the tiled
  path against the mesh, the same strict local maxima;
- `warp_batch_local` rows bit-equal to `warp_batch`'s, the rasterizer on a
  row block with the global grid, and `int8_im2col_plain` with (0, p)
  equal to the symmetric pad's rows.

Not mirrored: tests/test_mesh_scale.py's 16- and 32-device cases (a world
here holds at most 4 ranks) and the GSPMD canary of test_parallel.py:368
(a jax-0.9 partitioner bug with no torch counterpart). The spawned
processes import this module: it imports no jax at module level.
"""

import multiprocessing as mp
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_parallel import JOIN_S, RTOL, ATOL, _flat, dense_batches, free_port

WORLDS = {(2, 2): ("train_step", "solver", "solver_is"),
          (1, 2): ("train_step", "planted_gather", "planted_halo", "halo", "estimator", "vg"),
          (1, 4): ("train_step", "halo", "estimator", "int8", "hd")}


# -- what a rank runs (also the single-device reference, with mesh=None) ------

def run_train_step(spec, mesh):
    """`parallel.train_step.make_train_step` over the spec's batches; a
    planted fault replaces one backward for the run."""
    from deepcut_tpu_torch.models.convert import params_from_numpy
    from deepcut_tpu_torch.parallel import spatial as sp
    from deepcut_tpu_torch.parallel.train_step import make_train_step
    from deepcut_tpu_torch.solver import update_rules as tu

    cfg = spec["solver_cfg"]
    params = params_from_numpy(spec["params"])
    state = tu.init_state(cfg, params)
    step = make_train_step(spec["model_cfg"], cfg, mesh)
    saved = sp._GatherRows.backward, sp._RowWindow.backward
    if spec.get("planted") == "gather":   # the local slice alone: no sum over the row group
        sp._GatherRows.backward = staticmethod(
            lambda ctx, g: (g[:, :, ctx.span[0]:ctx.span[1]].contiguous(), None, None))
    elif spec.get("planted") == "halo":   # the borrowed rows' cotangents dropped
        def dropped(ctx, g):
            top, t, a, b, _, _ = ctx.parts[ctx.axis.index]
            grad = g.new_zeros(ctx.shape)
            grad[:, :, a:b] = g[:, :, top + t:top + t + b - a]
            return grad, None, None, None
        sp._RowWindow.backward = staticmethod(dropped)
    try:
        losses = []
        for batch in spec["batches"]:
            params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["total_loss"]))
    finally:
        sp._GatherRows.backward, sp._RowWindow.backward = saved
    return {"losses": np.asarray(losses), "params": _flat(params),
            "history": _flat(state["history"])}


def run_solver(spec, mesh):
    """PoseSolver from the spec's params over its batches, one step at a time."""
    from deepcut_tpu_torch.models.convert import params_from_numpy
    from deepcut_tpu_torch.solver.solver import PoseSolver

    batches = iter(spec["batches"])
    solver = PoseSolver(spec["solver"], spec["model_cfg"], lambda: next(batches),
                        net_params=params_from_numpy(spec["params"]), mesh=mesh,
                        handle_signals=False, log=lambda *_: None, device="cpu")
    losses = []
    for _ in range(spec["steps"]):
        solver.step(1)
        losses.append(float(solver._loss_window[-1]))
    return {"losses": np.asarray(losses), "params": _flat(solver.net_params)}


def run_halo(spec, mesh):
    """halo_exchange, spatial_conv2d and spatial_max_pool on this rank's
    block, each with the spec's cotangent for its block: -> outputs and
    gradients."""
    from deepcut_tpu_torch.parallel.spatial import halo_exchange, spatial_conv2d, spatial_max_pool

    s, n = mesh.spatial_index, mesh.spatial
    x = torch.from_numpy(spec["x"])
    rows = x.shape[2] // n
    out = {}

    def block():
        return x[:, :, s * rows:(s + 1) * rows].clone().requires_grad_()

    xl = block()
    y = halo_exchange(xl, spec["top"], spec["bottom"], mesh, bottom_fill=spec["fill"])
    (y * torch.from_numpy(spec["g_halo"][s])).sum().backward()
    out["halo"] = (y.detach().numpy(), xl.grad.numpy())
    for name, geo in spec["convs"].items():
        xl = block()
        w = torch.from_numpy(spec["w"]).requires_grad_()
        b = torch.from_numpy(spec["b"]).requires_grad_()
        y = spatial_conv2d(xl, w, b, mesh=mesh, **geo)
        (y * torch.from_numpy(spec["g_" + name][s])).sum().backward()
        out[name] = (y.detach().numpy(), xl.grad.numpy(), w.grad.numpy(), b.grad.numpy())
    xl = block()
    y = spatial_max_pool(xl, kernel=3, stride=2, mesh=mesh)
    (y * torch.from_numpy(spec["g_pool"][s])).sum().backward()
    out["pool"] = (y.detach().numpy(), xl.grad.numpy())
    return out


def run_estimator(spec, mesh):
    """PoseEstimator(mesh=) scoremaps of each frame (and pose of the first),
    on the float model or the JAX package's int8 quantization; with a
    calibration frame, a second estimator's quantize_int8 scales."""
    from deepcut_tpu_torch.models.convert import params_from_numpy, qparams_from_numpy
    from deepcut_tpu_torch.pose.estimate import PoseEstimator

    def estimator():
        return PoseEstimator(params_from_numpy(spec["params"]), spec["model_cfg"],
                             folded=spec["folded"], mesh=mesh, device="cpu",
                             max_size=spec["max_size"])

    est = estimator()
    if spec.get("qparams") is not None:
        est.serve_int8(*qparams_from_numpy(*spec["qparams"]))
    out = {"max_dims": est._max_dims(),
           "maps": {name: est.scoremaps(img, exact=exact)
                    for name, (img, exact) in spec["frames"].items()}}
    first = next(iter(spec["frames"].values()))[0]
    out["pose"] = est.estimate_pose(first)
    if spec.get("calib") is not None:
        est8 = estimator()
        est8.quantize_int8(spec["calib"])
        out["scales"] = dict(est8.model.act_scales)
    return out


def run_vg(spec, mesh):
    """`make_spatial_value_and_grad` on the first batch: -> loss, gradients."""
    from deepcut_tpu_torch.models.convert import params_from_numpy
    from deepcut_tpu_torch.parallel.spatial import make_spatial_value_and_grad

    vg = make_spatial_value_and_grad(spec["model_cfg"], mesh)
    (loss, _), grads = vg(params_from_numpy(spec["params"]), spec["batches"][0])
    return {"loss": float(loss), "grads": _flat(grads)}


RUNNERS = {"train_step": run_train_step, "solver": run_solver, "halo": run_halo,
           "estimator": run_estimator, "vg": run_vg}


def _rank_main(rank, world, spatial, port, spec_path, out_dir):
    torch.set_num_threads(2)   # up to four ranks share the test worker's cores
    from deepcut_tpu_torch.parallel import distributed
    from deepcut_tpu_torch.parallel.mesh import make_mesh

    distributed.initialize(f"tcp://127.0.0.1:{port}", world, rank, device="cpu")
    try:
        mesh = make_mesh(world, spatial=spatial)
        assert (mesh.data_index, mesh.spatial_index) == divmod(rank, spatial)
        with open(spec_path, "rb") as f:
            specs = pickle.load(f)
        results = {name: RUNNERS[spec["kind"]](spec, mesh) for name, spec in specs.items()}
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        distributed.shutdown()


def run_world(data, spatial, specs, out_dir):
    """Spawn data * spatial ranks over gloo, each running every spec; ->
    each rank's results. A rank still alive after JOIN_S is killed and
    fails."""
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


# -- the scenarios --------------------------------------------------------------

def _solver_cfg(**kw):
    from deepcut_tpu_torch.solver import update_rules as tu

    return tu.SolverConfig(**{"solver_type": "SGD", "base_lr": 0.001, "momentum": 0.9,
                              "weight_decay": 1e-4, **kw})


def train_spec(n, h, steps=3, planted=None):
    """The tiny DeeperCut of tests/test_torch_training.py from tamed params
    on dense random batches of n frames of h x 32 (the JAX tests' shapes)."""
    from test_torch_solver import jax_cfg, port_cfg, tame_params

    cfg = port_cfg()
    return {"kind": "train_step", "model_cfg": cfg, "solver_cfg": _solver_cfg(),
            "params": tame_params(jax_cfg()), "planted": planted,
            "batches": dense_batches(cfg, steps, n=n, h=h, w=32)}


def solver_spec(iter_size):
    from test_torch_solver import jax_cfg, port_cfg, tame_params
    from deepcut_tpu_torch.solver import solver as ts

    cfg = port_cfg()
    sp = ts.SolverParams(config=_solver_cfg(iter_size=iter_size), max_iter=100, display=0,
                         snapshot=0, snapshot_prefix="unused")
    return {"kind": "solver", "solver": sp, "model_cfg": cfg, "params": tame_params(jax_cfg()),
            "batches": dense_batches(cfg, 2 * iter_size, n=4, h=64, w=32), "steps": 2}


def halo_spec(n):
    rng = np.random.RandomState(20 + n)
    x = rng.randn(2, 3, 16, 6).astype(np.float32)
    rows = 16 // n
    top, bottom = 2, 1
    spec = {"kind": "halo", "x": x, "top": top, "bottom": bottom, "fill": -7.0,
            "g_halo": [rng.randn(2, 3, rows + top + bottom, 6).astype(np.float32)
                       for _ in range(n)],
            "w": (0.3 * rng.randn(4, 3, 3, 3)).astype(np.float32),
            "b": rng.randn(4).astype(np.float32),
            "convs": {"strided": dict(stride=(2, 1), pad=1),
                      "dilated": dict(pad=(2, 1), dilation=(2, 1))}}
    for name, geo in spec["convs"].items():
        ref = F.conv2d(torch.from_numpy(x), torch.from_numpy(spec["w"]), None,
                       stride=geo.get("stride", 1), padding=geo["pad"],
                       dilation=geo.get("dilation", 1))
        r = ref.shape[2] // n
        spec["g_" + name] = [rng.randn(2, 4, r, ref.shape[3]).astype(np.float32)
                             for _ in range(n)]
    spec["g_pool"] = [rng.randn(2, 3, 8 // n, 3).astype(np.float32) for _ in range(n)]
    return spec


def _frame(seed, h, w):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)


def estimator_spec(spatial):
    """The f32 tiny estimator of tests/test_parallel.py:74 (heads x30):
    a frame whose canvas rows divide by 8 * S and one that needs padding
    (also with exact=True); at S = 2 the reference canvas of 688 rows."""
    from test_torch_resnet import tame_params
    from deepcut_tpu_torch.models.resnet import DeeperCutConfig
    from deepcut_tpu.models import resnet as jr
    import jax.numpy as jnp

    kw = dict(depths=(1, 1, 1, 1), stage_widths=(4, 4, 8, 8), num_joints=3)
    params = tame_params(jr.DeeperCutConfig(compute_dtype=jnp.float32, **kw), seed=3)
    for head in ("res5c_up_pose", "res3d_pose", "res5c_up_locref", "res3d_locref"):
        params[head]["w"] *= np.float32(30.0)
    frames = {"divides": (_frame(0, 192, 120), False), "pads": (_frame(1, 200, 120), False),
              "pads_exact": (_frame(1, 200, 120), True),
              "divides_exact": (_frame(0, 192, 120), True)}
    if spatial == 2:
        frames["688"] = (_frame(2, 688, 64), False)
    return {"kind": "estimator", "model_cfg": DeeperCutConfig(compute_dtype=torch.float32, **kw),
            "params": params, "folded": False, "max_size": 700, "frames": frames}


def int8_spec():
    """The folded bf16 estimator of tests/test_torch_estimate.py on the JAX
    package's int8 quantization (the maps are bit-equal to its own on a
    shared quantization), and a calibration on the mesh."""
    import jax
    import jax.numpy as jnp
    from test_torch_estimate import KW8
    from test_torch_resnet import tame_params
    from deepcut_tpu.models import resnet as jr
    from deepcut_tpu.pose import estimate as je
    from deepcut_tpu_torch.models.resnet import DeeperCutConfig

    params = tame_params(jr.DeeperCutConfig(**KW8), seed=5)
    for name in ("res5c_up_pose", "res3d_pose"):
        params[name]["w"] *= np.float32(10.0)
    calib = _frame(12, 96, 120)
    jest = je.PoseEstimator(jax.tree_util.tree_map(jnp.asarray, params), jr.DeeperCutConfig(**KW8))
    jest.quantize_int8(calib)
    q = jax.tree_util.tree_map(np.asarray, jest.params)
    return jest, {"kind": "estimator", "model_cfg": DeeperCutConfig(**KW8), "params": params,
                  "folded": True, "max_size": 700, "qparams": (q["q"], q["s"]), "calib": calib,
                  "frames": {"divides": (_frame(0, 192, 120), False),
                             "pads": (_frame(1, 200, 120), False)}}


def hd_spec():
    """tests/test_hd_multiperson.py's frame at 704 x 1280 through the tiny
    f32 model with the pose head x0.02 (unsaturated maps, strict maxima):
    full-frame over the mesh (max_size = W)."""
    from test_hd_multiperson import _draw_people
    from test_torch_resnet import tame_params
    from deepcut_tpu.models import resnet as jr
    from deepcut_tpu_torch.models.resnet import DeeperCutConfig
    import jax.numpy as jnp

    kw = dict(depths=(1, 1, 1, 1), stage_widths=(4, 4, 8, 8), num_joints=4)
    params = tame_params(jr.DeeperCutConfig(compute_dtype=jnp.float32, **kw), seed=3)
    for name in ("res5c_up_pose", "res3d_pose"):
        params[name]["w"] *= np.float32(0.02)
    img = _draw_people(704, 1280, 4, np.random.RandomState(0))
    return {"kind": "estimator", "model_cfg": DeeperCutConfig(compute_dtype=torch.float32, **kw),
            "params": params, "folded": False, "max_size": 1280,
            "frames": {"hd": (img, False)}}


@pytest.fixture(scope="module")
def specs():
    jest, int8 = int8_spec()
    return {
        (2, 2): {"train_step": train_spec(4, 64), "solver": solver_spec(1),
                 "solver_is": solver_spec(2)},
        (1, 2): {"train_step": train_spec(2, 64), "planted_gather": train_spec(2, 64,
                                                                                planted="gather"),
                 "planted_halo": train_spec(2, 64, planted="halo"), "halo": halo_spec(2),
                 "estimator": estimator_spec(2), "vg": dict(train_spec(2, 64), kind="vg")},
        (1, 4): {"train_step": train_spec(2, 128, steps=2), "halo": halo_spec(4),
                 "estimator": estimator_spec(4), "int8": int8, "hd": hd_spec()},
        "jax_int8": jest,
    }


@pytest.fixture(scope="module")
def runs(specs, tmp_path_factory):
    return {shape: run_world(*shape, {n: specs[shape][n] for n in names},
                             tmp_path_factory.mktemp(f"sp{shape[0]}x{shape[1]}"))
            for shape, names in WORLDS.items()}


@pytest.fixture(scope="module")
def single(specs):
    """The port's single device on the global batches."""
    out = {}
    for shape in ((2, 2), (1, 2), (1, 4)):
        out[shape, "train_step"] = run_train_step(specs[shape]["train_step"], None)
    out["solver"] = run_solver(specs[2, 2]["solver"], None)
    out["solver_is"] = run_solver(specs[2, 2]["solver_is"], None)
    return out


def _tree(flat):
    tree = {}
    for key, v in flat.items():
        n, k = key.split("/")
        tree.setdefault(n, {})[k] = torch.from_numpy(v)
    return tree


def assert_run_close(got, want, what):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL, atol=ATOL,
                               err_msg=f"{what}: losses")
    for part in ("params", "history"):
        for key, w in want.get(part, {}).items():
            np.testing.assert_allclose(got[part][key], w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what}: {part} {key}")


def assert_replicas_equal(results, name):
    for r, res in enumerate(results[1:], 1):
        for key, v in results[0][name]["params"].items():
            np.testing.assert_array_equal(res[name]["params"][key], v,
                                          err_msg=f"{name}: rank {r} {key}")
        np.testing.assert_array_equal(res[name]["losses"], results[0][name]["losses"])


# -- pure functions ---------------------------------------------------------------

def test_row_splits_and_plans():
    """Even blocks where S divides, ceil blocks with the last one short
    otherwise; a plan maps each local row count to its height, and one
    that cannot (a shared count, an empty shard) raises."""
    from deepcut_tpu_torch.models.resnet import deepercut_config
    from deepcut_tpu_torch.parallel.spatial import RowPlan, split_rows, trunk_heights

    assert split_rows(64, 4) == [(0, 16), (16, 32), (32, 48), (48, 64)]
    assert split_rows(43, 2) == [(0, 22), (22, 43)]
    assert trunk_heights(688, deepercut_config(152)) == [688, 344, 172, 86, 43]
    plan = RowPlan.for_heights(2, trunk_heights(688, deepercut_config(152)))
    assert [plan.global_rows(n, 1) for n in (344, 172, 86, 43, 21)] == [688, 344, 172, 86, 43]
    assert RowPlan.even(4).global_rows(8, 3) == 32
    with pytest.raises(ValueError, match="empty"):
        RowPlan.for_heights(4, [3])
    with pytest.raises(ValueError, match="both"):
        RowPlan.for_heights(2, [8, 7])


def test_spatial_train_step_shape_contract():
    """tests/test_parallel.py:334: the contract's errors, host-side, with
    the JAX package's messages, before any collective."""
    from test_torch_solver import jax_cfg, port_cfg, tame_params
    from deepcut_tpu_torch.models.convert import params_from_numpy
    from deepcut_tpu_torch.parallel.mesh import Mesh
    from deepcut_tpu_torch.parallel.spatial import check_spatial_shapes
    from deepcut_tpu_torch.parallel.train_step import make_train_step
    from deepcut_tpu_torch.solver import update_rules as tu

    mesh = Mesh(None, 0, 4, 2, torch.device("cpu"))     # (data=4, spatial=2), unjoined
    with pytest.raises(ValueError, match=r"image H=48 must be divisible by 16\*n_spatial=32"):
        check_spatial_shapes(48, 4, mesh)
    with pytest.raises(ValueError, match=r"image H=32 too small for spatial=2"):
        check_spatial_shapes(32, 4, mesh)
    with pytest.raises(ValueError, match="batch 2 not divisible by data axis 4"):
        check_spatial_shapes(64, 2, mesh)
    check_spatial_shapes(64, 4, mesh)
    step = make_train_step(port_cfg(), _solver_cfg(), mesh)
    params = params_from_numpy(tame_params(jax_cfg()))
    with pytest.raises(ValueError, match="must be divisible"):
        step(params, tu.init_state(_solver_cfg(), params),
             {"image": np.zeros((4, 40, 32, 3), np.float32)})


@pytest.mark.parametrize("pad,dilation", [(1, 1), (2, 2), (3, 1)])
def test_int8_im2col_row_halo_pad(pad, dilation):
    """A row-sharded int8 conv reads its halo rows as they are: im2col of
    the rows padded by hand with pad (0, p) equals the symmetric pad's
    rows, bit for bit, and so does the exact int32 accumulator."""
    from deepcut_tpu_torch.ops import int8_conv as ic

    g = torch.Generator().manual_seed(pad)
    x = torch.randint(-127, 128, (2, 16, 9, 11), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (8, 16, 3, 3), generator=g, dtype=torch.int8)
    rows = F.pad(x, (0, 0, pad, pad))
    kw = dict(dilation=dilation, min_rows=200, width=160)
    np.testing.assert_array_equal(ic.int8_im2col_plain(rows, 3, pad=(0, pad), **kw).numpy(),
                                  ic.int8_im2col_plain(x, 3, pad=pad, **kw).numpy())
    np.testing.assert_array_equal(ic.conv_i8_plain(rows, w, pad=(0, pad), dilation=dilation),
                                  ic.conv_i8_plain(x, w, pad=pad, dilation=dilation))
    packed = ic.pack_conv_weight(w)
    np.testing.assert_array_equal(ic.conv_i8(rows, packed, 8, 3, pad=(0, pad), dilation=dilation),
                                  ic.conv_i8(x, packed, 8, 3, pad=pad, dilation=dilation))


def test_warp_batch_local_rows_bit_equal():
    """warp_batch_local on each row shard's token gives the same rows of
    warp_batch's full canvas, bit for bit; the rasterizer on a row block
    with the global grid gives the full image's targets."""
    from test_torch_training import TCFG, source
    from deepcut_tpu_torch.parallel.mesh import Mesh, shard_batch
    from deepcut_tpu_torch.parallel.train_step import to_device
    from deepcut_tpu_torch.pose.augment_device import warp_batch, warp_batch_local
    from deepcut_tpu_torch.pose.targets_device import make_batch_rasterizer

    src = source(device_targets=True, augment=True, augment_device=True)
    try:
        batch = src.next_batch(2)
    finally:
        src.close()
    full = warp_batch(to_device(batch, "cpu"))
    h = full["image"].shape[2]
    assert h % 32 == 0
    want = make_batch_rasterizer(TCFG)(full)
    for s in range(2):
        mesh = Mesh(None, s, 1, 2, torch.device("cpu"))
        local = warp_batch_local(to_device(shard_batch(mesh, batch), "cpu"), mesh)
        assert torch.equal(local["image"], full["image"][:, :, s * h // 2:(s + 1) * h // 2])
        got = make_batch_rasterizer(TCFG, grid=(h // 8, full["image"].shape[3] // 8))(local)
        for k, v in want.items():
            if k != "image":
                assert torch.equal(got[k], v), k


# -- the worlds ---------------------------------------------------------------------

@pytest.mark.parametrize("spatial", [2, 4])
def test_halo_ops_match_unsharded(spatial, specs, runs):
    """halo_exchange moves exactly the neighbours' rows (zeros above the
    first shard, the fill below the last) and sends each halo's cotangent
    back to its owner; spatial_conv2d (strided, dilated) and
    spatial_max_pool (-inf fill, ceil mode) equal the unsharded op and its
    gradients."""
    spec = specs[1, spatial]["halo"]
    x = torch.from_numpy(spec["x"]).requires_grad_()
    rows, top, bottom = 16 // spatial, spec["top"], spec["bottom"]
    padded = torch.cat([torch.zeros(2, 3, top, 6), x, torch.full((2, 3, bottom, 6), spec["fill"])],
                       dim=2)
    gx = torch.zeros(2, 3, 16 + top + bottom, 6)
    for s in range(spatial):
        gx[:, :, s * rows:s * rows + rows + top + bottom] += torch.from_numpy(spec["g_halo"][s])
    gx = gx[:, :, top:top + 16]
    results = [r["halo"] for r in runs[1, spatial]]
    for s, res in enumerate(results):
        np.testing.assert_array_equal(res["halo"][0],
                                      padded[:, :, s * rows:s * rows + rows + top + bottom]
                                      .detach().numpy())
        np.testing.assert_allclose(res["halo"][1], gx[:, :, s * rows:(s + 1) * rows].numpy(),
                                   rtol=RTOL, atol=ATOL)
    for name, geo in spec["convs"].items():
        xx = torch.from_numpy(spec["x"]).requires_grad_()
        w = torch.from_numpy(spec["w"]).requires_grad_()
        b = torch.from_numpy(spec["b"]).requires_grad_()
        ref = F.conv2d(xx, w, b, stride=geo.get("stride", 1), padding=geo["pad"],
                       dilation=geo.get("dilation", 1))
        (ref * torch.cat([torch.from_numpy(g) for g in spec["g_" + name]], dim=2)).sum().backward()
        r = ref.shape[2] // spatial
        for s, res in enumerate(results):
            y, g_x, _, _ = res[name]
            np.testing.assert_allclose(y, ref[:, :, s * r:(s + 1) * r].detach().numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
            np.testing.assert_allclose(g_x, xx.grad[:, :, s * rows:(s + 1) * rows].numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(sum(res[name][2] for res in results), w.grad.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(sum(res[name][3] for res in results), b.grad.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    xx = torch.from_numpy(spec["x"]).requires_grad_()
    ref = F.max_pool2d(xx, 3, 2, ceil_mode=True)
    assert ref.shape[2:] == (8, 3)
    (ref * torch.cat([torch.from_numpy(g) for g in spec["g_pool"]], dim=2)).sum().backward()
    r = 8 // spatial
    for s, res in enumerate(results):
        np.testing.assert_array_equal(res["pool"][0], ref[:, :, s * r:(s + 1) * r].detach().numpy())
        np.testing.assert_array_equal(res["pool"][1], xx.grad[:, :, s * rows:(s + 1) * rows].numpy())


@pytest.fixture(scope="module")
def jax_runs(specs):
    """The JAX package's single device: the train step at (2, 2)'s and
    (1, 4)'s batches and PoseSolver with iter_size 1."""
    import jax
    import jax.numpy as jnp
    from test_torch_solver import jax_cfg
    from deepcut_tpu.parallel.train_step import make_train_step as jax_make_train_step
    from deepcut_tpu.solver import solver as js
    from deepcut_tpu.solver import update_rules as ju

    out = {}
    rule = dict(solver_type="SGD", base_lr=0.001, momentum=0.9, weight_decay=1e-4)
    for shape in ((2, 2), (1, 4)):
        spec = specs[shape]["train_step"]
        cfg = ju.SolverConfig(**rule)
        params = jax.tree_util.tree_map(jnp.asarray, spec["params"])
        state = ju.init_state(cfg, params)
        step = jax_make_train_step(jax_cfg(), cfg, None, donate=False)
        for batch in spec["batches"]:
            params, state, _ = step(params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        out[shape] = params
    spec = specs[2, 2]["solver"]
    batches = iter(spec["batches"])
    jsp = js.SolverParams(config=ju.SolverConfig(**rule), max_iter=100, display=0, snapshot=0,
                          snapshot_prefix="unused")
    jsol = js.PoseSolver(jsp, jax_cfg(), lambda: next(batches),
                         net_params=jax.tree_util.tree_map(jnp.asarray, spec["params"]),
                         handle_signals=False, log=lambda *_: None)
    jsol.step(spec["steps"])
    out["solver"] = jsol.net_params
    return out


@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (1, 4)])
def test_spatial_train_step_matches_single_device(shape, runs, single, jax_runs):
    """tests/test_parallel.py:280 and :456: make_train_step over a (data,
    spatial) mesh follows the single device's trajectory (losses, params,
    momentum), and the JAX package's single device."""
    from test_torch_solver import assert_params_close

    results = runs[shape]
    assert_replicas_equal(results, "train_step")
    for res in results:
        assert_run_close(res["train_step"], single[shape, "train_step"], f"{shape}")
    if shape in jax_runs:
        assert_params_close(_tree(results[0]["train_step"]["params"]), jax_runs[shape])


@pytest.mark.parametrize("name", ["solver", "solver_is"])
def test_pose_solver_spatial_matches_single_device(name, runs, single, jax_runs):
    """tests/test_parallel.py:410 and :496: PoseSolver over a (2, 2) mesh,
    iter_size 1 and 2 (host accumulation of the local gradients, one
    reduction), follows the single device's trajectory."""
    from test_torch_solver import assert_params_close

    results = runs[2, 2]
    assert_replicas_equal(results, name)
    assert_run_close(results[0][name], single[name], name)
    if name in jax_runs:
        assert_params_close(_tree(results[0][name]["params"]), jax_runs[name])


@pytest.mark.parametrize("fault", ["planted_gather", "planted_halo"])
def test_planted_backward_faults_are_caught(fault, runs, single):
    """The gradient-scale trap: a gather backward that keeps only the local
    slice (no sum over the row group) leaves the trunk's gradient at 1x
    while the heads' is Sx; a halo backward that drops the borrowed rows'
    cotangents loses the trunk's border gradients. Both trajectories fall
    outside the tolerance the real one meets; the first forward is still
    the same."""
    got, want = runs[1, 2][0][fault], single[(1, 2), "train_step"]
    np.testing.assert_allclose(got["losses"][0], want["losses"][0], rtol=RTOL, atol=ATOL)
    with pytest.raises(AssertionError):
        assert_run_close(got, want, fault)


def _jax_padded_maps(jest, img, spatial):
    """The JAX package's unsharded forward of the canvas zero-padded to a
    multiple of 8 * S rows, cropped to the frame's grid: (h, w, J), (h, w, 2J)."""
    import jax.numpy as jnp
    from deepcut_tpu.pose import estimate as je

    h, w = img.shape[:2]
    ch, cw = je.canvas_size(h, 1.0), je.canvas_size(w, 1.0)
    canvas = je.preprocess_on_device(jnp.asarray(img), h + je.PAD_SIZE, w + je.PAD_SIZE, ch, cw)
    pad_h = -(-ch // (8 * spatial)) * (8 * spatial)
    canvas = jnp.pad(canvas, ((0, 0), (0, pad_h - ch), (0, 0), (0, 0)))
    sm, loc = jest._forward_maps(pad_h, cw)(jest.params, canvas)
    return np.asarray(sm[0])[:ch // 8], np.asarray(loc[0])[:ch // 8]


def _jax_estimator(spec):
    import jax
    import jax.numpy as jnp
    from deepcut_tpu.models import resnet as jr
    from deepcut_tpu.pose import estimate as je

    kw = {k: getattr(spec["model_cfg"], k) for k in ("depths", "stage_widths", "num_joints")}
    return je.PoseEstimator(jax.tree_util.tree_map(jnp.asarray, spec["params"]),
                            jr.DeeperCutConfig(compute_dtype=jnp.float32, **kw), folded=False)


@pytest.mark.parametrize("spatial", [2, 4])
def test_mesh_estimator_matches_jax_padded_forward(spatial, specs, runs):
    """tests/test_parallel.py:74: PoseEstimator(mesh=).scoremaps equals the
    JAX package's unsharded forward of the same zero-padded canvas (f32),
    the 688-row canvas's uneven res4 / res5 blocks included; every rank
    gets the same maps and pose; the mesh raises the tiling threshold S
    times; exact=True sends exactly the frames that need padding to the
    tiled path, as the JAX package does."""
    from deepcut_tpu_torch.models.convert import params_from_numpy
    from deepcut_tpu_torch.pose.estimate import PoseEstimator

    spec = specs[1, spatial]["estimator"]
    jest = _jax_estimator(spec)
    results = [r["estimator"] for r in runs[1, spatial]]
    assert results[0]["max_dims"] == (spatial * 700, 700)
    for name, (img, exact) in spec["frames"].items():
        if exact:
            continue
        want_sm, want_loc = _jax_padded_maps(jest, img, spatial)
        for res in results:
            sm, loc = res["maps"][name]
            assert sm.shape == want_sm.shape, name
            np.testing.assert_allclose(sm, want_sm, rtol=2e-4, atol=2e-5, err_msg=name)
            np.testing.assert_allclose(loc, want_loc, rtol=2e-4, atol=2e-5, err_msg=name)
            np.testing.assert_array_equal(sm, results[0]["maps"][name][0])
    for res in results[1:]:
        np.testing.assert_array_equal(res["pose"], results[0]["pose"])
    plain = PoseEstimator(params_from_numpy(spec["params"]), spec["model_cfg"], folded=False,
                          device="cpu")
    img = spec["frames"]["pads_exact"][0]
    tiled = plain._scoremaps_tiled(img, 1.0)
    for res in results:
        np.testing.assert_array_equal(res["maps"]["pads_exact"][0],
                                      tiled[0].permute(1, 2, 0).numpy())
        np.testing.assert_array_equal(res["maps"]["divides_exact"][0], res["maps"]["divides"][0])


def test_mesh_estimator_int8_matches_jax(specs, runs):
    """tests/test_parallel.py:900: the int8 forward row-sharded over S = 4
    (int8 halo rows, im2col with (0, pad_w)) on the JAX package's
    quantization equals its unsharded int8 forward of the padded canvas;
    quantize_int8 on the mesh calibrates unsharded and gives every rank
    the single process's scales."""
    from deepcut_tpu_torch.models.convert import params_from_numpy
    from deepcut_tpu_torch.pose.estimate import PoseEstimator

    spec, jest = specs[1, 4]["int8"], specs["jax_int8"]
    results = [r["int8"] for r in runs[1, 4]]
    for name, (img, _) in spec["frames"].items():
        want_sm, want_loc = _jax_padded_maps(jest, img, 4)
        for res in results:
            sm, loc = res["maps"][name]
            np.testing.assert_allclose(sm, want_sm, rtol=2e-4, atol=2e-5, err_msg=name)
            np.testing.assert_allclose(loc, want_loc, rtol=2e-4, atol=2e-5, err_msg=name)
    plain = PoseEstimator(params_from_numpy(spec["params"]), spec["model_cfg"], device="cpu")
    plain.quantize_int8(spec["calib"])
    for res in results:
        assert res["scales"] == plain.model.act_scales


def test_hd_tiled_equals_mesh(specs, runs):
    """tests/test_hd_multiperson.py:70 at 704 x 1280: the host-tiled
    scoremaps (max_size 512) and the full frame over a 4-way row mesh
    agree, and so do their strict local maxima above a shared threshold."""
    from test_hd_multiperson import _local_maxima
    from deepcut_tpu_torch.models.convert import params_from_numpy
    from deepcut_tpu_torch.pose.estimate import PoseEstimator

    spec = specs[1, 4]["hd"]
    img = spec["frames"]["hd"][0]
    tiled = PoseEstimator(params_from_numpy(spec["params"]), spec["model_cfg"], folded=False,
                          device="cpu", max_size=512)
    sm_t, loc_t = tiled.scoremaps(img)
    sm_m, loc_m = runs[1, 4][0]["hd"]["maps"]["hd"]
    assert sm_t.shape == sm_m.shape == (704 // 8, 1280 // 8, 4)
    np.testing.assert_allclose(sm_m, sm_t, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(loc_m, loc_t, rtol=5e-4, atol=5e-4)
    thr = float(np.quantile(sm_m, 0.999))
    eps = 1e-3 * max(1.0, abs(thr))
    peaks_m = _local_maxima(sm_m, thr)
    assert peaks_m, "no strict local maxima above the threshold"
    assert _local_maxima(sm_t, thr + eps) <= peaks_m <= _local_maxima(sm_t, thr - eps)


def test_spatial_value_and_grad_matches_single_device(specs, runs):
    """make_spatial_value_and_grad (the gradient half of the spatial step)
    gives every rank the single device's loss and gradients on the global
    batch, each leaf within 1e-5 of its largest entry."""
    from deepcut_tpu_torch.models import train as tt
    from deepcut_tpu_torch.models.convert import params_from_numpy
    from deepcut_tpu_torch.models.resnet import is_trainable
    from deepcut_tpu_torch.parallel.train_step import batch_preparer

    spec = specs[1, 2]["vg"]
    params = params_from_numpy(spec["params"])
    for name, entry in params.items():
        for v in entry.values():
            v.requires_grad_(is_trainable(name))
    total, _ = tt.loss_fn(params, batch_preparer("cpu")(spec["batches"][0]), spec["model_cfg"])
    total.backward()
    for res in runs[1, 2]:
        got = res["vg"]
        assert got["loss"] == pytest.approx(float(total), rel=RTOL)
        for n, e in params.items():
            for k, v in e.items():
                want = v.grad.numpy() if v.grad is not None else np.zeros(v.shape, np.float32)
                scale = max(float(np.abs(want).max()), 1e-30)
                d = float(np.abs(got["grads"][f"{n}/{k}"] - want).max())
                assert d <= RTOL * scale + 1e-12, f"{n}/{k}: |d| {d:.3g} at scale {scale:.3g}"
