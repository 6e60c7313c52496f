"""Port training loop (`deepcut_tpu_torch.solver.solver.PoseSolver`,
`parallel.train_step`) against the JAX package's `PoseSolver`.

Both solvers start from the same tamed numpy params and read the same
`PoseDataSource` batches (uint8 canvases, compact annotations rasterized on
the device), on the tiny model of tests/test_torch_training.py:
- a 5-step trajectory (SGD with a multistep rate change, so Caffe's
  rate-in-history shows; Adam with iter_size 2, whose two micro-batches of
  one image make the SGD case's two images a step), losses and params;
- snapshot at step 3 + restore + 2 steps == 5 straight steps (bit-equal);
- `.npz` checkpoints across packages in both directions, training on
  identically; the same keys on both sides;
- the `.caffemodel` export read back by `load_deepercut_params`;
- the eval hook with the port's `PoseEstimator` and PCKh harness;
- `make_train_step` against the JAX one; a spatial mesh= checks its canvas.

Tolerance: losses rtol 1e-5. Params: each leaf within 1e-3 of the
distance it moved from the init (measured <= 8e-5), + 1e-7: the gradients
agree to ~1e-5 of their scale (tests/test_torch_training.py), and the
difference grows with the steps. (At lr 0.01 this tiny model's loss jumps
by 20% a step, which amplifies the difference to 0.4% of the distance;
the rates here keep the dynamics smooth.) A max pool's gradient jumps where
a window's two largest entries swap, and oneDNN on another thread count can
round an exact f32 tie apart; Adam, which divides each step by the root of
the gradient's running square, turns such a jump into a full step on the
elements it reaches. (On two-image micro-batches the Adam trajectory's 10th
forward met such a tie in the stem pool, and on 1-4 threads conv1/w missed
by 1.2x the atol.) Both trajectories here measure within 0.05 of the atol
on 1, 2, 4 and 8 threads.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcut_tpu.proto.caffemodel import load_deepercut_params
from deepcut_tpu.solver import solver as js
from deepcut_tpu.solver import update_rules as ju
from deepcut_tpu.parallel.train_step import make_train_step as jax_make_train_step
from deepcut_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from deepcut_tpu_torch.parallel.train_step import make_eval_step, make_train_step
from deepcut_tpu_torch.solver import solver as ts
from deepcut_tpu_torch.solver import update_rules as tu

from test_torch_resnet import tame_params
from test_torch_training import TCFG, jax_cfg, port_cfg, source

SOLVERS = {
    "sgd_multistep": dict(solver_type="SGD", base_lr=0.001, momentum=0.9, weight_decay=1e-4,
                          lr_policy="multistep", stepvalue=(2, 4), gamma=0.5, clip_gradients=20.0),
    "adam_iter_size2": dict(solver_type="Adam", base_lr=1e-3, momentum=0.9, weight_decay=1e-4,
                            iter_size=2),
}


def _sp(pkg, solver, prefix, **kw):
    cfg_cls = ju.SolverConfig if pkg is js else tu.SolverConfig
    return pkg.SolverParams(config=cfg_cls(**SOLVERS[solver]), max_iter=5, display=1,
                            snapshot=0, snapshot_prefix=str(prefix), **kw)


def _batches(n, size=2):
    src = source(device_targets=True)
    return [src.next_batch(size) for _ in range(n)]


def _feeder(batches, start=0):
    i = [start]

    def nxt():
        b = batches[i[0]]
        i[0] += 1
        return b
    return nxt


def jax_solver(solver, batches, prefix, start=0, params=None):
    return js.PoseSolver(_sp(js, solver, prefix), jax_cfg(), _feeder(batches, start),
                         net_params=jax.tree_util.tree_map(jnp.asarray, params or tame_params(jax_cfg())),
                         handle_signals=False, log=lambda *_: None, target_cfg=TCFG)


def port_solver(solver, batches, prefix, start=0, log=None, **kw):
    return ts.PoseSolver(_sp(ts, solver, prefix), port_cfg(), _feeder(batches, start),
                         net_params=params_from_numpy(tame_params(jax_cfg())),
                         handle_signals=False, log=log or (lambda *_: None),
                         target_cfg=TCFG, device="cpu", **kw)


def assert_params_close(port_params, jax_params):
    ref = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params))
    init = params_from_numpy(tame_params(jax_cfg()))
    assert set(ref) == set(port_params)
    for n in ref:
        for k in ref[n]:
            moved = float((ref[n][k] - init[n][k]).abs().max())
            np.testing.assert_allclose(port_params[n][k].detach().numpy(), ref[n][k].numpy(),
                                       rtol=0, atol=1e-3 * moved + 1e-7, err_msg=f"{n}/{k}")


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_five_step_trajectory_matches_jax(solver, tmp_path):
    iter_size = SOLVERS[solver].get("iter_size", 1)
    batches = _batches(5 * iter_size, size=2 // iter_size)
    jsol, lines = jax_solver(solver, batches, tmp_path / "j"), []
    tsol = port_solver(solver, batches, tmp_path / "t", log=lines.append)
    for step in range(5):
        jsol.step(1)
        tsol.step(1)
        assert tsol.iter == jsol.iter == step + 1
        assert tsol.smoothed_loss == pytest.approx(jsol.smoothed_loss, rel=1e-5), step
    assert_params_close(tsol.net_params, jsol.net_params)
    assert len(lines) == 5 and lines[0].startswith("Iteration 0, loss = ")
    assert "part_loss = " in lines[0] and "lr = " in lines[0]


def test_snapshot_restore_equivalence(tmp_path):
    batches = _batches(5)
    straight = port_solver("sgd_multistep", batches, tmp_path / "a")
    straight.step(5)
    first = port_solver("sgd_multistep", batches, tmp_path / "b")
    first.step(3)
    ckpt = first.snapshot()
    resumed = port_solver("sgd_multistep", batches, tmp_path / "c", start=3)
    resumed.restore(ckpt)
    assert resumed.iter == 3
    resumed.step(2)
    for n, e in straight.net_params.items():
        for k, v in e.items():
            assert torch.equal(resumed.net_params[n][k], v), (n, k)


def test_npz_checkpoints_cross_packages(tmp_path):
    """JAX 2 steps -> .npz -> port 2 steps, and port 2 steps -> .npz -> JAX
    2 steps, both land on the JAX package's straight 4-step trajectory."""
    batches = _batches(4)
    ref = jax_solver("sgd_multistep", batches, tmp_path / "ref")
    ref.step(4)

    j2 = jax_solver("sgd_multistep", batches, tmp_path / "j2")
    j2.step(2)
    jax_ckpt = j2.snapshot(export_caffemodel=False)
    p_cont = port_solver("sgd_multistep", batches, tmp_path / "pc", start=2)
    p_cont.restore(jax_ckpt)
    assert p_cont.iter == 2
    p_cont.step(2)
    assert_params_close(p_cont.net_params, ref.net_params)

    p2 = port_solver("sgd_multistep", batches, tmp_path / "p2")
    p2.step(2)
    port_ckpt = p2.snapshot(export_caffemodel=False)
    with np.load(port_ckpt) as a, np.load(jax_ckpt) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            assert a[key].shape == b[key].shape and a[key].dtype == b[key].dtype, key
    j_cont = jax_solver("sgd_multistep", batches, tmp_path / "jc", start=2)
    j_cont.restore(port_ckpt)
    assert j_cont.iter == 2
    j_cont.step(2)
    assert_params_close(params_from_numpy(jax.tree_util.tree_map(np.asarray, j_cont.net_params)),
                        ref.net_params)


def test_caffemodel_export_reads_back(tmp_path):
    sol = port_solver("sgd_multistep", _batches(1), tmp_path / "snap")
    sol.step(1)
    sol.snapshot()
    loaded = params_from_numpy(load_deepercut_params(str(tmp_path / "snap_iter_1.caffemodel")))
    assert set(loaded) == set(sol.net_params)
    for n, e in sol.net_params.items():
        for k, v in e.items():
            assert torch.equal(loaded[n][k].reshape(v.shape), v.detach()), (n, k)
    back = params_from_numpy(params_to_numpy(sol.net_params))
    assert all(torch.equal(back[n][k], v.detach()) for n, e in sol.net_params.items()
               for k, v in e.items())


def test_eval_hook_with_port_estimator(tmp_path):
    """eval_fn runs on test_interval boundaries before the update, with the
    live params; here it scores the port's PoseEstimator (CPU decode) with
    the port's PCKh harness."""
    from deepcut_tpu_torch.pose.evaluate import evaluate_estimator
    from deepcut_tpu_torch.pose.estimate import PoseEstimator

    rng = np.random.RandomState(3)
    held_out = [{"image": rng.randint(0, 256, (96, 128, 3), np.uint8),
                 "gt_xy": rng.uniform(10, 90, (5, 2)).astype(np.float32), "head_size": 25.0}
                for _ in range(2)]
    calls, lines = [], []

    def eval_fn(params, it):
        est = PoseEstimator(params, port_cfg(), folded=False, bucket_step=32, device="cpu")
        calls.append((it, float(sum(v.detach().abs().sum() for e in params.values()
                                    for v in e.values()))))
        return f"PCKh = {evaluate_estimator(est, held_out).mean:.3f}"

    sol = port_solver("sgd_multistep", _batches(5), tmp_path / "e", eval_fn=eval_fn,
                      log=lines.append)
    sol.params_cfg = dataclasses.replace(sol.params_cfg, test_interval=2)
    sol.step(5)
    assert [it for it, _ in calls] == [0, 2, 4]
    assert calls[0][1] != calls[1][1] != calls[2][1]          # the live params
    tests = [ln for ln in lines if ln.startswith("    Test net output: PCKh = ")]
    assert len(tests) == 3 and "Iteration 2, Testing net" in lines


def test_make_train_step_matches_jax():
    cfg = ju.SolverConfig(**SOLVERS["sgd_multistep"])
    params = tame_params(jax_cfg())
    batch = _batches(1)[0]
    jstep = jax_make_train_step(jax_cfg(), cfg, None, donate=False, target_cfg=TCFG)
    jp, js_, jm = jstep(jax.tree_util.tree_map(jnp.asarray, params),
                        ju.init_state(cfg, jax.tree_util.tree_map(jnp.asarray, params)), batch)
    tcfg = tu.SolverConfig(**SOLVERS["sgd_multistep"])
    tp0 = params_from_numpy(params)
    tstep = make_train_step(port_cfg(), tcfg, target_cfg=TCFG)
    tp, ts_, tm = tstep(tp0, tu.init_state(tcfg, tp0), batch)
    assert float(tm["total_loss"]) == pytest.approx(float(jm["total_loss"]), rel=1e-5)
    assert tm["lr"] == pytest.approx(float(jm["lr"]))
    assert ts_["iter"] == int(js_["iter"]) == 1
    assert_params_close(tp, jp)
    assert tp["conv1"]["w"] is tp0["conv1"]["w"]                  # updated in place
    assert all(v.grad is None for e in tp.values() for v in e.values())
    with torch.no_grad():
        outs = make_eval_step(port_cfg(), folded=False)(tp, torch.zeros(1, 3, 64, 64))
    assert outs["prob"].shape == (1, 5, 8, 8)


def test_mesh_and_iter_size_raise():
    from deepcut_tpu_torch.parallel.mesh import Mesh

    cfg = tu.SolverConfig()
    spatial = Mesh(None, 0, 1, 2, torch.device("cpu"))   # rows over a spatial axis
    # the spatial step checks the shape contract before any collective
    step = make_train_step(port_cfg(), cfg, mesh=spatial)
    params = params_from_numpy(tame_params(jax_cfg()))
    with pytest.raises(ValueError, match="divisible by 16"):
        step(params, tu.init_state(cfg, params),
             {"image": np.zeros((1, 40, 64, 3), np.float32)})
    with pytest.raises(ValueError, match="iter_size"):
        make_train_step(port_cfg(), dataclasses.replace(cfg, iter_size=2))


def test_solver_prototxt_parsing_matches_jax():
    text = """
        net: "train.prototxt"
        base_lr: 0.005  lr_policy: "multistep"
        stepvalue: 220000 stepvalue: 320000
        multistep_lr: 0.005 multistep_lr: 0.002 multistep_lr: 0.001
        momentum: 0.9  weight_decay: 0.0001  max_iter: 420000
        snapshot: 60000  snapshot_prefix: "snap/pose"  display: 20  solver_type: ADAM
    """
    got, ref = ts.SolverParams.from_prototxt(text), js.SolverParams.from_prototxt(text)
    assert dataclasses.asdict(got.config) == dataclasses.asdict(ref.config)
    for f in dataclasses.fields(got):
        if f.name != "config":
            assert getattr(got, f.name) == getattr(ref, f.name), f.name
    assert got.resolve_train_net() == ref.resolve_train_net()


def test_signal_effects_configurable():
    """SIGINT/SIGHUP map to stop/snapshot/none as in the JAX package
    (tools/caffe.cpp GetRequestedAction), and anything else is refused."""
    import os
    import signal

    prev = signal.getsignal(signal.SIGINT), signal.getsignal(signal.SIGHUP)
    try:
        h = ts.SignalHandler(sigint_effect="snapshot", sighup_effect="stop")
        os.kill(os.getpid(), signal.SIGINT)
        assert h.snapshot_requested and not h.stop_requested
        os.kill(os.getpid(), signal.SIGHUP)
        assert h.stop_requested
    finally:
        signal.signal(signal.SIGINT, prev[0])
        signal.signal(signal.SIGHUP, prev[1])
    with pytest.raises(ValueError, match="Invalid signal effect"):
        ts.SignalHandler(enable=False, sigint_effect="pause")


def test_params_the_loss_does_not_read_follow_jax(tmp_path):
    """Params of a head the config leaves out (the pairwise head, with
    pairwise=False) get zero gradients, so only weight decay moves them,
    as in the JAX package; make_train_step does the same."""
    batches = _batches(2)
    params = tame_params(jax_cfg())
    jsol = js.PoseSolver(_sp(js, "sgd_multistep", tmp_path / "j"), jax_cfg(pairwise=False),
                         _feeder(batches), net_params=jax.tree_util.tree_map(jnp.asarray, params),
                         handle_signals=False, log=lambda *_: None, target_cfg=TCFG)
    tsol = ts.PoseSolver(_sp(ts, "sgd_multistep", tmp_path / "t"), port_cfg(pairwise=False),
                         _feeder(batches), net_params=params_from_numpy(params),
                         handle_signals=False, log=lambda *_: None, target_cfg=TCFG, device="cpu")
    jsol.step(2)
    tsol.step(2)
    assert_params_close(tsol.net_params, jsol.net_params)
    moved = tsol.net_params["res5c_up_next"]["w"].detach() - params_from_numpy(params)["res5c_up_next"]["w"]
    assert 0 < float(moved.abs().max()) < 1e-6                  # decay only
    tcfg = tu.SolverConfig(**SOLVERS["sgd_multistep"])
    tp = params_from_numpy(params)
    before = tp["res5c_up_next"]["w"].clone()
    tp, _, _ = make_train_step(port_cfg(pairwise=False), tcfg, target_cfg=TCFG)(
        tp, tu.init_state(tcfg, tp), batches[0])
    assert 0 < float((tp["res5c_up_next"]["w"].detach() - before).abs().max()) < 1e-6
