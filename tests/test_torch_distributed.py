"""Multi-process initialisation of the port (`parallel.distributed`), as
torchrun starts it: tests/test_distributed.py's two-process case.

Two subprocesses get torchrun's environment (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK) and call `initialize()` with no arguments
on the CPU (gloo); each takes one data-parallel GraphSolver step, the
coordinator alone writes the snapshot (the other rank's writer is made to
raise), and both restore it and hold the same params. Then the CLI's
``train -mesh 2`` runs under the same environment, and ``train -mesh 2
-spatial 2`` trains the pose net (ResNet-50 from tamed weights) with the
canvas rows split over the two ranks. Each subprocess is waited for at
most 120 s.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120

NET = """
name: "dp"
layer { name: "data" type: "DummyData" top: "data" top: "label"
  dummy_data_param { shape { dim: 4 dim: 6 } shape { dim: 4 }
    data_filler { type: "gaussian" std: 1 } data_filler { type: "constant" value: 1 } } }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param { num_output: 3 weight_filler { type: "xavier" } } }
layer { name: "drop" type: "Dropout" bottom: "ip" top: "ip" }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" top: "loss" }
"""

WORKER = r"""
import sys
import numpy as np, torch
from deepcut_tpu_torch.parallel import distributed
from deepcut_tpu_torch.parallel.mesh import make_mesh
from deepcut_tpu_torch.solver import solver as solver_mod

dev = distributed.initialize(device="cpu")
rank = torch.distributed.get_rank()
mesh = distributed.global_mesh()
assert (mesh.rank, mesh.data, str(dev)) == (rank, 2, "cpu")
assert distributed.is_coordinator() == (rank == 0)
if rank != 0:
    def refuse(*a, **k):
        raise AssertionError("only the coordinator writes snapshots")
    solver_mod.save_checkpoint = refuse
    solver_mod.GraphSolver._write_snapshot = refuse
sp = solver_mod.SolverParams.from_prototxt(sys.argv[1])
s = solver_mod.GraphSolver(sp, mesh=mesh, handle_signals=False)
s.step(1)
loss = s.smoothed_loss
path = s.snapshot()
before = {n: {k: v.clone() for k, v in e.items()} for n, e in s.net.params.items()}
s.step(1)
s.restore(path)
assert s.iter == 1
for n, e in before.items():
    for k, v in e.items():
        assert torch.equal(s.net.params[n][k], v), (n, k)
print(f"DIST_OK rank={rank} loss={loss:.9g}", flush=True)
distributed.shutdown()
"""


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(argv, world=2, cwd=None):
    """`world` processes with torchrun's environment -> [(rc, out, err)]."""
    port = _port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=str(REPO), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE=str(world), RANK=str(rank),
                   LOCAL_RANK=str(rank), OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen([sys.executable, *argv], env=env, cwd=cwd,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _solver(tmp_path):
    (tmp_path / "net.prototxt").write_text(NET)
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{tmp_path / "net.prototxt"}"\nbase_lr: 0.1\nmomentum: 0.9\n'
                      f'max_iter: 3\ndisplay: 1\nsnapshot: 0\nrandom_seed: 0\n'
                      f'snapshot_prefix: "{tmp_path / "snap"}"\n')
    return solver


def test_two_process_initialize_step_snapshot_restore(tmp_path):
    outs = _launch(["-c", WORKER, str(_solver(tmp_path))])
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{out}\n{err[-3000:]}"
        assert "DIST_OK" in out
    # both ranks computed the same global loss, and one snapshot was written
    losses = {out.split("loss=")[1].split()[0] for _, out, _ in outs}
    assert len(losses) == 1, losses
    assert (tmp_path / "snap_iter_1.npz").is_file()
    assert (tmp_path / "snap_iter_1.caffemodel").is_file()


def test_cli_train_mesh_under_torchrun_env(tmp_path):
    """``train -mesh 2`` in each of two torchrun-style processes: rank 0
    logs the global loss and writes the final snapshot; -mesh that is not
    the world size raises."""
    solver = _solver(tmp_path)
    cli = ["-m", "deepcut_tpu_torch.tools.cli", "train", "-solver", str(solver),
           "-device", "cpu"]
    outs = _launch(cli + ["-mesh", "2"], cwd=str(tmp_path))
    for rc, out, err in outs:
        assert rc == 0, f"rank failed:\n{out}\n{err[-3000:]}"
    assert "Iteration 0, loss = " in outs[0][1] and "Optimization Done." in outs[0][1]
    assert "loss = " not in outs[1][1]
    assert (tmp_path / "snap_iter_3.caffemodel").is_file()
    bad = _launch(cli + ["-mesh", "4"], cwd=str(tmp_path))
    for rc, _, err in bad:
        assert rc != 0 and "4 devices requested but the process group has 2 ranks" in err


def test_cli_train_mesh_spatial_under_torchrun_env(tmp_path):
    """``train -mesh 2 -spatial 2`` on a PoseData solver: a (1, 2) mesh,
    each rank on half the canvas rows (buckets of 64 rows); rank 0 logs a
    finite global loss and writes the snapshot, the other rank is silent;
    -spatial that does not divide the ranks raises."""
    from test_torch_cli import losses, write_dataset, write_solver, write_tamed_weights

    solver = write_solver(tmp_path, write_dataset(tmp_path, n=1), 1)
    weights = write_tamed_weights(tmp_path / "tamed.caffemodel")
    cli = ["-m", "deepcut_tpu_torch.tools.cli", "train", "-solver", str(solver), "-weights",
           str(weights), "-resnet", "50", "-device", "cpu", "-data_workers", "0"]
    outs = _launch(cli + ["-mesh", "2", "-spatial", "2"], cwd=str(tmp_path))
    for rc, out, err in outs:
        assert rc == 0, f"rank failed:\n{out}\n{err[-3000:]}"
    got = losses(outs[0][1])
    assert len(got) == 1 and 0 < got[0] < 100, outs[0][1]
    assert "loss = " not in outs[1][1]
    assert (tmp_path / "snap" / "pose_iter_1.npz").is_file()
    bad = _launch(cli + ["-mesh", "2", "-spatial", "3"], cwd=str(tmp_path))
    for rc, _, err in bad:
        assert rc != 0 and "not divisible by spatial=3" in err
