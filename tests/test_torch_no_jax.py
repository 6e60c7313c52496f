"""The port imports neither jax nor the JAX package: the machine with the
card has no jax installed, and the port keeps its own copies of the JAX
package's jax-free modules.

A subprocess blocks `jax` and `deepcut_tpu` (``sys.modules[name] = None``
makes every import of it raise), imports every module of
`deepcut_tpu_torch`, runs one tiny
CPU `estimate_pose` in bf16 and in int8 (calibrated on the frame), the demo
CLI with and without --int8, the pose service's default path
(`examples.pose.serve.PoseApp` on the cached estimator, float and int8),
`examples.classification`'s main on a tiny deploy net, trains one CPU
step through the port's
`train` verb, and drives the graph engine: a tiny DeeperCut prototxt
through the serving chain with `quantize_int8`, the CLI's `time` and `test`
verbs and a `Classifier` on examples/imagenet/caffenet_deploy.prototxt;
then its training: `train` on a DummyData solver (GraphSolver),
`compat.get_solver` with a step and a test net, `Net.backward`, the
port's PCKh (`pose.evaluate`), and the data slice: `convert_imageset`,
`compute_image_mean` and `test` on a Data-layer net; the matcaffe
gateway's `get_net` / `net_forward` on the CPU (its default device
`cuda:0` read first), and two data-parallel GraphSolver steps in a gloo
group of one. Two more subprocesses, blocking both too, form a gloo group
of two and drive the spatial slice (`parallel.spatial`,
`parallel.graph_spatial`) on a (1, 2) mesh: a row-sharded train step, a
`PoseEstimator(mesh=)` in bf16 and int8, and a graph net's spatial step.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["deepcut_tpu"] = None
BLOCKED = {"jax", "deepcut_tpu"}
import numpy as np, torch
import deepcut_tpu_torch

names = [m.name for m in pkgutil.walk_packages(deepcut_tpu_torch.__path__, "deepcut_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not BLOCKED & {m.split(".")[0] for m, mod in sys.modules.items() if mod is not None}

from deepcut_tpu_torch.models.resnet import DeeperCutConfig, init_params
from deepcut_tpu_torch.pose import estimate, demo
from deepcut_tpu_torch.ops import conv_epilogue, cuda_decode, int8_conv

cfg = DeeperCutConfig(depths=(1, 1, 1, 1), stage_widths=(4, 4, 8, 8), num_joints=3)
params = init_params(torch.Generator().manual_seed(0), cfg)
est = estimate.PoseEstimator(params, cfg, device="cpu")  # folded, bf16 trunk
img = np.random.RandomState(0).randint(0, 256, (70, 90, 3), np.uint8)
pose = est.estimate_pose(img)
assert pose.shape == (5, 3) and np.isfinite(pose).all(), pose
est8 = estimate.PoseEstimator(params, cfg, device="cpu")
est8.quantize_int8(img)
pose8 = est8.estimate_pose(img)
assert est8.is_int8 and pose8.shape == (5, 3) and np.isfinite(pose8).all(), pose8
assert cuda_decode.launches == cuda_decode.prob_launches == conv_epilogue.launches == 0
assert int8_conv.im2col_launches == int8_conv.epilogue_launches == int8_conv.quantize_launches == 0
estimate._MODEL_CACHE[("", "", "cpu")] = est
from PIL import Image
Image.fromarray(img[:, :, ::-1]).save(sys.argv[1])
assert demo.main([sys.argv[1], "--device", "cpu", "--out_name", sys.argv[2]]) == 0
assert demo.main([sys.argv[1], "--device", "cpu", "--int8", "--out_name", sys.argv[2] + ".int8.npz"]) == 0
assert not est.is_int8  # the demo quantized a private estimator
import io
from deepcut_tpu_torch.examples.pose import serve
png = io.BytesIO()
Image.fromarray(img[:, :, ::-1]).save(png, format="PNG")
app = serve.PoseApp(device="cpu")  # the service's default path: get_estimator's cached one
assert app.est is est
answer = app.estimate_bytes(png.getvalue())
assert len(answer["pose"]) == 5 and len(answer["joints"]) == 3, answer
app8 = serve.PoseApp(device="cpu", int8=True)  # a private copy, calibrated on the request
assert len(app8.estimate_bytes(png.getvalue())["pose"]) == 5
assert app8.est.is_int8 and not est.is_int8

from deepcut_tpu_torch.tools import cli
assert cli.main(["train", "-solver", sys.argv[3], "-weights", sys.argv[4], "-resnet", "50",
                 "-device", "cpu", "-data_workers", "0"]) == 0

from deepcut_tpu_torch.classifier import Classifier
from deepcut_tpu_torch.core.graph import Net
from deepcut_tpu_torch.models.prototxt import deepercut_deploy
gnet = Net(deepercut_deploy(cfg, (1, 3, 40, 40)).to_proto(), device="cpu")
gnet.fold_bn(); gnet.prune(["fc_pose", "prob"]); gnet.fuse_siblings()
xg = np.random.RandomState(1).randn(1, 3, 40, 40).astype(np.float32)
assert gnet.quantize_int8(data=xg) > 0
gnet.cast_weights()
outg = gnet.make_forward(["prob"])(gnet.params, {"data": torch.from_numpy(xg)})
assert outg["prob"].shape == (1, 3, 5, 5) and bool(torch.isfinite(outg["prob"]).all())
assert cli.main(["time", "-model", sys.argv[5], "-iterations", "1", "-device", "cpu"]) == 0
assert cli.main(["test", "-model", sys.argv[5], "-iterations", "1", "-device", "cpu"]) == 0
pred = Classifier(sys.argv[5], image_dims=(256, 256), raw_scale=255, device="cpu").predict(
    [np.random.RandomState(2).rand(300, 280, 3).astype(np.float32)])
assert pred.shape == (1, 8) and abs(float(pred.sum()) - 1) < 1e-4, pred
from deepcut_tpu_torch import compat
from deepcut_tpu_torch.examples import classification
with open("tiny.prototxt", "w") as f:
    f.write(sys.argv[8])
compat.Net("tiny.prototxt", compat.TEST, device="cpu").save("tiny.caffemodel")
assert classification.main(["tiny.prototxt", "tiny.caffemodel", sys.argv[1], "--device", "cpu"]) == 0
assert int8_conv.im2col_launches == int8_conv.epilogue_launches == conv_epilogue.launches == 0

from deepcut_tpu_torch import compat
from deepcut_tpu_torch.pose.evaluate import pckh
assert cli.main(["train", "-solver", sys.argv[6], "-device", "cpu"]) == 0
solver = compat.get_solver(sys.argv[6], device="cpu")
solver.step(2)
assert solver.iter == 2 and np.isfinite(solver.smoothed_loss)
out = solver.test_nets[0].forward()
solver.net.forward()
grads = solver.net.backward(diffs=["ip"])
assert solver.net.blobs["ip"].diff.shape == (4, 3) and "acc" in out
assert pckh(np.zeros((1, 2, 2)), np.ones((1, 2, 2)), np.array([4.0])).mean == 1.0

from deepcut_tpu_torch.tools import datasets
assert {f"deepcut_tpu_torch.{m}" for m in (
    "data.datum", "data.lmdb_store", "data.leveldb_store", "data.transformer", "data.layers",
    "tools.datasets", "tools.parse_log", "tools.log_tools", "tools.draw")} <= set(names)
with open("list.txt", "w") as f:
    f.write(f"{sys.argv[1]} 0\n{sys.argv[1]} 1\n")
assert datasets.main(["convert_imageset", "list.txt", "db", "--resize", "16", "16"]) == 0
assert datasets.main(["compute_image_mean", "db", "mean.binaryproto"]) == 0
assert cli.main(["test", "-model", sys.argv[7], "-iterations", "2", "-device", "cpu"]) == 0

from deepcut_tpu_torch import matlab_gateway as gw
assert gw.device() == "cuda:0"   # the default, before any command
gw.dispatch("set_mode_cpu", [])
(h,) = gw.dispatch("get_net", ["g.prototxt", "train"])
gw.dispatch("net_forward", [h])
names_attr = dict(gw.dispatch("net_get_attr", [h])[0]["fields"])
assert names_attr["blob_names"]["v"] == ["data", "label", "ip", "loss"]
import socket
from deepcut_tpu_torch.parallel import distributed
from deepcut_tpu_torch.parallel.mesh import make_mesh
from deepcut_tpu_torch.solver.solver import GraphSolver, SolverParams
with socket.socket() as sk:
    sk.bind(("127.0.0.1", 0))
    port = sk.getsockname()[1]
distributed.initialize(f"tcp://127.0.0.1:{port}", 1, 0, device="cpu")
dp = GraphSolver(SolverParams.from_prototxt(sys.argv[6]), mesh=make_mesh(1), handle_signals=False)
dp.step(2)
assert dp.iter == 2 and np.isfinite(dp.smoothed_loss)
distributed.shutdown()
assert not BLOCKED & {m.split(".")[0] for m, mod in sys.modules.items() if mod is not None}
assert {"deepcut_tpu_torch.parallel.spatial", "deepcut_tpu_torch.parallel.graph_spatial"} <= set(names)
print("modules", len(names))
"""

SPATIAL_WORKER = r"""
import sys
sys.modules["jax"] = None
sys.modules["deepcut_tpu"] = None
import numpy as np, torch
from deepcut_tpu_torch.core.graph import Net
from deepcut_tpu_torch.models.resnet import DeeperCutConfig, init_params
from deepcut_tpu_torch.parallel import distributed
from deepcut_tpu_torch.parallel.mesh import make_mesh
from deepcut_tpu_torch.parallel.train_step import make_train_step
from deepcut_tpu_torch.pose.estimate import PoseEstimator
from deepcut_tpu_torch.proto import text_format
from deepcut_tpu_torch.solver import update_rules

distributed.initialize(device="cpu")
mesh = make_mesh(2, spatial=2)
cfg = DeeperCutConfig(depths=(1, 1, 1, 1), stage_widths=(4, 4, 8, 8), num_joints=3,
                      pairwise=False)
params = init_params(torch.Generator().manual_seed(0), cfg)
est = PoseEstimator(params, cfg, mesh=mesh)
img = np.random.RandomState(0).randint(0, 256, (100, 90, 3), np.uint8)
sm, _ = est.scoremaps(img)
est.quantize_int8(img)
sm8, _ = est.scoremaps(img)
assert sm.shape == sm8.shape == (13, 12, 3) and np.isfinite(sm8).all()
fcfg = DeeperCutConfig(depths=(1, 1, 1, 1), stage_widths=(4, 4, 8, 8), num_joints=3,
                       pairwise=False, compute_dtype=torch.float32)
scfg = update_rules.SolverConfig(base_lr=1e-4)
p = init_params(torch.Generator().manual_seed(0), fcfg)
rng = np.random.RandomState(1)
batch = {"image": rng.randn(2, 64, 32, 3).astype(np.float32),
         "part_score_targets": np.zeros((2, 8, 4, 3), np.float32),
         "part_score_weights": np.ones((2, 8, 4, 3), np.float32)}
p, _, metrics = make_train_step(fcfg, scfg, mesh)(p, update_rules.init_state(scfg, p), batch)
assert np.isfinite(float(metrics["total_loss"]))
net = Net(text_format.parse(sys.argv[1]), phase="TRAIN", compute_dtype=None, device="cpu")
step = net.make_train_step(scfg, mesh=mesh)
_, _, loss = step(net.params, update_rules.init_state(scfg, net.params),
                  {"data": rng.randn(2, 3, 16, 16).astype(np.float32),
                   "label": np.array([0.0, 1.0], np.float32)})
assert np.isfinite(float(loss)) and next(iter(step.plans.values()))[0] == 2
distributed.shutdown()
assert not {"jax", "deepcut_tpu"} & {m.split(".")[0] for m, mod in sys.modules.items()
                                      if mod is not None}
print("SPATIAL_OK", flush=True)
"""

TINY_DEPLOY = """
input: "data"  input_shape { dim: 10 dim: 3 dim: 16 dim: 16 }
layer { name: "c1" type: "Convolution" bottom: "data" top: "c1"
  convolution_param { num_output: 4 kernel_size: 3 stride: 2 weight_filler { type: "xavier" } } }
layer { name: "ip" type: "InnerProduct" bottom: "c1" top: "ip"
  inner_product_param { num_output: 6 weight_filler { type: "xavier" } } }
layer { name: "prob" type: "Softmax" bottom: "ip" top: "prob" }
"""

CONV_NET = """
input: "data"  input_shape { dim: 2 dim: 3 dim: 16 dim: 16 }
input: "label" input_shape { dim: 2 }
layer { name: "c1" type: "Convolution" bottom: "data" top: "c1"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 weight_filler { type: "xavier" } } }
layer { name: "r1" type: "ReLU" bottom: "c1" top: "c1" }
layer { name: "ip" type: "InnerProduct" bottom: "c1" top: "ip"
  inner_product_param { num_output: 2 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" top: "loss" }
"""

GRAPH_NET = """
name: "g"
layer { name: "data" type: "DummyData" top: "data" top: "label"
  dummy_data_param { shape { dim: 4 dim: 6 } shape { dim: 4 }
    data_filler { type: "gaussian" std: 1 } data_filler { type: "constant" value: 1 } } }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param { num_output: 3 weight_filler { type: "xavier" } } }
layer { name: "drop" type: "Dropout" bottom: "ip" top: "ip" }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" top: "loss" }
layer { name: "acc" type: "Accuracy" bottom: "ip" bottom: "label" top: "acc"
  include { phase: TEST } }
"""


DATA_NET = """
layer { name: "data" type: "Data" top: "data" top: "label" data_param { source: "db" batch_size: 2 }
  transform_param { crop_size: 12 mean_file: "mean.binaryproto" } }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param { num_output: 2 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" top: "loss" }
"""


def test_port_imports_and_runs_without_jax(tmp_path):
    from test_torch_cli import write_dataset, write_solver, write_tamed_weights

    solver = write_solver(tmp_path, write_dataset(tmp_path, n=2), 1)
    weights = write_tamed_weights(tmp_path / "tamed.caffemodel")
    (tmp_path / "g.prototxt").write_text(GRAPH_NET)
    (tmp_path / "data.prototxt").write_text(DATA_NET)
    graph_solver = tmp_path / "g_solver.prototxt"
    graph_solver.write_text(f'net: "{tmp_path / "g.prototxt"}"\nbase_lr: 0.1\nmax_iter: 2\n'
                            f'display: 1\ntest_iter: 1\ntest_interval: 2\n'
                            f'snapshot_prefix: "{tmp_path / "g"}"\n')
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp_path / "f.png"), str(tmp_path / "p.npz"),
         str(solver), str(weights), str(REPO / "examples/imagenet/caffenet_deploy.prototxt"),
         str(graph_solver), str(tmp_path / "data.prototxt"), TINY_DEPLOY],
        env=env, capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    assert int(proc.stdout.split("modules")[-1]) >= 35
    assert "Average forward (make_forward)" in proc.stdout and "prob = " in proc.stdout
    assert "Iteration 0, loss = " in proc.stdout and (tmp_path / "snap" / "pose_iter_1.npz").is_file()
    pose = np.load(tmp_path / "p.npz")["pose"]
    assert pose.shape == (5, 3)
    assert (tmp_path / "p.npz_vis.png").is_file()
    assert np.load(tmp_path / "p.npz.int8.npz")["pose"].shape == (5, 3)
    assert "Testing net (#0)" in proc.stdout and (tmp_path / "g_iter_2.caffemodel").is_file()
    assert f"{tmp_path / 'f.png'}\n  " in proc.stdout and "  class " in proc.stdout
    assert "Processed 2 files into db" in proc.stdout and "loss = " in proc.stdout.split("mean of")[-1]


def test_spatial_slice_runs_without_jax():
    from test_torch_distributed import _launch

    outs = _launch(["-c", SPATIAL_WORKER, CONV_NET])
    for rc, out, err in outs:
        assert rc == 0 and "SPATIAL_OK" in out, f"worker failed:\n{out}\n{err[-3000:]}"
