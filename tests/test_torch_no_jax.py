"""The port imports neither jax nor the JAX package: the machine with the
card has no jax installed, and the port keeps its own copies of the JAX
package's jax-free modules.

A subprocess blocks `jax` and `deepcut_tpu` (``sys.modules[name] = None``
makes every import of it raise), imports every module of
`deepcut_tpu_torch`, runs one tiny
CPU `estimate_pose` in bf16 and in int8 (calibrated on the frame), the demo
CLI with and without --int8, trains one CPU step through the port's
`train` verb, and drives the graph engine: a tiny DeeperCut prototxt
through the serving chain with `quantize_int8`, the CLI's `time` and `test`
verbs and a `Classifier` on examples/imagenet/caffenet_deploy.prototxt.
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
assert int8_conv.im2col_launches == int8_conv.epilogue_launches == conv_epilogue.launches == 0
assert not BLOCKED & {m.split(".")[0] for m, mod in sys.modules.items() if mod is not None}
print("modules", len(names))
"""


def test_port_imports_and_runs_without_jax(tmp_path):
    from test_torch_cli import write_dataset, write_solver, write_tamed_weights

    solver = write_solver(tmp_path, write_dataset(tmp_path, n=2), 1)
    weights = write_tamed_weights(tmp_path / "tamed.caffemodel")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp_path / "f.png"), str(tmp_path / "p.npz"),
         str(solver), str(weights), str(REPO / "examples/imagenet/caffenet_deploy.prototxt")],
        env=env, capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    assert int(proc.stdout.split("modules")[-1]) >= 35
    assert "Average forward (make_forward)" in proc.stdout and "prob = " in proc.stdout
    assert "Iteration 0, loss = " in proc.stdout and (tmp_path / "snap" / "pose_iter_1.npz").is_file()
    pose = np.load(tmp_path / "p.npz")["pose"]
    assert pose.shape == (5, 3)
    assert (tmp_path / "p.npz_vis.png").is_file()
    assert np.load(tmp_path / "p.npz.int8.npz")["pose"].shape == (5, 3)
