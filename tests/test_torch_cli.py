"""The port's `train` verb (`deepcut_tpu_torch.tools.cli`) end to end on the
CPU: a synthetic window file, copies of examples/pose/pose_train.prototxt
and pose_solver.prototxt pointing at it, ResNet-50 (the smallest depth the
verb builds) on small frames. A random 50-layer init diverges within two
steps (loss 3e5, then 4e12, then NaN), so the first run finetunes from a
tamed random `.caffemodel` (-weights, the path users take), in f32, with
snapshots; the second resumes from that `.npz` under -mixed_precision
-remat -augment_device; a third takes host-rasterized targets at batch 2.
-mesh outside a torchrun job and -spatial without -mesh raise; a Data-layer solver
trains through GraphSolver. The data slice's verbs against the JAX
package's: `test` and `extract_features` on a Data-layer net, the three
`upgrade_*` verbs (byte-equal files) and the four deprecated aliases.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from deepcut_tpu.data.window_file import ImageRecord, Person, write_window_file
from deepcut_tpu.proto.caffemodel import save_caffemodel
from deepcut_tpu_torch.models.convert import params_to_numpy
from deepcut_tpu_torch.models.resnet import deepercut_config, init_params
from deepcut_tpu_torch.tools import cli

REPO = Path(__file__).resolve().parents[1]


def write_dataset(root: Path, n=3, h=120, w=160, seed=0):
    from PIL import Image

    rng = np.random.RandomState(seed)
    recs = []
    for i in range(n):
        path = root / f"im{i}.png"
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(path)
        k = rng.randint(8, 15)
        classes = (rng.permutation(14)[:k] + 1).astype(np.int32)
        xy = np.stack([rng.uniform(10, w - 10, k), rng.uniform(10, h - 10, k)], 1)
        recs.append(ImageRecord(str(path), 3, h, w, [Person(classes, xy.astype(np.float32))]))
    index = root / "train_index.txt"
    write_window_file(str(index), recs)
    return index


def write_solver(root: Path, index: Path, max_iter: int, name: str = "solver") -> Path:
    net = (REPO / "examples/pose/pose_train.prototxt").read_text().replace(
        "examples/pose/train_index.txt", str(index))
    (root / "train.prototxt").write_text(net)
    solver = (REPO / "examples/pose/pose_solver.prototxt").read_text()
    solver = solver.replace('net: "examples/pose/pose_train.prototxt"', f'net: "{root}/train.prototxt"')
    solver = solver.replace('snapshot_prefix: "examples/pose/snapshots/pose"',
                            f'snapshot_prefix: "{root}/snap/pose"')
    for key, val in (("max_iter", max_iter), ("display", 1), ("snapshot", 2), ("base_lr", 1e-5)):
        solver = "\n".join(f"{key}: {val}" if ln.startswith(f"{key}:") else ln
                           for ln in solver.splitlines())
    solver = solver.replace("multistep_lr: 0.005", "multistep_lr: 0.00001") + "\nrandom_seed: 1\n"
    path = root / f"{name}.prototxt"
    path.write_text(solver)
    return path


def write_tamed_weights(path: Path) -> Path:
    """ResNet-50 at random init with the residual branches' last BN scale at
    0.1 and conv1 x1e-3, so the activations stay O(1) through 16 blocks."""
    params = init_params(torch.Generator().manual_seed(0), deepercut_config(50, pairwise=False))
    for name, p in params.items():
        if name.startswith("scale") and name.endswith("_branch2c"):
            p["gamma"] = torch.full_like(p["gamma"], 0.1)
    params["conv1"]["w"] = params["conv1"]["w"] * 1e-3
    save_caffemodel(str(path), params_to_numpy(params))
    return path


def losses(out: str):
    return [float(ln.split("loss = ")[1].split()[0]) for ln in out.splitlines()
            if ln.startswith("Iteration ") and "loss = " in ln]


def test_train_verb_f32_then_resume_mixed(tmp_path, capsys):
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    index = write_dataset(tmp_path)
    base = ["train", "-resnet", "50", "-device", "cpu", "-data_workers", "0"]
    try:
        assert cli.main(base + ["-solver", str(write_solver(tmp_path, index, 2)),
                                "-weights", str(write_tamed_weights(tmp_path / "tamed.caffemodel"))]) == 0
        out = capsys.readouterr().out
        assert out.splitlines()[0].startswith("f32 training: TF32 off")
        assert not torch.backends.cudnn.allow_tf32
        first = losses(out)
        assert len(first) == 2 and all(math.isfinite(v) and 0 < v < 100 for v in first), out
        snap = tmp_path / "snap" / "pose_iter_2"
        assert snap.with_suffix(".npz").is_file() and snap.with_suffix(".caffemodel").is_file()

        resume = write_solver(tmp_path, index, 3, name="resume")
        assert cli.main(base + ["-solver", str(resume), "-snapshot", str(snap.with_suffix(".npz")),
                                "-mixed_precision", "-remat", "-augment_device"]) == 0
        out = capsys.readouterr().out
        assert out.splitlines()[0].startswith("mixed precision")
        assert "Restored from" in out and "at iter 2" in out
        assert [ln.split(",")[0] for ln in out.splitlines() if "loss = " in ln] == ["Iteration 2"]
        assert all(math.isfinite(v) and 0 < v < 100 for v in losses(out)), out
        assert (tmp_path / "snap" / "pose_iter_3.npz").is_file()

        host = write_solver(tmp_path, index, 1, name="host")
        assert cli.main(base + ["-solver", str(host), "-weights", str(tmp_path / "tamed.caffemodel"),
                                "-host_targets", "-batch_size", "2"]) == 0
        out = capsys.readouterr().out
        assert len(losses(out)) == 1 and all(math.isfinite(v) for v in losses(out)), out
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def test_unported_paths_raise(tmp_path, capsys, monkeypatch):
    index = write_dataset(tmp_path, n=1)
    solver = write_solver(tmp_path, index, 1)
    # -mesh N outside a torchrun job: no process group can form, and it raises
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        cli.main(["train", "-solver", str(solver), "-mesh", "2", "-device", "cpu"])
    # -spatial shards rows over the ranks of a mesh: without -mesh it raises
    with pytest.raises(ValueError, match="pass -mesh N"):
        cli.main(["train", "-solver", str(solver), "-spatial", "2", "-device", "cpu"])
    # a net fed by a Data layer trains through GraphSolver (the data slice)
    net, _ = data_net(tmp_path)
    (tmp_path / "graph_solver.prototxt").write_text(
        f'net: "{net}"\nbase_lr: 0.1\nmax_iter: 2\ndisplay: 1\nsnapshot: 0\n')
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        assert cli.main(["train", "-solver", str(tmp_path / "graph_solver.prototxt"),
                         "-device", "cpu"]) == 0
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    out = capsys.readouterr().out
    assert [ln.split(",")[0] for ln in out.splitlines() if "loss = " in ln] == [
        "Iteration 0", "Iteration 1", "Iteration 2"], out


# -- the data slice's verbs against the JAX package's ------------------------------------
def data_net(root: Path):
    """A small CaffeNet-like net fed by a Data layer on an LMDB of 24 seeded
    3x12x12 Datums (crop 10, mean values), with a loss and an accuracy, and
    its weights as a `.caffemodel` written by the JAX package."""
    from deepcut_tpu.data.datum import Datum
    from deepcut_tpu.data.lmdb_store import LMDBWriter
    from deepcut_tpu.core.graph import Net as JNet
    from deepcut_tpu.proto import text_format as j_text

    rng = np.random.RandomState(0)
    with LMDBWriter(str(root / "db")) as w:
        for i in range(24):
            w.put(f"{i:08d}".encode(), Datum.from_array(
                rng.randint(0, 256, (3, 12, 12), np.uint8), i % 4).encode())
    text = f"""name: "small"
layer {{ name: "data" type: "Data" top: "data" top: "label"
  data_param {{ source: "{root}/db" batch_size: 6 backend: LMDB }}
  transform_param {{ crop_size: 10 mean_value: 120 scale: 0.02 }} }}
layer {{ name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param {{ num_output: 8 kernel_size: 3 weight_filler {{ type: "gaussian" std: 0.1 }} }} }}
layer {{ name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }}
layer {{ name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param {{ pool: MAX kernel_size: 2 stride: 2 }} }}
layer {{ name: "fc" type: "InnerProduct" bottom: "pool1" top: "fc"
  inner_product_param {{ num_output: 4 weight_filler {{ type: "gaussian" std: 0.1 }} }} }}
layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "fc" bottom: "label" top: "loss" }}
layer {{ name: "accuracy" type: "Accuracy" bottom: "fc" bottom: "label" top: "accuracy"
  include {{ phase: TEST }} }}
"""
    net = root / "small.prototxt"
    net.write_text(text)
    jnet = JNet(j_text.parse(text), phase="TEST", compute_dtype=None)
    jnet.forward()
    from deepcut_tpu.proto.caffemodel import save_caffemodel as j_save

    import jax

    j_save(str(root / "small.caffemodel"), jax.tree_util.tree_map(np.asarray, jnet.params),
           net_name="small")
    for src in jnet.data_sources.values():
        src.stop()
    return net, root / "small.caffemodel"


def _printed(out: str):
    return {ln.split(" = ")[0]: float(ln.split(" = ")[1]) for ln in out.splitlines() if " = " in ln}


def test_test_verb_pulls_from_the_data_layers(tmp_path, capsys):
    """`test` on a Data-layer net: the port's f32 means equal the JAX
    package's within 1e-5 (f32 convs in different orders), and its bf16
    run within 2e-2 of them (bf16 operands at the loss's scale)."""
    from deepcut_tpu.tools import cli as j_cli

    net, weights = data_net(tmp_path)
    args = ["test", "-model", str(net), "-weights", str(weights), "-iterations", "3"]
    assert j_cli.main(args + ["-fp32"]) == 0
    want = _printed(capsys.readouterr().out)
    assert cli.main(args + ["-fp32", "-device", "cpu"]) == 0
    got = _printed(capsys.readouterr().out)
    assert sorted(got) == sorted(want) == ["accuracy", "loss"]
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 1.0), (k, got[k], want[k])
    assert cli.main(args + ["-device", "cpu"]) == 0
    bf16 = _printed(capsys.readouterr().out)
    assert abs(bf16["loss"] - want["loss"]) <= 2e-2 * abs(want["loss"])


def test_extract_features_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    from deepcut_tpu.tools import cli as j_cli

    net, weights = data_net(tmp_path)
    args = ["extract_features", "-model", str(net), "-weights", str(weights), "-blobs",
            "fc,pool1", "-iterations", "2", "-fp32"]
    assert j_cli.main(args + ["-out", str(tmp_path / "j.h5")]) == 0
    assert cli.main(args + ["-out", str(tmp_path / "t.h5"), "-device", "cpu"]) == 0
    with h5py.File(tmp_path / "t.h5", "r") as a, h5py.File(tmp_path / "j.h5", "r") as b:
        assert sorted(a) == sorted(b) == ["fc", "pool1"]
        assert a["fc"].shape == (12, 4) and a["pool1"].shape == (12, 8, 4, 4)
        for k in a:
            np.testing.assert_allclose(a[k][:], b[k][:], rtol=1e-5, atol=1e-6, err_msg=k)
    # the default bf16 stream runs too
    assert cli.main(args[:-1] + ["-out", str(tmp_path / "bf16.h5"), "-device", "cpu"]) == 0
    with h5py.File(tmp_path / "bf16.h5", "r") as a:
        assert a["fc"].shape == (12, 4) and np.isfinite(a["fc"][:]).all()


def _legacy_inputs(root: Path):
    from collections import OrderedDict

    from deepcut_tpu.proto.caffemodel import encode_netparameter

    (root / "v1.prototxt").write_text(
        'name: "v1"\ninput: "data"\ninput_dim: 1 input_dim: 3 input_dim: 8 input_dim: 8\n'
        'layers { name: "conv" type: CONVOLUTION bottom: "data" top: "conv" '
        'convolution_param { num_output: 4 kernel_size: 3 } }\n'
        'layers { name: "relu" type: RELU bottom: "conv" top: "conv" }\n'
        'layers { name: "pool" type: POOLING bottom: "conv" top: "pool" '
        'pooling_param { pool: MAX kernel_size: 2 stride: 2 } }\n')
    rng = np.random.RandomState(0)
    layers = OrderedDict(conv=[rng.randn(4, 3, 3, 3).astype(np.float32),
                               rng.randn(4).astype(np.float32)],
                         ip=[rng.randn(5, 36).astype(np.float32)])
    (root / "v0.caffemodel").write_bytes(encode_netparameter(layers, container="v0"))
    (root / "solver.prototxt").write_text("base_lr: 0.01\nsolver_type: NESTEROV\nmax_iter: 100\n")
    return {"upgrade_net_proto": "v1.prototxt", "upgrade_net_proto_binary": "v0.caffemodel",
            "upgrade_solver_proto": "solver.prototxt"}


@pytest.mark.parametrize("verb", ["upgrade_net_proto", "upgrade_net_proto_binary",
                                  "upgrade_solver_proto"])
def test_upgrade_verbs_write_the_jax_packages_bytes(tmp_path, verb, capsys):
    from deepcut_tpu.tools import cli as j_cli

    src = tmp_path / _legacy_inputs(tmp_path)[verb]
    assert j_cli.main([verb, str(src), str(tmp_path / "j.out")]) == 0
    assert cli.main([verb, str(src), str(tmp_path / "t.out")]) == 0
    assert (tmp_path / "t.out").read_bytes() == (tmp_path / "j.out").read_bytes()
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("j.out", "t.out") == out[1]


@pytest.mark.parametrize("alias", ["train_net", "finetune_net", "test_net", "net_speed_benchmark"])
def test_deprecated_aliases_warn_and_run_their_verb(tmp_path, alias, capsys):
    """The reference's deprecated tools print its warning and run the verb
    they name: the same warning as the JAX package's (under the port's
    name) and the verb's own result."""
    from deepcut_tpu.tools import cli as j_cli

    net, weights = data_net(tmp_path)
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{net}"\nbase_lr: 0.05\nmax_iter: 2\ndisplay: 0\nsnapshot: 0\n'
                      f'snapshot_prefix: "{tmp_path}/dep"\n')
    argv = {"train_net": [str(solver)], "finetune_net": [str(solver), str(weights)],
            "test_net": [str(net), str(weights), "2"], "net_speed_benchmark": [str(net), "2"]}[alias]
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        with pytest.MonkeyPatch.context() as mp:   # the port's verbs on the CPU
            mp.setattr(cli, "_graph_net", _cpu(cli._graph_net))
            mp.setattr(cli, "train_graph", _cpu(cli.train_graph))
            assert cli.main([alias] + argv) == 0
        got = capsys.readouterr()
        if alias in ("train_net", "finetune_net"):
            assert (tmp_path / "dep_iter_2.caffemodel").is_file()
        assert j_cli.main([alias] + argv) == 0
        want = capsys.readouterr()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert got.err.strip() == want.err.strip().replace("deepcut_tpu ", "deepcut_tpu_torch ")
    assert f"{alias} is deprecated" in got.err
    if alias == "test_net":
        g, w = _printed(got.out), _printed(want.out)
        assert sorted(g) == sorted(w) == ["accuracy", "loss"]
        assert abs(g["loss"] - w["loss"]) <= 2e-2 * abs(w["loss"])


def _cpu(fn):
    """A verb's function with its ``device`` argument set to the CPU."""
    def run(args, *rest, **kw):
        args.device = "cpu"
        return fn(args, *rest, **kw)
    return run
