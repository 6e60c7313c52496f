"""The port's dataset makers (`deepcut_tpu_torch.examples.*.make_dataset`,
`finetune_pascal_detection.make_windows`) against the JAX package's under
`examples/`, on the CPU: at the same seed and count each writes the same
files, byte for byte (LMDB and LevelDB stores, PNGs, list and window files,
mean `.binaryproto`, HDF5). Both makers write into the same directory in
turn, so the absolute paths that list and window files hold are equal too.

Then the prototxts' paths: the mnist maker's default output is the LMDB
that examples/mnist/lenet_train.prototxt names, and the port's `cli train`
on examples/mnist/lenet_solver.prototxt trains from it. Without h5py the
HDF5 maker raises an ImportError naming it, before writing anything.
"""

import contextlib
import hashlib
import importlib.util
import io as pyio
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from deepcut_tpu_torch.examples.cifar10 import make_dataset as t_cifar10
from deepcut_tpu_torch.examples.finetune_pascal_detection import make_windows as t_pascal
from deepcut_tpu_torch.examples.hdf5_classification import make_dataset as t_hdf5
from deepcut_tpu_torch.examples.imagenet import make_dataset as t_imagenet
from deepcut_tpu_torch.examples.mnist import make_dataset as t_mnist
from deepcut_tpu_torch.examples.siamese import make_dataset as t_siamese
from deepcut_tpu_torch.tools import cli as t_cli

REPO = Path(__file__).resolve().parents[1]


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


MAKERS = {
    "mnist": ("examples/mnist/make_dataset.py",
              lambda m, out: m.make_lmdb(out, 120, seed=3)),
    "cifar10": ("examples/cifar10/make_dataset.py", lambda m, out: m.main(60, out)),
    "imagenet": ("examples/imagenet/make_dataset.py",
                 lambda m, out: m.main(24, out, n_classes=4)),
    "siamese": ("examples/siamese/make_dataset.py",
                lambda m, out: m.make_pair_db(out, n_pairs=50, seed=1)),
    "hdf5_classification": ("examples/hdf5_classification/make_dataset.py",
                            lambda m, out: m.main(80, out)),
    "finetune_pascal_detection": ("examples/finetune_pascal_detection/make_windows.py",
                                  lambda m, out: m.make_window_file(out, n_images=3, seed=2)),
}
PORT = {"mnist": t_mnist, "cifar10": t_cifar10, "imagenet": t_imagenet, "siamese": t_siamese,
        "hdf5_classification": t_hdf5, "finetune_pascal_detection": t_pascal}


@pytest.mark.parametrize("name", list(MAKERS))
def test_maker_writes_the_jax_bytes(name, tmp_path):
    rel, make = MAKERS[name]
    out = tmp_path / "out"
    with contextlib.redirect_stdout(pyio.StringIO()):
        make(_load(f"j_{name}_maker", rel), str(out))
        want = _files(out)
        shutil.rmtree(out)
        make(PORT[name], str(out))
    got = _files(out)
    assert len(want) >= 1 and got == want


def test_glyph_renderers_match_jax():
    j_mnist = _load("j_mnist_maker", "examples/mnist/make_dataset.py")
    j_cifar = _load("j_cifar10_maker", "examples/cifar10/make_dataset.py")
    j_imagenet = _load("j_imagenet_maker", "examples/imagenet/make_dataset.py")
    for cls in range(10):
        a, b = np.random.RandomState(cls), np.random.RandomState(cls)
        np.testing.assert_array_equal(t_mnist.render_digit(cls, a), j_mnist.render_digit(cls, b))
        np.testing.assert_array_equal(t_cifar10.render(cls, a), j_cifar.render(cls, b))
        if cls < 8:
            np.testing.assert_array_equal(t_imagenet.render_image(cls, a, size=32),
                                          j_imagenet.render_image(cls, b, size=32))


def test_makers_run_as_modules_to_the_prototxts_paths(tmp_path):
    """`python -m ...mnist.make_dataset N` writes examples/mnist/train_lmdb
    under the working directory, the source lenet_train.prototxt names, as
    the JAX maker does; the cifar10 maker takes an explicit output."""
    (tmp_path / "examples" / "mnist").mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for argv in (["deepcut_tpu_torch.examples.mnist.make_dataset", "40"],
                 ["deepcut_tpu_torch.examples.cifar10.make_dataset", "20", "db"]):
        proc = subprocess.run([sys.executable, "-m", *argv], cwd=str(tmp_path), env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
    assert (tmp_path / "examples/mnist/train_lmdb/data.mdb").is_file()
    assert (tmp_path / "db/CURRENT").is_file()


def test_cli_train_on_the_lenet_recipe_from_the_port_maker(tmp_path, monkeypatch):
    """The recipe's own prototxts, their paths as written (relative to the
    repository's root), over the port maker's LMDB: the solver is cut to
    30 iterations, its snapshots go to the working directory."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "examples" / "mnist").mkdir(parents=True)
    shutil.copy(REPO / "examples/mnist/lenet_train.prototxt", "examples/mnist/")
    solver = (REPO / "examples/mnist/lenet_solver.prototxt").read_text()
    for key, value in (("max_iter: 1000", "max_iter: 30"), ("display: 100", "display: 10"),
                       ("snapshot: 1000", "snapshot: 0")):
        assert key in solver
        solver = solver.replace(key, value)
    Path("examples/mnist/lenet_solver.prototxt").write_text(solver)
    with contextlib.redirect_stdout(pyio.StringIO()):
        t_mnist.make_lmdb("examples/mnist/train_lmdb", 200)
    buf = pyio.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        assert t_cli.main(["train", "-solver", "examples/mnist/lenet_solver.prototxt",
                           "-device", "cpu"]) == 0
    losses = [float(line.split("loss = ")[1].split(",")[0]) for line in buf.getvalue().splitlines()
              if line.startswith("Iteration ") and "loss = " in line]
    assert len(losses) >= 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_hdf5_maker_names_h5py_when_it_is_missing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    out = tmp_path / "hdf5"
    with pytest.raises(ImportError, match="h5py"):
        t_hdf5.main(40, str(out))
    assert not out.exists()
