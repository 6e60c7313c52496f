"""Synthetic 2-class / 4-feature dataset for the HDF5 classification
example, on the port: the counterpart of
`examples/hdf5_classification/make_dataset.py`, writing the same files at
the same count.

The reference's `examples/hdf5_classification` (and the 02-brewing-logreg
notebook) uses sklearn.make_classification; without network access this
draws an equivalent mixture: 2 informative dimensions as a 4-cluster
XOR-style gaussian mixture (not linearly separable, the example's point:
logistic regression tops out, the 2-layer net does much better) plus 2 pure
noise dimensions.

Writes train.h5/test.h5 with datasets `data` (N,4) and `label` (N,) float32,
and the one-filename-per-line list files HDF5Data expects
(hdf5_data_layer.cpp: source is a text file of .h5 paths). Needs h5py:
without it, an ImportError naming h5py.

Usage (from the repository's root; the default output is the path
examples/hdf5_classification/*_train_val.prototxt name):
  python -m deepcut_tpu_torch.examples.hdf5_classification.make_dataset [n] [out_dir]
"""

from __future__ import annotations

import os
import sys

import numpy as np


def make_xy(n: int, rng: np.random.RandomState):
    # 4 gaussian clusters at (+-1.5, +-1.5); label = XOR of corner signs.
    corners = np.array([[1.5, 1.5], [-1.5, -1.5], [1.5, -1.5], [-1.5, 1.5]])
    labels = np.array([0, 0, 1, 1])
    which = rng.randint(0, 4, size=n)
    informative = corners[which] + rng.randn(n, 2) * 0.8
    noise = rng.randn(n, 2) * 1.0
    x = np.concatenate([informative, noise], axis=1).astype(np.float32)
    y = labels[which].astype(np.float32)
    return x, y


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("the HDF5 classification dataset needs h5py, which is not "
                          "installed") from e
    return h5py


def write_h5(path: str, x: np.ndarray, y: np.ndarray) -> None:
    with _h5py().File(path, "w") as f:
        f.create_dataset("data", data=x)
        f.create_dataset("label", data=y)


def main(n: int = 1000, out_dir: str = "examples/hdf5_classification/data") -> str:
    _h5py()   # before anything is written
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    for split, count in (("train", n), ("test", max(n // 4, 1))):
        x, y = make_xy(count, rng)
        h5 = os.path.join(out_dir, f"{split}.h5")
        write_h5(h5, x, y)
        with open(os.path.join(out_dir, f"{split}.txt"), "w") as f:
            f.write(os.path.abspath(h5) + "\n")
    print(f"wrote {n} train / {max(n // 4, 1)} test samples to {out_dir}")
    return out_dir


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    out = sys.argv[2] if len(sys.argv) > 2 else "examples/hdf5_classification/data"
    main(n, out)
