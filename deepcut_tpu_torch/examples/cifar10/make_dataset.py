"""Create a CIFAR-10-like LevelDB (synthetic color shapes) for the
cifar10_quick example, on the port: the counterpart of
`examples/cifar10/make_dataset.py`, writing the same bytes at the same
count.

The real CIFAR download needs network access; this renders 10 distinguishable
32x32 RGB classes (colored geometric shapes with jitter/noise). The DB is
written as **LevelDB**, the backend Caffe's original CIFAR-10 recipe used
(reference examples/cifar10/*_train_test.prototxt, backend: LEVELDB), by the
port's pure-Python LevelDB writer.

Usage (from the repository's root; the default output is the path
examples/cifar10/cifar10_quick_train.prototxt names):
  python -m deepcut_tpu_torch.examples.cifar10.make_dataset [n_train] [out_dir]
"""

from __future__ import annotations

import os
import sys

import numpy as np


def render(cls: int, rng: np.random.RandomState) -> np.ndarray:
    """A 32x32x3 synthetic image for class `cls`."""
    img = rng.rand(32, 32, 3).astype(np.float32) * 0.15
    yy, xx = np.mgrid[0:32, 0:32]
    cx, cy = 16 + rng.randint(-4, 5), 16 + rng.randint(-4, 5)
    r = 9 + rng.randint(-2, 3)
    shape, hue = divmod(cls, 5)
    color = np.zeros(3, np.float32)
    color[hue % 3] = 1.0
    if hue >= 3:
        color[(hue + 1) % 3] = 0.7
    if shape == 0:  # disc
        mask = np.hypot(xx - cx, yy - cy) < r
    else:  # square
        mask = (np.abs(xx - cx) < r - 1) & (np.abs(yy - cy) < r - 1)
    img[mask] = color * (0.7 + 0.3 * rng.rand())
    return (img * 255).astype(np.uint8).transpose(2, 0, 1)  # CHW RGB


def main(n: int = 500, out_dir: str = "examples/cifar10/train_leveldb") -> None:
    from deepcut_tpu_torch.data.datum import Datum
    from deepcut_tpu_torch.data.leveldb_store import LevelDBWriter

    rng = np.random.RandomState(0)
    os.makedirs(os.path.dirname(out_dir) or ".", exist_ok=True)
    with LevelDBWriter(out_dir) as w:
        for i in range(n):
            cls = i % 10
            w.put(f"{i:08d}".encode(), Datum.from_array(render(cls, rng), cls).encode())
    print(f"wrote {n} samples to {out_dir} (LevelDB)")


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 500
    out = sys.argv[2] if len(sys.argv) > 2 else "examples/cifar10/train_leveldb"
    main(n, out)
