"""Create an MNIST-like LMDB (synthetic digits) for the LeNet example, on
the port: the counterpart of `examples/mnist/make_dataset.py`, writing the
same bytes at the same seed and count.

The real MNIST download needs network access; this renders 10 distinguishable
synthetic glyph classes at 28x28 with noise/jitter, so the full
`caffe train` workflow (LMDB -> Data layer -> LeNet -> SGD) runs end-to-end
and reaches high accuracy.

Usage (from the repository's root; the default output is the path
examples/mnist/lenet_train.prototxt names):
  python -m deepcut_tpu_torch.examples.mnist.make_dataset [n_train] [out_dir]
"""

from __future__ import annotations

import sys

import numpy as np


def render_digit(cls: int, rng: np.random.RandomState) -> np.ndarray:
    """A 28x28 synthetic glyph for class `cls` with random jitter."""
    img = np.zeros((28, 28), np.float32)
    yy, xx = np.mgrid[0:28, 0:28]
    cx = 14 + rng.randint(-3, 4)
    cy = 14 + rng.randint(-3, 4)
    r = 8 + rng.randint(-1, 2)
    if cls == 0:  # ring
        d = np.hypot(xx - cx, yy - cy)
        img[(d > r - 2.5) & (d < r + 1.5)] = 1
    elif cls == 1:  # vertical bar
        img[4:24, cx - 2:cx + 2] = 1
    elif cls == 2:  # top arc + diagonal + base
        d = np.hypot(xx - cx, yy - (cy - 4))
        img[(d > r - 2.5) & (d < r + 0.5) & (yy < cy)] = 1
        img[np.abs((xx - cx) + (yy - cy)) < 2] = 1
        img[22:25, 6:22] = 1
    elif cls == 3:  # two right arcs
        d1 = np.hypot(xx - cx, yy - (cy - 5))
        d2 = np.hypot(xx - cx, yy - (cy + 5))
        img[(np.abs(d1 - 5) < 1.8) & (xx > cx - 2)] = 1
        img[(np.abs(d2 - 5) < 1.8) & (xx > cx - 2)] = 1
    elif cls == 4:  # two bars + crossbar
        img[4:18, cx - 7:cx - 4] = 1
        img[4:24, cx + 3:cx + 6] = 1
        img[14:17, cx - 8:cx + 7] = 1
    elif cls == 5:  # S-ish blocks
        img[4:8, 6:22] = 1
        img[8:15, 6:10] = 1
        img[13:17, 6:22] = 1
        img[17:23, 18:22] = 1
        img[21:25, 6:22] = 1
    elif cls == 6:  # lower ring + stem
        d = np.hypot(xx - cx, yy - (cy + 4))
        img[(d > 4) & (d < 7)] = 1
        img[(yy < cy + 2) & (np.abs(xx - (cx - 4)) < 2) & (yy > 4)] = 1
    elif cls == 7:  # top bar + diagonal
        img[4:8, 6:22] = 1
        img[np.abs((xx - 20) + (yy - 6) * 0.7) < 2] = 1
    elif cls == 8:  # two rings
        d1 = np.hypot(xx - cx, yy - (cy - 5))
        d2 = np.hypot(xx - cx, yy - (cy + 5))
        img[np.abs(d1 - 4.5) < 1.8] = 1
        img[np.abs(d2 - 5) < 1.8] = 1
    else:  # 9: upper ring + tail
        d = np.hypot(xx - cx, yy - (cy - 4))
        img[(d > 4) & (d < 7)] = 1
        img[(yy > cy - 4) & (np.abs(xx - (cx + 4)) < 2) & (yy < 24)] = 1
    img += 0.15 * rng.rand(28, 28)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def make_lmdb(path: str, n: int, seed: int = 0) -> None:
    from deepcut_tpu_torch.data.datum import Datum
    from deepcut_tpu_torch.data.lmdb_store import LMDBWriter

    rng = np.random.RandomState(seed)
    with LMDBWriter(path) as w:
        for i in range(n):
            cls = i % 10
            img = render_digit(cls, rng)[None]  # (1, 28, 28)
            w.put(f"{i:08d}".encode(), Datum.from_array(img, cls).encode())
    print(f"wrote {n} samples to {path}")


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    out = sys.argv[2] if len(sys.argv) > 2 else "examples/mnist/train_lmdb"
    make_lmdb(out, n)
