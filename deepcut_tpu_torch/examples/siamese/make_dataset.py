"""Create a paired-digit LevelDB for the siamese example, on the port: the
counterpart of `examples/siamese/make_dataset.py`, writing the same bytes
at the same seed and count.

Reference analog: examples/siamese/convert_mnist_siamese_data.cpp: each
record is ONE datum with two stacked single-channel images (channels=2) and
label 1 when both digits are the same class, 0 otherwise. Uses the synthetic
glyph renderer of the mnist example (no network egress for real MNIST).

Usage (from the repository's root; the default output is the path
examples/siamese/mnist_siamese_train_test.prototxt names):
  python -m deepcut_tpu_torch.examples.siamese.make_dataset [n_pairs] [out_db]
"""

from __future__ import annotations

import sys

import numpy as np

from deepcut_tpu_torch.examples.mnist.make_dataset import render_digit


def make_pair_db(out_db: str, n_pairs: int = 600, seed: int = 0) -> None:
    from deepcut_tpu_torch.data.datum import Datum
    from deepcut_tpu_torch.data.leveldb_store import LevelDBWriter

    rng = np.random.RandomState(seed)
    with LevelDBWriter(out_db) as w:
        for i in range(n_pairs):
            c1 = rng.randint(0, 10)
            same = i % 2 == 0  # balanced positives/negatives
            c2 = c1 if same else (c1 + rng.randint(1, 10)) % 10
            pair = np.stack([render_digit(c1, rng), render_digit(c2, rng)])  # (2, 28, 28)
            # uint8 times 255 wraps modulo 256, as in the JAX package's maker:
            # the stores stay byte-equal
            pair = (pair * 255).astype(np.uint8)
            w.put(f"{i:08d}".encode(), Datum.from_array(pair, int(same)).encode())
    print(f"wrote {n_pairs} pairs to {out_db}")


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 600
    out = sys.argv[2] if len(sys.argv) > 2 else "examples/siamese/siamese_train_leveldb"
    make_pair_db(out, n)
