"""The examples' front ends on the port: one module for each script under
the repository's `examples/` (the JAX package's), at the same relative
path, plus the notebooks as the same walkthroughs on the port.

Each script runs from the repository's root as
``python -m deepcut_tpu_torch.examples.<path>`` and computes on the card
unless ``--device cpu`` is given. They read the shared data where it
stays (the prototxts and readmes under `examples/`), and the dataset
makers write by default to the paths those prototxts name, the bytes the
JAX package's makers write.
"""

from __future__ import annotations

import numpy as np


def read_mean(path: str) -> np.ndarray:
    """A mean file (.binaryproto, or .npy of (C, H, W)) -> its per-channel mean."""
    if path.endswith(".npy"):
        return np.load(path).mean(axis=(1, 2))
    from deepcut_tpu_torch import io as dio

    with open(path, "rb") as f:
        return dio.blobproto_bytes_to_array(f.read())[0].mean(axis=(1, 2))


def read_labels(path: str) -> list:
    """One class name per non-empty line."""
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]
