"""Synthetic ImageNet-style dataset for the CaffeNet recipe, on the port:
the counterpart of `examples/imagenet/make_dataset.py`, writing the same
bytes at the same count.

The reference's examples/imagenet walkthrough (create_imagenet.sh ->
make_imagenet_mean.sh -> train_caffenet.sh) starts from a directory of JPEGs
plus `path label` list files. Without network access this renders 8
distinguishable 256x256 texture/color classes as PNGs, writes train/val
list files, then runs the SAME two dataset tools the real walkthrough uses,
the port's `tools.datasets`:

  convert_imageset  (tools/convert_imageset.cpp analog)  -> LMDB of Datums
  compute_image_mean (tools/compute_image_mean.cpp analog) -> mean.binaryproto

Usage (from the repository's root; the default output is the directory
examples/imagenet/caffenet_train_val.prototxt names):
  python -m deepcut_tpu_torch.examples.imagenet.make_dataset [n_train] [out_dir]
"""

from __future__ import annotations

import os
import sys

import numpy as np


def render_image(cls: int, rng: np.random.RandomState, size: int = 256) -> np.ndarray:
    """A (size, size, 3) uint8 RGB image for class `cls`: a class-specific
    base hue + spatial pattern, with enough noise/jitter that the net has to
    learn the pattern rather than a constant."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    phase = rng.rand() * 6.28
    freq = 4 + rng.randint(0, 4)
    if cls == 0:    # horizontal stripes
        pat = np.sin(yy * freq * 6.28 + phase)
    elif cls == 1:  # vertical stripes
        pat = np.sin(xx * freq * 6.28 + phase)
    elif cls == 2:  # diagonal stripes
        pat = np.sin((xx + yy) * freq * 6.28 + phase)
    elif cls == 3:  # rings
        pat = np.sin(np.hypot(xx - 0.5, yy - 0.5) * freq * 6.28 + phase)
    elif cls == 4:  # checkerboard
        pat = np.sign(np.sin(xx * freq * 6.28 + phase) * np.sin(yy * freq * 6.28))
    elif cls == 5:  # radial fan
        pat = np.sin(np.arctan2(yy - 0.5, xx - 0.5) * freq + phase)
    elif cls == 6:  # blobs
        pat = np.sin(xx * freq * 6.28 + phase) + np.sin(yy * (freq + 2) * 6.28)
    else:           # 7: gradient
        pat = (xx - yy)
    pat = (pat - pat.min()) / (np.ptp(pat) + 1e-6)
    base = np.array([[0.9, 0.2, 0.2], [0.2, 0.9, 0.2], [0.2, 0.2, 0.9],
                     [0.9, 0.9, 0.2], [0.9, 0.2, 0.9], [0.2, 0.9, 0.9],
                     [0.7, 0.5, 0.3], [0.5, 0.5, 0.9]][cls])
    img = pat[:, :, None] * base[None, None, :]
    img = img + rng.randn(size, size, 3) * 0.08 + rng.rand(3) * 0.15
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def main(n_train: int = 400, out_dir: str = "examples/imagenet/data", n_classes: int = 8):
    from PIL import Image

    from deepcut_tpu_torch.tools import datasets

    rng = np.random.RandomState(0)
    os.makedirs(out_dir, exist_ok=True)
    for split, count in (("train", n_train), ("val", max(n_train // 4, 8))):
        img_dir = os.path.join(out_dir, split)
        os.makedirs(img_dir, exist_ok=True)
        lines = []
        for i in range(count):
            cls = i % n_classes
            name = f"{split}_{i:05d}.png"
            Image.fromarray(render_image(cls, rng)).save(os.path.join(img_dir, name))
            lines.append(f"{name} {cls}")
        listfile = os.path.join(out_dir, f"{split}.txt")
        with open(listfile, "w") as f:
            f.write("\n".join(lines) + "\n")
        # create_imagenet.sh: convert_imageset --resize 256 256 --shuffle
        datasets.main(["convert_imageset", listfile,
                       os.path.join(out_dir, f"{split}_lmdb"),
                       "--root", img_dir + os.sep,
                       "--resize", "256", "256", "--shuffle"])
    # make_imagenet_mean.sh: compute_image_mean over the train LMDB
    datasets.main(["compute_image_mean", os.path.join(out_dir, "train_lmdb"),
                   os.path.join(out_dir, "mean.binaryproto")])
    return out_dir


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 400
    out = sys.argv[2] if len(sys.argv) > 2 else "examples/imagenet/data"
    main(n, out)
