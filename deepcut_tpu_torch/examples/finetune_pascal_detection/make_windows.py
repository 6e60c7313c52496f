"""Generate a synthetic R-CNN window-file fixture for the PASCAL finetune
recipe, on the port: the counterpart of
`examples/finetune_pascal_detection/make_windows.py`, writing the same
files at the same seed and count (the real window files ship with R-CNN's
selective-search output and PASCAL VOC images, both behind network egress).

Window-file format (window_data_layer.cpp LayerSetUp):

    # <image_index>
    <image_path>
    <channels> <height> <width>
    <num_windows>
    <class_index> <overlap> <x1> <y1> <x2> <y2>
    ...

Usage (from the repository's root):
  python -m deepcut_tpu_torch.examples.finetune_pascal_detection.make_windows [out_dir] [n_images]
"""

from __future__ import annotations

import os
import sys

import numpy as np


def make_window_file(out_dir: str, n_images: int = 8, seed: int = 0,
                     mean_file: bool = True) -> str:
    from PIL import Image

    rng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    lines = []
    for i in range(n_images):
        h, w = rng.randint(240, 320), rng.randint(280, 400)
        img = rng.randint(0, 255, (h, w, 3), np.uint8)
        path = os.path.join(out_dir, f"img_{i:03d}.png")
        Image.fromarray(img).save(path)
        windows = []
        for _ in range(rng.randint(3, 7)):  # fg proposals
            x1, y1 = rng.randint(0, w - 80), rng.randint(0, h - 80)
            bw, bh = rng.randint(60, 80), rng.randint(60, 80)
            cls = rng.randint(1, 21)
            windows.append((cls, 0.8, x1, y1, min(x1 + bw, w - 1), min(y1 + bh, h - 1)))
        for _ in range(rng.randint(6, 12)):  # bg proposals
            x1, y1 = rng.randint(0, w - 50), rng.randint(0, h - 50)
            windows.append((0, 0.1, x1, y1, x1 + 49, y1 + 49))
        lines.append(f"# {i}\n{path}\n3 {h} {w}\n{len(windows)}\n" + "".join(
            f"{c} {ov} {a} {b} {cc} {d}\n" for c, ov, a, b, cc, d in windows))
    wf = os.path.join(out_dir, "window_file_trainval.txt")
    with open(wf, "w") as f:
        f.write("".join(lines))
    if mean_file:
        from deepcut_tpu_torch.io import array_to_blobproto_bytes

        mean = np.full((3, 256, 256), 120.0, np.float32)
        with open(os.path.join(out_dir, "imagenet_mean.binaryproto"), "wb") as f:
            f.write(array_to_blobproto_bytes(mean[None]))
    print(f"wrote {wf} ({n_images} images)")
    return wf


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "examples/finetune_pascal_detection/fixture"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    make_window_file(out, n)
