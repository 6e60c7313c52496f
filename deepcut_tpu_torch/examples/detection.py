"""Windowed detection with the port's Detector: the counterpart of
`examples/detection.py` (the reference's detection.ipynb /
python/caffe/detector.py): crop candidate windows (with R-CNN context
padding), warp each to the net input, classify the batch on the card
unless ``--device cpu``, report per-window class scores.

Region proposals come from a file, one image per block:

    /path/to/image.jpg
    ymin xmin ymax xmax
    ymin xmin ymax xmax
    ...

Usage (from the repository's root):
  python -m deepcut_tpu_torch.examples.detection deploy.prototxt \
      weights.caffemodel windows.txt [--mean mean.binaryproto] \
      [--context-pad 16] [--out det.npz] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np


def read_windows_file(path):
    """-> list of (image_path, (N,4) int array) blocks."""
    blocks, cur_img, cur = [], None, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) == 4 and all(p.lstrip("-").isdigit() for p in parts):
                cur.append([int(p) for p in parts])
            else:
                if cur_img is not None:
                    blocks.append((cur_img, np.asarray(cur, int)))
                cur_img, cur = line, []
    if cur_img is not None:
        blocks.append((cur_img, np.asarray(cur, int)))
    return blocks


def main(argv=None):
    ap = argparse.ArgumentParser(prog="deepcut_tpu_torch.examples.detection")
    ap.add_argument("model_def")
    ap.add_argument("weights")
    ap.add_argument("windows_file")
    ap.add_argument("--mean", default=None, help=".binaryproto or .npy mean file")
    ap.add_argument("--context-pad", type=int, default=16,
                    help="R-CNN context padding in warped pixels")
    ap.add_argument("--out", default=None, help="save detections as .npz")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from deepcut_tpu_torch.detector import Detector
    from deepcut_tpu_torch.examples import read_mean

    mean = read_mean(args.mean) if args.mean else None
    det = Detector(args.model_def, args.weights, mean=mean, raw_scale=255.0,
                   channel_swap=(2, 1, 0), context_pad=args.context_pad, device=args.device)
    detections = det.detect_windows(read_windows_file(args.windows_file))

    for d in detections:
        top = int(np.argmax(d["prediction"]))
        y0, x0, y1, x1 = d["window"]
        print(f"{d['filename']} [{y0},{x0},{y1},{x1}] -> class {top} "
              f"({d['prediction'][top]:.4f})")
    if args.out:
        np.savez(args.out,
                 windows=np.stack([d["window"] for d in detections]),
                 predictions=np.stack([d["prediction"] for d in detections]),
                 filenames=np.array([d["filename"] for d in detections]))
        print(f"saved {len(detections)} detections to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
