"""Image classification with the port's Classifier: the counterpart of
`examples/classification.py` (the reference's 00-classification.ipynb /
cpp_classification).

Given a deploy prototxt + .caffemodel (+ an optional mean .binaryproto /
.npy), classify images with the notebook's preprocessing: resize to the
net's input, center-crop or 10-crop oversampling, raw_scale 255, BGR
channel swap, mean subtraction; on the card unless ``--device cpu``.

Usage (from the repository's root):
  python -m deepcut_tpu_torch.examples.classification deploy.prototxt \
      weights.caffemodel image.jpg [--mean mean.binaryproto] \
      [--labels synset_words.txt] [--no-oversample] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="deepcut_tpu_torch.examples.classification")
    ap.add_argument("model_def")
    ap.add_argument("weights")
    ap.add_argument("images", nargs="+")
    ap.add_argument("--mean", default=None, help=".binaryproto or .npy mean file")
    ap.add_argument("--labels", default=None, help="text file, one class name per line")
    ap.add_argument("--no-oversample", action="store_true",
                    help="center crop only (oversampling averages 10 crops)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from deepcut_tpu_torch import io as dio
    from deepcut_tpu_torch.classifier import Classifier
    from deepcut_tpu_torch.examples import read_labels, read_mean

    mean = read_mean(args.mean) if args.mean else None
    clf = Classifier(args.model_def, args.weights, mean=mean, raw_scale=255.0,
                     channel_swap=(2, 1, 0), device=args.device)
    labels = read_labels(args.labels) if args.labels else None

    images = [dio.load_image(p) for p in args.images]
    probs = clf.predict(images, oversample=not args.no_oversample)
    for path, p in zip(args.images, probs):
        top5 = np.argsort(p)[::-1][:5]
        print(path)
        for i in top5:
            name = labels[i] if labels and i < len(labels) else f"class {i}"
            print(f"  {p[i]:.4f}  {name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
