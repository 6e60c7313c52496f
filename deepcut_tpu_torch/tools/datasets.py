"""Dataset tools: convert_imageset / compute_image_mean / resize_and_crop
analogs.

Reference: tools/convert_imageset.cpp (images + label list -> LMDB of Datums),
tools/compute_image_mean.cpp (LMDB -> mean BlobProto), and
tools/extra/resize_and_crop_images.py + launch_resize_and_crop_images.sh
(mincepie map-reduce that squares up an image tree for ImageNet prep).

Usage:
  python -m deepcut_tpu_torch.tools.datasets convert_imageset LISTFILE DB_PATH
         [--root ROOT] [--resize H W] [--encoded] [--shuffle]
  python -m deepcut_tpu_torch.tools.datasets compute_image_mean DB_PATH OUT.binaryproto
  python -m deepcut_tpu_torch.tools.datasets resize_and_crop IN_DIR OUT_DIR
         [--side 256] [--workers N] [--listfile FILES.txt]

The port's own copy of `deepcut_tpu.tools.datasets` (jax-free; held against the
original by tests/test_torch_tools.py).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np


def convert_imageset(args) -> int:
    from deepcut_tpu_torch.data.datum import Datum
    from deepcut_tpu_torch.data.pipeline import load_image_bgr
    from PIL import Image

    # -backend flag of tools/convert_imageset.cpp: lmdb (default) | leveldb
    if getattr(args, "backend", "lmdb").lower() == "leveldb":
        from deepcut_tpu_torch.data.leveldb_store import LevelDBWriter as Writer
    else:
        from deepcut_tpu_torch.data.lmdb_store import LMDBWriter as Writer

    with open(args.listfile) as f:
        # split on the LAST whitespace (convert_imageset.cpp line parsing):
        # image paths may contain spaces
        lines = [l.strip().rsplit(None, 1) for l in f if l.strip()]
    if args.shuffle:
        np.random.RandomState(0).shuffle(lines)
    count = 0
    with Writer(args.db_path) as w:
        for path, label in lines:
            full = args.root + path
            if args.encoded and not args.resize:
                datum = Datum.from_image_file(full, int(label), encoded=True)
            else:
                img = load_image_bgr(full)
                if args.resize:
                    h, wdt = args.resize
                    img = np.asarray(Image.fromarray(img[:, :, ::-1]).resize(
                        (wdt, h), Image.BILINEAR))[:, :, ::-1]
                if args.encoded:
                    # --encoded --resize: RE-encode after resizing, like the
                    # reference (otherwise raw pixels triple the DB size)
                    import io as _io
                    buf = _io.BytesIO()
                    Image.fromarray(img[:, :, ::-1]).save(buf, format="PNG")
                    h2, w2 = img.shape[:2]
                    datum = Datum(3, h2, w2, data=buf.getvalue(),
                                  label=int(label), encoded=True)
                else:
                    datum = Datum.from_array(
                        np.ascontiguousarray(img.transpose(2, 0, 1)), int(label))
            w.put(f"{count:08d}_{path}".encode(), datum.encode())
            count += 1
    print(f"Processed {count} files into {args.db_path}")
    return 0


def compute_image_mean(args) -> int:
    import os

    from deepcut_tpu_torch.data.datum import Datum
    from deepcut_tpu_torch.io import array_to_blobproto_bytes

    # auto-detect backend the way db.cpp would be told: a LevelDB dir has a
    # CURRENT file, an LMDB dir a data.mdb.
    if os.path.exists(os.path.join(args.db_path, "CURRENT")):
        from deepcut_tpu_torch.data.leveldb_store import LevelDBReader as Reader
    else:
        from deepcut_tpu_torch.data.lmdb_store import LMDBReader as Reader
    reader = Reader(args.db_path)
    total: Optional[np.ndarray] = None
    n = 0
    for _, raw in reader.items():
        arr = Datum.decode(raw).to_array()
        total = arr if total is None else total + arr
        n += 1
    if total is None:
        print("empty db", file=sys.stderr)
        return 1
    mean = (total / n)[None]  # (1, C, H, W)
    with open(args.out, "wb") as f:
        f.write(array_to_blobproto_bytes(mean))
    print(f"Wrote mean of {n} images to {args.out}; "
          f"channel means: {mean.mean(axis=(0, 2, 3))}")
    return 0


def square_crop_geometry(height: int, width: int, side: int):
    """Scaled size + crop offsets for shortest-side-to-`side` center square.

    The geometry of tools/extra/resize_and_crop_images.py
    (OpenCVResizeCrop.resize_and_crop_image): the short edge lands exactly on
    `side`, the long edge scales by the same ratio with Python-2 FLOOR
    division (`output_side_length * height / width`), and the crop offset is
    the floored half-overhang. Returns ((new_h, new_w), (y0, x0))."""
    if height > width:
        new_h, new_w = side * height // width, side
    else:
        new_h, new_w = side, side * width // height
    return (new_h, new_w), ((new_h - side) // 2, (new_w - side) // 2)


def resize_and_crop(args) -> int:
    """Square up an image tree: every image under IN_DIR (or listed in
    --listfile) is resized so its short side equals --side, center-cropped
    square, and written under OUT_DIR at the same relative path. The
    reference distributes this over mincepie map-reduce workers; here a
    thread pool covers the same ground (PIL decode/encode releases the GIL)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    if args.listfile:
        with open(args.listfile) as f:
            rels = [ln.strip() for ln in f if ln.strip()]
    else:
        rels = []
        for dirpath, _, files in os.walk(args.in_dir):
            for fn in sorted(files):
                if fn.lower().endswith(
                        (".jpg", ".jpeg", ".png", ".bmp", ".ppm")):
                    rels.append(os.path.relpath(
                        os.path.join(dirpath, fn), args.in_dir))
        rels.sort()

    def one(rel: str) -> bool:
        src = os.path.join(args.in_dir, rel)
        dst = os.path.join(args.out_dir, rel)
        try:
            img = Image.open(src)
            img.load()
        except OSError as e:
            print(f"skipping {src}: {e}", file=sys.stderr)
            return False
        (nh, nw), (y0, x0) = square_crop_geometry(*img.size[::-1], args.side)
        img = img.resize((nw, nh), Image.BILINEAR)
        img = img.crop((x0, y0, x0 + args.side, y0 + args.side))
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        img.save(dst)
        return True

    with ThreadPoolExecutor(max_workers=max(args.workers, 1)) as pool:
        done = sum(pool.map(one, rels))
    print(f"Resized and cropped {done}/{len(rels)} images into {args.out_dir}")
    return 0 if done == len(rels) else 1


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="deepcut_tpu_torch.tools.datasets")
    sub = parser.add_subparsers(dest="verb", required=True)

    p = sub.add_parser("convert_imageset")
    p.add_argument("listfile")
    p.add_argument("db_path")
    p.add_argument("--root", default="")
    p.add_argument("--resize", type=int, nargs=2, default=None)
    p.add_argument("--encoded", action="store_true")
    p.add_argument("--shuffle", action="store_true")
    p.add_argument("--backend", default="lmdb", choices=["lmdb", "leveldb"])
    p.set_defaults(fn=convert_imageset)

    p = sub.add_parser("compute_image_mean")
    p.add_argument("db_path")
    p.add_argument("out")
    p.set_defaults(fn=compute_image_mean)

    p = sub.add_parser("resize_and_crop")
    p.add_argument("in_dir")
    p.add_argument("out_dir")
    p.add_argument("--side", type=int, default=256)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--listfile", default="",
                   help="relative paths to process (default: walk IN_DIR)")
    p.set_defaults(fn=resize_and_crop)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
