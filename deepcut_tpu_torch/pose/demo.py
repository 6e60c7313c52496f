"""Pose demo CLI on the PyTorch port (reference: python/pose/pose_demo.py).

    python -m deepcut_tpu_torch.pose.demo IMAGE_OR_DIR \
        [--model-def D.prototxt] [--model-bin W.caffemodel] \
        [--scales 0.8,1.0,1.2] [--out_name OUT] [--visualize/--no-visualize] \
        [--folder_image_suffix .png] [--average-scales] [--device cuda] [--int8]

Saves `<image>_pose.npz` (key 'pose', the 5x14 array) and a circle-overlay
visualisation, like the reference CLI and `deepcut_tpu.pose.demo`. With
--int8 a private estimator is quantized, calibrated on the first image.
"""

from __future__ import annotations

import argparse
import copy
import glob
import os
import sys
from typing import List, Optional

import numpy as np

# reference colour table (pose_demo.py:126-128)
COLORS = [[255, 0, 0], [0, 255, 0], [0, 0, 255], [0, 245, 255], [255, 131, 250],
          [255, 255, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255], [0, 245, 255],
          [255, 131, 250], [255, 255, 0], [0, 0, 0], [255, 255, 255]]


def npcircle(image: np.ndarray, cx: float, cy: float, radius: int, color,
             transparency: float = 0.0) -> None:
    """Draw a circle in-place (reference pose_demo.py:29-38)."""
    radius, cx, cy = int(radius), int(cx), int(cy)
    y, x = np.ogrid[-radius:radius, -radius:radius]
    index = x ** 2 + y ** 2 <= radius ** 2
    sl = image[cy - radius:cy + radius, cx - radius:cx + radius]
    if sl.shape[:2] != index.shape:
        return  # circle clipped at border; reference would error out
    sl[index] = (sl[index].astype(np.float32) * transparency +
                 np.asarray(color, np.float32) * (1.0 - transparency)).astype(np.uint8)


def predict_pose_from(image_name: str, model_def: str = "", model_bin: str = "",
                      out_name: Optional[str] = None, scales=(1.0,),
                      visualize: bool = True, folder_image_suffix: str = ".png",
                      average_scales: bool = False, device: str = "cuda",
                      int8: bool = False) -> int:
    from PIL import Image
    from deepcut_tpu_torch.pose.estimate import get_estimator

    if os.path.isdir(image_name):
        images = sorted(glob.glob(os.path.join(image_name, "*" + folder_image_suffix)))
        process_folder = True
    else:
        images = [image_name]
        process_folder = False
    if process_folder and out_name and not os.path.exists(out_name):
        os.mkdir(out_name)
    est = get_estimator(model_def, model_bin, device)
    if int8:
        # a PRIVATE estimator: quantizing the module-global cached one would
        # switch every later caller of get_estimator on this model to int8.
        # quantize_int8 replaces the copy's model and leaves the shared one be.
        est = copy.copy(est)
    for image_path in images:
        if out_name is None:
            out = image_path + "_pose.npz"
        elif process_folder:
            out = os.path.join(out_name, os.path.basename(image_path) + "_pose.npz")
        else:
            out = out_name
        with Image.open(image_path) as im:
            rgb = np.asarray(im.convert("RGB"))
        image = rgb[:, :, ::-1]  # BGR (pose_demo.py:121)
        if int8 and not est.is_int8:
            est.quantize_int8(image, scale=scales[0])  # calibrates on the first image
        pose = (est.estimate_pose_avg(image, scales) if average_scales
                else est.estimate_pose(image, list(scales)))
        if pose is None:  # no scale cleared the min-confidence bar
            print(f"{image_path}: no pose found at the requested scales")
            continue
        np.savez_compressed(out, pose=pose)
        print(f"{image_path}: saved {out}")
        if visualize:
            visim = rgb.copy()
            for p_idx in range(pose.shape[1]):
                npcircle(visim, pose[0, p_idx], pose[1, p_idx], 8,
                         COLORS[p_idx % len(COLORS)], 0.0)
            Image.fromarray(visim).save(out + "_vis.png")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="deepcut_tpu_torch.pose.demo", description=__doc__)
    p.add_argument("image_name")
    p.add_argument("--model-def", default="")
    p.add_argument("--model-bin", default="")
    p.add_argument("--out_name", default=None)
    p.add_argument("--scales", default="1.")
    p.add_argument("--visualize", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--folder_image_suffix", default=".png")
    p.add_argument("--average-scales", action="store_true",
                   help="average scoremaps across scales instead of best-of")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--int8", action="store_true",
                   help="int8 serving (calibrates on the first image)")
    args = p.parse_args(argv)
    scales = [float(v) for v in args.scales.split(",")]
    return predict_pose_from(args.image_name, args.model_def, args.model_bin,
                             args.out_name, scales, args.visualize,
                             args.folder_image_suffix, args.average_scales,
                             args.device, args.int8)


if __name__ == "__main__":
    sys.exit(main())
