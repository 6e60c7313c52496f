"""Rotation + scale augmentation (reference: src/caffe/pose/transform_image.cpp).

The port's own copy of `deepcut_tpu.pose.augment` (jax-free; held against the original
by tests/test_torch_data.py and tests/test_torch_surface_parity.py).

The reference utility (dormant there — no callers) warps the image about the
joint bounding-box centre with smooth border extrapolation toward the mean
pixel, returning the cropped image and the composite 2x3 affine transform so
joint coordinates can be mapped. Offered here as an optional augmentation
hook for PoseDataSource.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from deepcut_tpu_torch.constants import MEAN_BGR
from deepcut_tpu_torch.data.window_file import ImageRecord, Person


def affine_about(center: Tuple[float, float], angle_deg: float, scale: float) -> np.ndarray:
    """2x3 matrix rotating by angle about center with isotropic scale
    (cv2.getRotationMatrix2D semantics)."""
    a = math.radians(angle_deg)
    alpha = scale * math.cos(a)
    beta = scale * math.sin(a)
    cx, cy = center
    return np.array([
        [alpha, beta, (1 - alpha) * cx - beta * cy],
        [-beta, alpha, beta * cx + (1 - alpha) * cy],
    ], np.float64)


def apply_affine_points(M: np.ndarray, xy: np.ndarray) -> np.ndarray:
    return xy @ M[:, :2].T + M[:, 2]


try:
    import cv2 as _cv2
except ImportError:  # pragma: no cover - cv2 is present in the image
    _cv2 = None


def warp_image(image: np.ndarray, M: np.ndarray, out_hw: Tuple[int, int],
               fill: Tuple[float, float, float] = MEAN_BGR) -> np.ndarray:
    """Inverse-mapped bilinear warp with mean-pixel fill (the reference's
    border extrapolation toward the mean, transform_image.cpp:9-107).

    Fast path is cv2.warpAffine — the same native call the reference's
    augmentation uses — which is SIMD-parallel (~3 ms per 600x800 frame vs
    ~100 ms for the scipy lowering and ~800 ms for the hand-rolled gather
    this replaces; the old paths made augmented training input-bound).
    cv2's bilinear quantizes sample coordinates to 1/32 px (its
    interpolation tables), so outputs differ from exact float bilinear by
    <~2 grey levels — immaterial for augmentation; the scipy fallback keeps
    exact float coefficients for cv2-less environments."""
    h, w = out_hw
    if _cv2 is not None:
        return _cv2.warpAffine(
            image.astype(np.float32), M[:2].astype(np.float64), (w, h),
            flags=_cv2.INTER_LINEAR, borderMode=_cv2.BORDER_CONSTANT,
            borderValue=tuple(float(v) for v in fill))
    from scipy import ndimage

    Minv = np.linalg.inv(np.vstack([M, [0, 0, 1]]))[:2]
    # affine_transform indexes (row, col) = (y, x): input = A @ output + off
    A = np.array([[Minv[1, 1], Minv[1, 0]], [Minv[0, 1], Minv[0, 0]]])
    off = np.array([Minv[1, 2], Minv[0, 2]])
    out = np.empty((h, w, image.shape[2]), np.float32)
    for c in range(image.shape[2]):
        out[:, :, c] = ndimage.affine_transform(
            image[:, :, c].astype(np.float32), A, offset=off,
            output_shape=(h, w), order=1, mode="grid-constant",
            cval=float(fill[c]))
    return out


def draw_affine(
    record: ImageRecord,
    rng: np.random.RandomState,
    *,
    max_rotation_deg: float = 15.0,
    scale_range: Tuple[float, float] = (0.85, 1.15),
) -> Tuple[Optional[np.ndarray], ImageRecord]:
    """The RNG phase of augment_record: draw (angle, scale), build the 2x3
    transform and the joint-transformed record. Image-independent, so the
    expensive warp can run on a worker thread while the RNG stream stays
    bit-identical to the serial path (data/pipeline.py workers>0)."""
    if not record.people:
        return None, record
    all_xy = np.concatenate([p.xy for p in record.people])
    center = ((all_xy[:, 0].min() + all_xy[:, 0].max()) / 2.0,
              (all_xy[:, 1].min() + all_xy[:, 1].max()) / 2.0)
    angle = rng.uniform(-max_rotation_deg, max_rotation_deg)
    scale = rng.uniform(*scale_range)
    M = affine_about(center, angle, scale)
    people = [Person(p.classes.copy(),
                     apply_affine_points(M, p.xy).astype(np.float32))
              for p in record.people]
    new_rec = ImageRecord(record.path, record.channels, record.height,
                          record.width, people, record.multi)
    return M, new_rec


def device_warp_coef(
    M: Optional[np.ndarray], scale: float, height: int, width: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sample inputs for the ON-DEVICE warp (pose/augment_device.py).

    The host augmented path composes `warp_image(image, scale*M, (nh, nw))`
    (data/pipeline.load_canvas) — a single inverse-mapped bilinear resample.
    This computes that composite's INVERSE map B (canvas (x, y) -> raw
    (u, v)) and factors it into the two-pass form the device resampler
    executes (vertical then horizontal, each a 1-D bilinear contraction):

        img1(y, x') = raw(a*y + b*x' + c,  x')     # resample rows
        out(y, x)   = img1(y,  d*x + e*y + f)      # resample columns

    which composes to out(y, x) = raw(v, u) with u = d x + e y + f and
    v = (a + b e) y + b d x + (c + b f) — i.e. exactly B for
    d = B00, e = B01, f = B02, b = B10/B00, a = B11 - b*B01, c = B12 - b*B02.
    Requires |B00| bounded away from 0 (rotations near +-90 deg would need
    the transposed factorization; augmentation draws <= +-15 deg).

    numpy-only on purpose: this runs in the (jax-free) input pipeline.
    Returns (coef (6,) f32 [a b c d e f], nhw (2,) f32 [nh nw]).
    """
    if M is None:
        M = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float64)
    P = np.vstack([scale * np.asarray(M, np.float64), [0.0, 0.0, 1.0]])
    nh, nw = int(round(height * scale)), int(round(width * scale))
    B = np.linalg.inv(P)[:2]
    if abs(B[0, 0]) < 1e-3:
        raise ValueError(
            f"device warp: inverse map has B00={B[0, 0]:.2e} (rotation too "
            "close to 90 deg for the row-major two-pass factorization)")
    d, e, f = B[0]
    b = B[1, 0] / B[0, 0]
    a = B[1, 1] - b * B[0, 1]
    c = B[1, 2] - b * B[0, 2]
    return (np.array([a, b, c, d, e, f], np.float32),
            np.array([nh, nw], np.float32))


def augment_record(
    record: ImageRecord,
    image: np.ndarray,
    rng: np.random.RandomState,
    *,
    max_rotation_deg: float = 15.0,
    scale_range: Tuple[float, float] = (0.85, 1.15),
) -> Tuple[np.ndarray, ImageRecord]:
    """Random rotation+scale about the joint-bbox centre;
    returns (warped image, record with transformed joints)."""
    M, new_rec = draw_affine(record, rng, max_rotation_deg=max_rotation_deg,
                             scale_range=scale_range)
    if M is None:
        return image, record
    warped = warp_image(image, M, image.shape[:2]).astype(np.uint8)
    return warped, new_rec
