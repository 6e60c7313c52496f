"""Auxiliary supervision targets: person-RPN and "sticks" part segmentation.

The port's own copy of `deepcut_tpu.pose.aux_targets` (jax-free; held against the original
by tests/test_torch_data.py).

Reimplements the fork's builders with identical semantics:
- RPN (src/caffe/pose/rpn_targets.cpp:38-221): 5 anchors
  {(ratio, short_side)} = {(1,130),(1,211),(2,153),(3,125),(4,97)}; cells
  within `rpn_distance_threshold` of the person's polygon center-of-mass get
  the best-IoU anchor positive plus (tx, ty, log tw, log th) regression to
  the joint bounding box; 25% positive-fraction negative sampling. Single
  person (all_people[0]) like the reference.
- Sticks segmentation (src/caffe/pose/segment_parts.cpp:142-318): 9 limb
  segments rasterized as width-17*coef oriented rectangles + end-cap discs
  (no caps on the head stick), torso as the convex hull of extended
  shoulder/hip points (class 10); per-class 25% negative sampling and
  cross-class negation.

Pure numpy; geometry helpers (polygon centroid via contour moments, point-in
-polygon incl. boundary, monotone-chain convex hull) are clean-room.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from deepcut_tpu_torch.data.window_file import Person

IGNORE_VALUE = 1000.0
NUM_ANCHORS = 5
NUM_REG_TARGS = 4
NUM_SEGM_CLASSES = 10
ANCHORS = ((1, 130.0), (1, 211.0), (2, 153.0), (3, 125.0), (4, 97.0))
STRIDE = 8
HALF_STRIDE = 4


# -- geometry ----------------------------------------------------------------


def contour_centroid(points: np.ndarray) -> np.ndarray:
    """Centroid of the closed polygon through `points` in order (Green's
    formula — matches cv::moments on a point vector, rpn_targets.cpp:31-35)."""
    p = np.asarray(points, np.float64)
    q = np.roll(p, -1, axis=0)
    cross = p[:, 0] * q[:, 1] - q[:, 0] * p[:, 1]
    a = cross.sum() / 2.0
    if abs(a) < 1e-9:
        return p.mean(axis=0).astype(np.float32)  # degenerate: fall back
    cx = ((p[:, 0] + q[:, 0]) * cross).sum() / (6.0 * a)
    cy = ((p[:, 1] + q[:, 1]) * cross).sum() / (6.0 * a)
    return np.array([cx, cy], np.float32)


def rect_iou(r0: Tuple[float, float, float, float],
             r1: Tuple[float, float, float, float]) -> float:
    """IoU of (x, y, w, h) rects; -1 when union < 0.01 (rpn_targets.cpp:10-29)."""
    x_ov = max(0.0, min(r0[0] + r0[2], r1[0] + r1[2]) - max(r0[0], r1[0]))
    y_ov = max(0.0, min(r0[1] + r0[3], r1[1] + r1[3]) - max(r0[1], r1[1]))
    overlap = x_ov * y_ov
    union = r0[2] * r0[3] + r1[2] * r1[3] - overlap
    if union < 0.01:
        return -1.0
    return overlap / union


def points_in_polygon(pts: np.ndarray, poly: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """Vectorized point-in-polygon (boundary counts as inside, matching
    cv::pointPolygonTest(...) >= 0). pts: (N,2); poly: (M,2) closed or open."""
    poly = np.asarray(poly, np.float64)
    if np.allclose(poly[0], poly[-1]):
        poly = poly[:-1]
    x, y = pts[:, 0:1].astype(np.float64), pts[:, 1:2].astype(np.float64)
    x0, y0 = poly[:, 0][None, :], poly[:, 1][None, :]
    x1 = np.roll(poly[:, 0], -1)[None, :]
    y1 = np.roll(poly[:, 1], -1)[None, :]
    # crossing test
    cond = (y0 <= y) != (y1 <= y)
    denom = np.where(y1 - y0 == 0, 1.0, y1 - y0)
    xin = x0 + (y - y0) * (x1 - x0) / denom
    inside = (np.sum(cond & (x < xin), axis=1) % 2) == 1
    # boundary test: distance of point to each segment
    dx, dy = x1 - x0, y1 - y0
    seg_len2 = dx * dx + dy * dy
    t = np.clip(((x - x0) * dx + (y - y0) * dy) / np.where(seg_len2 == 0, 1.0, seg_len2), 0, 1)
    px, py = x0 + t * dx, y0 + t * dy
    d2 = (x - px) ** 2 + (y - py) ** 2
    on_edge = np.any(d2 <= eps, axis=1)
    return inside | on_edge


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew monotone chain; returns hull vertices CCW."""
    pts = sorted(set(map(tuple, np.asarray(points, np.float64))))
    if len(pts) <= 2:
        return np.asarray(pts, np.float32)

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower: List = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper: List = []
    for p in reversed(pts):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.asarray(lower[:-1] + upper[:-1], np.float32)


def _cell_coords(h: int, w: int, stride: int, scale: float) -> np.ndarray:
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([gx * stride + stride // 2, gy * stride + stride // 2],
                    axis=-1).astype(np.float32) / scale


def _sample_negatives_mask(rng, sample_mask, th, tw, num_positives,
                           pos_fraction=0.25):
    """25% positive-fraction random negative cells; yields (j, i) picks."""
    max_neg = int(num_positives * (1.0 - pos_fraction) / pos_fraction)
    picks = []
    num_neg = 0
    for _ in range(max_neg * 10):
        j = int(rng.randint(0, th))
        i = int(rng.randint(0, tw))
        if sample_mask[j, i]:
            continue
        sample_mask[j, i] = True
        picks.append((j, i))
        num_neg += 1
        if num_neg == max_neg:
            break
    return picks


# -- RPN ---------------------------------------------------------------------


def rpn_targets(
    person: Person,
    sc_map_h: int, sc_map_w: int,
    truncated_h: int, truncated_w: int,
    *,
    scale: float = 1.0,
    distance_threshold: float = 17.0,
    rng: Optional[np.random.RandomState] = None,
    use_center_of_mass: bool = True,
):
    """Returns (cls (h,w,5), reg (h,w,20), reg_weights (h,w,20))."""
    if rng is None:
        rng = np.random.RandomState(0)
    cls = np.full((sc_map_h, sc_map_w, NUM_ANCHORS), IGNORE_VALUE, np.float32)
    reg = np.zeros((sc_map_h, sc_map_w, NUM_ANCHORS * NUM_REG_TARGS), np.float32)
    reg_w = np.zeros_like(reg)

    pts = person.xy.astype(np.float32)
    # cv::boundingRect on float points returns an INTEGER rect: floored
    # origin, width = floor(max) - floor(min) + 1 (rpn_targets.cpp:81) —
    # the exact-float bbox would shift every regression target by ~0.5/1 px
    bx = math.floor(float(pts[:, 0].min())); by = math.floor(float(pts[:, 1].min()))
    bw = math.floor(float(pts[:, 0].max())) - bx + 1
    bh = math.floor(float(pts[:, 1].max())) - by + 1
    target_rect = (float(bx), float(by), float(bw), float(bh))
    # centre = (tl + br)/2 with cv::Rect's EXCLUSIVE br = (x+w, y+h)
    x_s, y_s = bx + bw / 2.0, by + bh / 2.0
    w_s, h_s = float(bw), float(bh)
    c_mass = contour_centroid(pts) if use_center_of_mass else np.array([x_s, y_s])

    coords = _cell_coords(truncated_h, truncated_w, STRIDE, scale)  # (th,tw,2)
    dist = np.sqrt(np.sum((c_mass[None, None] - coords) ** 2, axis=-1))
    active = dist <= distance_threshold
    sample_mask = np.zeros((sc_map_h, sc_map_w), bool)
    num_positives = 0
    for j, i in zip(*np.nonzero(active)):
        x_a, y_a = coords[j, i]
        best_iou, best_k = -1000.0, -1
        for k, (ratio, w_a) in enumerate(ANCHORS):
            h_a = w_a * ratio
            iou = rect_iou(target_rect, (x_a - w_a / 2, y_a - h_a / 2, w_a, h_a))
            if iou > best_iou:
                best_iou, best_k = iou, k
        ratio, w_a = ANCHORS[best_k]
        h_a = w_a * ratio
        cls[j, i, best_k] = 1.0
        t = (np.float32((x_s - x_a) / w_a), np.float32((y_s - y_a) / h_a),
             np.float32(math.log(w_s / w_a)) if w_s > 0 else 0.0,
             np.float32(math.log(h_s / h_a)) if h_s > 0 else 0.0)
        base = best_k * NUM_REG_TARGS
        reg[j, i, base:base + 4] = t
        reg_w[j, i, base:base + 4] = 1.0
        sample_mask[j, i] = True
        num_positives += 1

    for j, i in _sample_negatives_mask(rng, sample_mask, truncated_h,
                                       truncated_w, num_positives):
        cls[j, i, :] = 0.0
    return cls, reg, reg_w


# -- sticks segmentation -----------------------------------------------------

STICK_PAIRS = ((1, 2), (2, 3), (6, 5), (4, 5), (7, 8), (8, 9),
               (12, 11), (11, 10), (13, 14))
STICK_COEFS = (1.0, 1.0, 1.0, 1.0, 0.8, 0.8, 0.8, 0.8, 1.0)
STICK_WIDTH = 17.0


def sticks_segmentation(
    person: Person,
    sc_map_h: int, sc_map_w: int,
    *,
    scale: float = 1.0,
    segm_stride: int = 8,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Returns (h, w, NUM_SEGM_CLASSES) labels in {1, 0, IGNORE}."""
    if rng is None:
        rng = np.random.RandomState(0)
    label = np.full((sc_map_h, sc_map_w, NUM_SEGM_CLASSES), IGNORE_VALUE, np.float32)
    joints = np.full((15, 2), -1.0, np.float32)  # 1-based classes
    for k in range(len(person.classes)):
        c = int(person.classes[k])
        if 1 <= c <= 14:
            joints[c] = person.xy[k]
    coords = _cell_coords(sc_map_h, sc_map_w, segm_stride, scale)
    flat = coords.reshape(-1, 2)

    num_sticks = NUM_SEGM_CLASSES - 1
    for k in range(num_sticks):
        a, b = STICK_PAIRS[k]
        j1, j2 = joints[a], joints[b]
        if j1[0] == -1 or j2[0] == -1:
            continue
        limb = STICK_WIDTH * STICK_COEFS[k]
        diff = j2 - j1
        norm = float(np.linalg.norm(diff))
        pos = np.zeros((sc_map_h, sc_map_w), bool)
        if norm > 1.0:
            perp = np.array([-diff[1], diff[0]]) / norm
            poly = np.stack([j1 - perp * limb, j1 + perp * limb,
                             j2 + perp * limb, j2 - perp * limb])
            pos |= points_in_polygon(flat, poly).reshape(sc_map_h, sc_map_w)
        if k != num_sticks - 1:  # end caps, not for the head stick
            d1 = np.linalg.norm(flat - j1[None], axis=1)
            d2 = np.linalg.norm(flat - j2[None], axis=1)
            pos |= ((d1 <= limb) | (d2 <= limb)).reshape(sc_map_h, sc_map_w)
        label[:, :, k] = np.where(pos, 1.0, label[:, :, k])
        mask = label[:, :, k] == 1.0
        sm = mask.copy()
        for j, i in _sample_negatives_mask(rng, sm, sc_map_h, sc_map_w,
                                           int(mask.sum())):
            label[j, i, k] = 0.0

    # cross-class negation (negate_all, segment_parts.cpp:252-254) runs
    # BEFORE the torso rasterization: a cell positive for any other class
    # forces non-positive classes (including the still-empty torso channel)
    # to 0; the torso hull then OVERWRITES its channel with 1 inside the
    # polygon, so stick channels keep their 1s across the torso region.
    any_pos = (label == 1.0)
    other_pos = any_pos.sum(axis=2, keepdims=True) - any_pos
    label = np.where((other_pos > 0) & ~any_pos, 0.0, label)

    # torso: convex hull of extended shoulder/hip segment endpoints
    j1, j2 = np.round(joints[3]), np.round(joints[4])
    j3, j4 = np.round(joints[9]), np.round(joints[10])
    if all(v[0] != -1 for v in (j1, j2, j3, j4)):
        sz = STICK_WIDTH
        pts: List[np.ndarray] = []
        if np.array_equal(j1, j2):
            j2 = j2.copy(); j2[0] = j1[0] + 1
        d12 = (j2 - j1) / np.linalg.norm(j2 - j1)
        pts += [j2 + d12 * sz, j1 - d12 * sz]
        if np.array_equal(j1, j3):
            j3 = j3.copy(); j3[1] = j1[1] - 1
        d13 = (j3 - j1) / np.linalg.norm(j3 - j1)
        pts += [j3 + d13 * sz, j1 - d13 * sz]
        if np.linalg.norm(j3 - j4) <= sz * 1.5:
            if np.array_equal(j4, j3):
                j4 = j4.copy(); j4[0] = j3[0] + 1
            d34 = (j4 - j3) / np.linalg.norm(j4 - j3)
            pts += [j4 + d34 * sz, j3 - d34 * sz]
        if np.array_equal(j2, j4):
            j4 = j4.copy(); j4[1] = j2[1] - 1
        d24 = (j4 - j2) / np.linalg.norm(j4 - j2)
        pts += [j4 + d24 * sz, j2 - d24 * sz]
        hull = convex_hull(np.stack(pts))
        torso = NUM_SEGM_CLASSES - 1
        pos = points_in_polygon(flat, hull).reshape(sc_map_h, sc_map_w)
        label[:, :, torso] = np.where(pos, 1.0, label[:, :, torso])
        mask = label[:, :, torso] == 1.0
        sm = mask.copy()
        for j, i in _sample_negatives_mask(rng, sm, sc_map_h, sc_map_w,
                                           int(mask.sum())):
            label[j, i, torso] = 0.0
    return label
