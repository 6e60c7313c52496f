"""Evaluation harness: MPII PCKh@t for the 14-joint pose output.

The port's copy of `deepcut_tpu.pose.evaluate` (jax-free), held equal to it
by tests/test_torch_data.py. PCKh: a predicted joint is correct when within
``t * head_size`` of ground truth (head_size = 0.6 * diagonal of the
annotated head box, per MPII convention). The reference repo ships no
evaluation code (its README points at the paper).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class PCKhResult:
    per_joint: np.ndarray      # (J,) accuracy in [0,1]
    mean: float
    counts: np.ndarray         # (J,) number of evaluated joints


def pckh(
    pred_xy: np.ndarray,       # (N, J, 2) predicted positions
    gt_xy: np.ndarray,         # (N, J, 2) ground truth, NaN = unannotated
    head_sizes: np.ndarray,    # (N,)
    threshold: float = 0.5,
) -> PCKhResult:
    pred = np.asarray(pred_xy, np.float32)
    gt = np.asarray(gt_xy, np.float32)
    hs = np.asarray(head_sizes, np.float32)[:, None]
    dist = np.linalg.norm(pred - gt, axis=-1)        # (N, J)
    valid = np.isfinite(gt).all(axis=-1)
    hit = (dist <= threshold * hs) & valid
    counts = valid.sum(axis=0)
    per_joint = np.where(counts > 0, hit.sum(axis=0) / np.maximum(counts, 1), np.nan)
    mean = float(hit.sum() / max(valid.sum(), 1))
    return PCKhResult(per_joint, mean, counts)


def head_size_from_box(x1, y1, x2, y2, sc_bias: float = 0.6) -> float:
    """MPII convention: 0.6 * diagonal of the head rectangle."""
    return sc_bias * float(np.hypot(x2 - x1, y2 - y1))


MPII_JOINT_NAMES = [
    "r_ankle", "r_knee", "r_hip", "l_hip", "l_knee", "l_ankle",
    "r_wrist", "r_elbow", "r_shoulder", "l_shoulder", "l_elbow", "l_wrist",
    "chin", "top_head",
]


def evaluate_estimator(
    estimator,
    samples: Sequence[Dict],
    *,
    scales: Optional[Sequence[float]] = None,
    threshold: float = 0.5,
) -> PCKhResult:
    """Run a PoseEstimator (the port's, or anything with its
    `estimate_pose`) over samples and score PCKh.

    Each sample: {"image": HxWx3 BGR uint8, "gt_xy": (J,2) with NaNs,
    "head_size": float}.
    """
    preds, gts, heads = [], [], []
    for s in samples:
        pose = estimator.estimate_pose(s["image"], scales=scales)
        if pose is None:
            # reference semantics: no scale cleared the min-confidence bar
            # (estimate_pose returns None) — score as all joints missed
            preds.append(np.full_like(np.asarray(s["gt_xy"], np.float32),
                                      np.inf))
        else:
            preds.append(pose[:2].T)      # (J, 2)
        gts.append(s["gt_xy"])
        heads.append(s["head_size"])
    return pckh(np.stack(preds), np.stack(gts), np.asarray(heads), threshold)


def format_report(result: PCKhResult, threshold: float = 0.5) -> str:
    lines = [f"PCKh@{threshold}"]
    for name, acc, n in zip(MPII_JOINT_NAMES, result.per_joint, result.counts):
        lines.append(f"  {name:12s} {100 * acc:6.2f}  (n={int(n)})")
    lines.append(f"  {'MEAN':12s} {100 * result.mean:6.2f}")
    return "\n".join(lines)
