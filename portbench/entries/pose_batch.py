"""Drives `PoseEstimator.estimate_pose_batch` of deepcut_tpu_torch.

One call serves ``batch`` frames of the mix's pool at the mix's scale and
returns their (batch, 5, J) poses. `compare` judges every pose served
against the reference's maps of the same frame, at the cell the program
chose, in logits (the sigmoid's input), where the sigmoid's saturation
does not shrink an error:

- ``cell_logit_gap``: how far the reference's logit there lies below the
  reference's best over the valid cells (a near-tie may pick either cell;
  a wrong pick cannot hide);
- ``conf_logit_err``: the logit of the program's confidence against the
  reference's logit there, both held within the logits an f32 confidence
  can tell from 0 and 1 (``LOGIT_MAX``);
- ``px_err``: the program's offsets and position against those the
  reference's locref map gives there, in pixels.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

LOGIT_MAX = float(np.log(2.0**24 - 1))   # the logit of 1 - 2**-24, f32's last step below 1


def _port_config(cfg: dict):
    from deepcut_tpu_torch.models.resnet import DeeperCutConfig

    return DeeperCutConfig(
        depths=tuple(cfg["depths"]), stage_widths=tuple(cfg["stage_widths"]),
        stage_strides=tuple(cfg["stage_strides"]), stage_dilations=tuple(cfg["stage_dilations"]),
        num_joints=cfg["num_joints"], location_refinement=cfg["location_refinement"],
        pairwise=cfg["pairwise"], naming=cfg["block_naming"], bn_eps=cfg["bn_eps"],
        compute_dtype=getattr(torch, cfg["compute_dtype"]))


class System:
    """The estimator under test and the traffic it serves."""

    def __init__(self, cfg: dict, mix: dict, weights, traffic, device, control: str = "",
                 config_dir=None):
        from deepcut_tpu_torch.pose.estimate import PoseEstimator

        self.traffic, self.scale = traffic, float(mix["scale"])
        self.est = PoseEstimator(weights, _port_config(cfg), bucket_step=int(mix["bucket_step"]),
                                 device=device)
        if control == "int8":
            self.est.quantize_int8(traffic.pool[0], self.scale)
        elif control:
            raise ValueError(f"pose_batch: no program control {control!r}")

    def call(self, i: int):
        """Call i: (items served, its record)."""
        idx = self.traffic.items(i)
        poses = self.est.estimate_pose_batch([self.traffic.pool[k] for k in idx], self.scale)
        return len(idx), (idx, poses)

    def counters(self) -> Dict[str, int]:
        """The program's launch counts: its conv epilogue's and its int8
        kernels'."""
        from deepcut_tpu_torch.ops import conv_epilogue, int8_conv

        return {"conv_epilogue": conv_epilogue.launches,
                "int8_im2col": int8_conv.im2col_launches,
                "int8_epilogue": int8_conv.epilogue_launches,
                "int8_quantize": int8_conv.quantize_launches}

    def quantized(self) -> bool:
        """Whether the program serves its int8 model."""
        return bool(self.est.is_int8)

    def close(self) -> None:
        del self.est


def served(records: List) -> Dict[str, np.ndarray]:
    """The records as one array of poses and their pool items."""
    idx = np.concatenate([r[0] for r in records])
    return {"items": idx, "pose": np.concatenate([r[1] for r in records]).astype(np.float64)}


def from_reference(ref: Dict[str, np.ndarray], items: np.ndarray) -> Dict[str, np.ndarray]:
    """The reference's own poses of `items`, in `served`'s form."""
    return {"items": items, "pose": ref["pose"][items].astype(np.float64)}


def compare(cfg: dict, mix: dict, out: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]
            ) -> Dict[str, float]:
    """The three numbers over every pose served (module docstring). Each
    pose reads the reference's maps at its own cell only, so the cost
    grows with the poses served, not with the maps."""
    scale, stride, mul = float(mix["scale"]), cfg["stride"], cfg["locref_stdev"]
    items, pose = out["items"], out["pose"]
    fail = {"cell_logit_gap": float("inf"), "conf_logit_err": float("inf"), "px_err": float("inf")}
    if len(items) == 0:
        return fail
    logit, loc = ref["logit"], ref["loc"]
    _, j, gh, gw = logit.shape
    x, y, conf, off_y, off_x = (pose[:, r] * (scale if r != 2 else 1.0) for r in range(5))
    col = np.rint((x - off_x - stride / 2) / stride)
    row = np.rint((y - off_y - stride / 2) / stride)
    inside = np.isfinite(col) & np.isfinite(row) & (col >= 0) & (col < gw) & (row >= 0) & (row < gh)
    if not inside.all():
        return fail
    row, col = row.astype(np.int64), col.astype(np.int64)
    ni, ji = items[:, None], np.arange(j)[None, :]
    at = logit[ni, ji, row, col].astype(np.float64)
    best = logit.reshape(len(logit), j, -1).max(axis=2).astype(np.float64)[ni, ji]
    c = np.clip(conf, 1.0 / (1.0 + np.exp(LOGIT_MAX)), 1.0 / (1.0 + np.exp(-LOGIT_MAX)))
    conf_logit = np.log(c) - np.log1p(-c)
    ref_x = loc[ni, 2 * ji, row, col].astype(np.float64) * mul
    ref_y = loc[ni, 2 * ji + 1, row, col].astype(np.float64) * mul
    px = np.stack([np.abs(off_x - ref_x), np.abs(off_y - ref_y),
                   np.abs(x - (col * stride + stride / 2 + ref_x)),
                   np.abs(y - (row * stride + stride / 2 + ref_y))])
    return {"cell_logit_gap": float(np.max(best - at)),
            "conf_logit_err": float(np.max(np.abs(conf_logit - np.clip(at, -LOGIT_MAX, LOGIT_MAX)))),
            "px_err": float(np.max(px))}
