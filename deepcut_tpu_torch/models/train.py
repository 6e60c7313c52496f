"""Training objective for the DeeperCut part detector, in PyTorch.

Counterpart of `deepcut_tpu.models.train`: the fork's three losses wired as
the training prototxt wires them (SoftmaxWithLossVec with cross_entropy on
the part scoremaps, SmoothL1Loss on the location-refinement and pairwise
targets, each with its elementwise weight map from PoseDataLayer). Every
map is NCHW, as the model emits it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from deepcut_tpu_torch.models.resnet import DeeperCutConfig, forward, is_trainable
from deepcut_tpu_torch.ops import losses as loss_ops


def pose_loss(outputs: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor],
              cfg: DeeperCutConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch keys (all NCHW, stride-8 grid):
      part_score_targets (N,J,h,w), part_score_weights (N,J,h,w),
      locref_targets (N,2J,h,w), locref_weights,
      pairwise_targets (N,2J(J-1),h,w), pairwise_weights  [optional]
    """
    losses = {"part_loss": loss_ops.softmax_loss_vec(
        outputs["fc_pose"], batch["part_score_targets"], batch.get("part_score_weights"),
        cross_entropy=True)}
    total = losses["part_loss"]
    if cfg.location_refinement and "locref_targets" in batch:
        losses["locref_loss"] = loss_ops.smooth_l1_loss(
            outputs["loc_pred"], batch["locref_targets"], batch.get("locref_weights"))
        total = total + losses["locref_loss"]
    if cfg.pairwise and "pairwise_targets" in batch:
        losses["pairwise_loss"] = loss_ops.smooth_l1_loss(
            outputs["next_pred"], batch["pairwise_targets"], batch.get("pairwise_weights"))
        total = total + losses["pairwise_loss"]
    losses["total_loss"] = total
    return total, losses


def loss_fn(params: Mapping, batch: Mapping[str, torch.Tensor], cfg: DeeperCutConfig):
    """(total, losses) of the unfolded forward over ``batch["image"]``
    (N, 3, H, W), mean-subtracted float or uint8."""
    outputs = forward(params, batch["image"], cfg, folded=False)
    return pose_loss(outputs, batch, cfg)


def bn_frozen_mults(params: Mapping) -> Dict[str, Dict[str, float]]:
    """Per-leaf lr/decay multipliers freezing the BatchNorm statistics.

    The reference pins all three BatchNorm blobs (mean/var/scale_factor) at
    lr_mult 0 (ResNet-152.prototxt:30-34): immune to both the gradient step
    and weight decay. Scale's gamma/beta keep the default multiplier 1."""
    return {name: {k: (1.0 if is_trainable(name) else 0.0) for k in entry}
            for name, entry in params.items()}
